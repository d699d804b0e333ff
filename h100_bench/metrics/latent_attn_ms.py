"""Device ms a step of the latent read (kernels/paged_attention.py
paged_latent_write_attend: csrc/latent_attend.cu's latent_attend_kernel),
every layer's launch summed."""

NAME = "latent_attend_kernel"


def matches(name: str) -> bool:
    return NAME in name


def read(run):
    if run.trace is None:
        return None
    ms = run.trace.kernel_ms_per_step(matches)
    return ms if ms > 0 else None
