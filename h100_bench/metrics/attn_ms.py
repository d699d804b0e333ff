"""Device ms a step of the paged attention kernels (kernels/paged_attention.py:
csrc/write_attend.cu, csrc/decode_attend.cu)."""

NAMES = ("write_attend_kernel", "decode_attend_kernel", "float_attend_kernel")


def matches(name: str) -> bool:
    return any(n in name for n in NAMES)


def read(run):
    if run.trace is None:
        return None
    return run.trace.kernel_ms_per_step(matches)
