"""The integer bound of the kernels whose integer work may outlast their
bytes: Golay's and Hamming(7,4)'s correcting reads, the read-inject read
and the codec kernels K5-K9. The SASS instructions (``cuobjdump -sass`` of
the built libraries) of one unit of each one's work, per pipe, over the
card's issue rates.

    python -m qkv_ecc_tpu_torch.kernels.sass_count

Never-launched probe kernels sit in the sources beside the kernels they
measure, each in two forms whose only difference is one more unit of work
a thread: ``sass_probe_golay_row1`` / ``_row2`` (decode_attend.cu: one and
two bench-0.9b rows of 44 codewords through ``decode_row``, as phase D runs
it; ``sass_probe_golay_gpt2_row1`` / ``_row2`` gpt2's rows of 24),
``sass_probe_h74_unit1`` / ``_unit2`` (decode_attend.cu: one and two
bench-0.9b rows' parity through ``h74_relayout_row`` and their 16 data
words through ``h74_decode_chunk``, as the page loop runs them),
``sass_probe_flip_word1`` / ``_word2`` (write_attend.cu:
one and two words' 32 hashes, ``flip_word``) and, in codec_kernels.cu, one
and two vectors of a codec's loop (``sass_probe_<codec>1`` / ``2``: 16
Hamming values or 4 Golay words) and one and two uint8 elements of K9 (8
hashes each, ``sass_probe_inject1`` / ``2``). The difference of their
instructions, classed by the pipe that issues them, divided by the units'
codewords, data words, hashes, values or words, is the count per one of
them: the probe's fixed cost (the tables' fill, the thread's index)
cancels. Global loads and stores (the bytes bound's) are left out of every
pipe; control flow and uniform-datapath instructions count against the
issue rate alone. Rates in lanes per clock per SM, compute capability 9.0
(CUDA C++ Programming Guide, "Arithmetic Instructions" throughput table): 32-bit
integer add, logic, shift, compare, select and byte permute 64; integer
multiply-add 64; fp32 add, multiply and FMA 128; population count,
conversions and the special functions 16; shared-memory loads and stores
and shuffles 32 (one warp instruction a clock); and 4 warp instructions
issued a clock (one per scheduler). A call's integer bound is its units
(codewords or data words decoded, hashes drawn, values or words coded)
times the count on each pipe over that pipe's rate times the SMs and the
clock, the largest over the pipes: the least time the card needs for that
work alone, whatever else the kernel does.
"""

from __future__ import annotations

import collections
import re
import subprocess
from pathlib import Path

from . import _build

# (probe functions with one and two units a thread, source, codewords or
# hashes of a unit, their name)
PROBES = {
    "golay": (("sass_probe_golay_row1", "sass_probe_golay_row2"), "decode_attend", 44,
              "codeword"),
    "golay_gpt2": (("sass_probe_golay_gpt2_row1", "sass_probe_golay_gpt2_row2"),
                   "decode_attend", 24, "codeword"),
    "h74_read": (("sass_probe_h74_unit1", "sass_probe_h74_unit2"), "decode_attend", 16,
                 "data word"),
    "hash": (("sass_probe_flip_word1", "sass_probe_flip_word2"), "write_attend", 32, "hash"),
    **{key: ((f"sass_probe_{key}1", f"sass_probe_{key}2"), "codec_kernels", units, unit)
       for key, units, unit in (("h74_encode", 16, "value"), ("h74_decode", 16, "value"),
                                ("h84_encode", 16, "value"), ("h84_decode", 16, "value"),
                                ("golay_encode", 4, "word"), ("golay_decode", 4, "word"),
                                ("golay_scrub", 4, "word"), ("inject", 8, "hash"))},
}
# lanes per clock per SM of each pipe (compute capability 9.0)
RATES = {"alu": 64, "imad": 64, "fp32": 128, "xu": 16, "shared": 32, "issue": 128}
_PIPES = {
    "alu": {"IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "ISETP", "SEL", "PRMT", "LEA",
            "IMNMX", "IABS", "SGXT", "BMSK", "PLOP3", "P2R", "R2P", "MOV", "FSEL", "FSETP",
            "FMNMX", "ISCADD", "I2FP", "VIADD", "VIMNMX"},
    "imad": {"IMAD", "IMUL", "IMADSP"},
    "fp32": {"FFMA", "FADD", "FMUL"},
    "xu": {"POPC", "FLO", "BREV", "MUFU", "I2F", "F2I", "F2F", "I2I", "FRND"},
    "shared": {"LDS", "STS", "ATOMS", "LDSM", "SHFL"},
}
_GLOBAL = {"LDG", "STG", "LD", "ST", "RED", "ATOM", "ATOMG", "LDGSTS"}
_INSTR = re.compile(r"^\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)")


def cuobjdump() -> str:
    """cuobjdump beside nvcc."""
    return str(Path(_build.find_nvcc()).with_name("cuobjdump"))


def function_opcodes(library: Path, function: str) -> collections.Counter:
    """Opcode counts (modifiers dropped, NOPs left out) of ``function`` in
    the SASS of a built library."""
    sass = subprocess.run([cuobjdump(), "-sass", "-fun", function, str(library)],
                          capture_output=True, text=True, check=True).stdout
    ops = collections.Counter()
    for line in sass.splitlines():
        m = _INSTR.match(line)
        if m and m.group(1) != "NOP":
            ops[m.group(1)] += 1
    if not ops:
        raise RuntimeError(f"no SASS for {function} in {library}")
    return ops


def per_pipe(ops: collections.Counter, units: int) -> dict:
    """Instructions per unit on each pipe, "issue" (all of them) and
    "global" (left out of the bound)."""
    out = {p: sum(n for op, n in ops.items() if op in names) / units
           for p, names in _PIPES.items()}
    out["issue"] = sum(ops.values()) / units
    out["global"] = sum(n for op, n in ops.items() if op in _GLOBAL) / units
    return out


def probe_count(key: str, built: dict | None = None) -> dict:
    """Instructions per unit by pipe of one probe, from its library as
    built ({source: library path}; default: built now if needed)."""
    (one, two), src, units, _ = PROBES[key]
    library = built[src] if built else _build.build(src).path
    diff = function_opcodes(library, two)
    diff.subtract(function_opcodes(library, one))
    return per_pipe(diff, units)


def probe_counts() -> dict:
    """{probe: instructions per unit by pipe}, from the libraries as built
    (building them first if needed)."""
    built = {b.name: b.path for b in _build.build_all()}
    return {key: probe_count(key, built) for key in PROBES}


def int_bound_ms(counts: dict, units: float, sms: int, clock_hz: float) -> tuple:
    """(ms, pipe): the least time for ``units`` units of a probe's work, the
    largest over the pipes of units x instructions per unit / (rate x SMs
    x clock)."""
    best = (0.0, "none")
    for pipe, rate in RATES.items():
        ms = 1e3 * units * counts[pipe] / (rate * sms * clock_hz)
        best = max(best, (ms, pipe))
    return best


def max_sm_clock_hz() -> float:
    """The card's largest SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits", "-i", "0"],
                         capture_output=True, text=True, check=True, timeout=60)
    return 1e6 * float(out.stdout.strip().splitlines()[0])


def main():
    import torch

    counts = probe_counts()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_hz()
    for key, ((_, fn), _, units, unit) in PROBES.items():
        c = counts[key]
        print(f"{fn[:-1]}: per {unit} " + ", ".join(f"{p} {v:.2f}" for p, v in c.items())
              + f"; {sms} SMs at {clock / 1e9:.3f} GHz: 1e9 {unit}s take at least "
              f"{int_bound_ms(c, 1e9, sms, clock)[0]:.3f} ms (bound by "
              f"{int_bound_ms(c, 1e9, sms, clock)[1]})")


if __name__ == "__main__":
    main()
