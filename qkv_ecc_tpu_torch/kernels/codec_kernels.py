"""Elementwise codec kernels and the in-kernel fault injector (counterpart of
``qkv_ecc_tpu/kernels/codec_kernels.py``), written by hand in CUDA C++
(``csrc/codec_kernels.cu``):

  * K5 ``hamming74_encode_cuda`` / ``hamming74_decode_cuda``;
  * K6 ``hamming84_encode_cuda`` / ``hamming84_decode_cuda``;
  * K7 ``golay_encode_packed_cuda`` / ``golay_decode_packed_cuda``, and the
    triplet forms ``golay_encode_cuda`` / ``golay_decode_cuda``;
  * K8 ``golay_write_scrub_cuda``;
  * K9 ``inject_bit_errors_cuda``.

Each takes the JAX function's arguments and returns its dtypes and shapes.
For tensors on the card a wrapper launches the kernel or raises; for
tensors on the CPU (and array-likes, which become CPU tensors) it runs the
kernel's plain PyTorch version (the ``*_plain`` functions, the bodies of the
JAX kernels composed from ``kernels/common.py``). Empty input launches
nothing. Each wrapper that launches counts it in ``.launches`` and
``.launches_by`` (by operation; K9 by dtype); the triplet wrappers launch
through the packed ones and count there. K7's decode and K8 read the
4096-entry Golay syndrome table (``common.golay_syndrome_table``, built
once per device by ``paged_attention.golay_syndrome_table``), which the
wrapper passes to the kernel.

K9's flips come from a counter hash, not from the TPU's on-chip PRNG: bit b
of flat element i flips when murmur3's finalizer of ((i * n_bits + b) *
0x9E3779B9 + seed) mod 2^32 is below ``min(int(ber * 2^32), 2^32 - 1)``
(``swar.hash_flip_mask`` over one row of the flat elements, the hash of
mode int4's read flips). The JAX contract is the flip rate and determinism
per (seed, shape) (``qkv_ecc_tpu/codecs/fault_injection.py:9-13``); the
plain version gives the kernel's bits exactly.
"""

from __future__ import annotations

import torch

from ..codecs.algebra import GOLAY_B_ROW_MASKS
from ..codecs.reference import golay_pack, golay_unpack
from . import common as C
from . import swar
from ._build import launcher
from .paged_attention import golay_syndrome_table

_B_MASKS = tuple(int(m) for m in GOLAY_B_ROW_MASKS)
# the operations of csrc/codec_kernels.cu's codec_launch
_OPS = {"hamming74_encode": 0, "hamming74_decode": 1, "hamming84_encode": 2,
        "hamming84_decode": 3, "golay_encode": 4, "golay_decode": 5, "golay_write_scrub": 6}
# the operations that read the Golay syndrome table
_SYNDROME_OPS = ("golay_decode", "golay_write_scrub")
_INJECT_DTYPES = {torch.uint8: "uint8", torch.int32: "int32"}


# =============================================================================
# The plain versions (the JAX kernel bodies, codec_kernels.py:86-187)
# =============================================================================


def hamming74_encode_plain(values: torch.Tensor) -> torch.Tensor:
    return C.hamming74_encode_i32(values.to(torch.int32)).to(torch.uint8)


def hamming74_decode_plain(codewords: torch.Tensor):
    data, err = C.hamming74_decode_i32(codewords.to(torch.int32))
    return data.to(torch.uint8), err.to(torch.uint8)


def hamming84_encode_plain(values: torch.Tensor) -> torch.Tensor:
    return C.hamming84_encode_i32(values.to(torch.int32)).to(torch.uint8)


def hamming84_decode_plain(codewords: torch.Tensor):
    data, error_type = C.hamming84_decode_i32(codewords.to(torch.int32))
    return data.to(torch.uint8), error_type.to(torch.uint8)


def golay_encode_plain(data12: torch.Tensor) -> torch.Tensor:
    return C.golay_encode_i32(data12 & 0xFFF, _B_MASKS)


def golay_decode_plain(codewords: torch.Tensor):
    return C.golay_decode_i32(codewords, _B_MASKS, zero_uncorrectable=False)


def golay_write_scrub_plain(data12: torch.Tensor, flip_mask: torch.Tensor) -> torch.Tensor:
    cw = C.golay_encode_i32(data12 & 0xFFF, _B_MASKS) ^ flip_mask
    return C.golay_encode_i32(C.golay_correct_data_i32(cw, _B_MASKS), _B_MASKS)


def inject_bit_errors_plain(data: torch.Tensor, threshold: int, n_bits: int,
                            seed: int) -> torch.Tensor:
    """data XOR the counter-hash flips of its flattened elements, in data's
    dtype and shape (bit for bit K9's)."""
    flat = data.reshape(1, -1).to(torch.int32)
    base = torch.zeros((), dtype=torch.int64, device=data.device)
    # one row: hash_flip_mask's element index (row * width + lane) is then
    # the flat index
    mask = swar.hash_flip_mask(int(seed), base, tuple(flat.shape), threshold, n_bits)
    return (flat ^ mask).to(data.dtype).reshape(data.shape)


# =============================================================================
# The wrappers
# =============================================================================


def _count(wrapper, branch):
    wrapper.launches += 1
    wrapper.launches_by[branch] += 1


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _run(wrapper, op, inputs, in_dtype, out_dtypes, plain):
    """Cast the inputs to in_dtype (as the JAX wrappers' jnp.asarray does),
    then: zeros for an empty input, the plain version on the CPU, the kernel
    on the card; one output as a tensor, two as a tuple."""
    xs = tuple(torch.as_tensor(a).to(in_dtype) for a in inputs)
    x = xs[0]
    if any(t.shape != x.shape or t.device != x.device for t in xs[1:]):
        raise ValueError(f"{op}: the inputs must have one shape and one device")
    if x.numel() == 0:
        outs = tuple(torch.zeros(x.shape, dtype=dt, device=x.device) for dt in out_dtypes)
    elif x.device.type == "cpu":
        outs = plain(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
    elif x.device.type == "cuda":
        xs = tuple(t.contiguous() for t in xs)
        outs = tuple(torch.empty(x.shape, dtype=dt, device=x.device) for dt in out_dtypes)
        mask = xs[1].data_ptr() if len(xs) > 1 else 0
        syn = golay_syndrome_table(x.device).data_ptr() if op in _SYNDROME_OPS else 0
        rc = launcher("codec_kernels", "ippppplp", "codec_launch")(
            _OPS[op], xs[0].data_ptr(), mask, syn, outs[0].data_ptr(),
            outs[1].data_ptr() if len(outs) > 1 else 0, x.numel(), _stream(x))
        if rc != 0:
            raise RuntimeError(f"{op} kernel launch failed: cudaError {rc}")
        _count(wrapper, op)
    else:
        raise ValueError(f"{op}: no kernel for device {x.device}")
    return outs[0] if len(outs) == 1 else outs


def _counted(*branches):
    def deco(fn):
        fn.launches = 0
        fn.launches_by = dict.fromkeys(branches, 0)
        return fn
    return deco


@_counted("hamming74_encode")
def hamming74_encode_cuda(values):
    """K5: Hamming(7,4) encode, uint8 values (the low nibble) -> uint8
    7-bit codewords (JAX: ``hamming74_encode_tpu``, codec_kernels.py:99)."""
    return _run(hamming74_encode_cuda, "hamming74_encode", (values,), torch.uint8,
                (torch.uint8,), hamming74_encode_plain)


@_counted("hamming74_decode")
def hamming74_decode_cuda(codewords):
    """K5: Hamming(7,4) decode, uint8 codewords -> (uint8 data, uint8 error
    flag) (JAX: ``hamming74_decode_tpu``, codec_kernels.py:105)."""
    return _run(hamming74_decode_cuda, "hamming74_decode", (codewords,), torch.uint8,
                (torch.uint8, torch.uint8), hamming74_decode_plain)


@_counted("hamming84_encode")
def hamming84_encode_cuda(values):
    """K6: Hamming(8,4) SECDED encode, uint8 -> uint8 codewords (JAX:
    ``hamming84_encode_tpu``, codec_kernels.py:130)."""
    return _run(hamming84_encode_cuda, "hamming84_encode", (values,), torch.uint8,
                (torch.uint8,), hamming84_encode_plain)


@_counted("hamming84_decode")
def hamming84_decode_cuda(codewords):
    """K6: Hamming(8,4) SECDED decode -> (uint8 data, uint8 ErrorType 0-3)
    (JAX: ``hamming84_decode_tpu``, codec_kernels.py:136)."""
    return _run(hamming84_decode_cuda, "hamming84_decode", (codewords,), torch.uint8,
                (torch.uint8, torch.uint8), hamming84_decode_plain)


@_counted("golay_encode")
def golay_encode_packed_cuda(data12, sublanes: int = 64):
    """K7: Golay encode, int32 12-bit data words (``data12 & 0xFFF``) ->
    int32 24-bit codewords (JAX: ``golay_encode_packed_tpu``,
    codec_kernels.py:159). ``sublanes``, the TPU's tile height, is accepted
    and ignored."""
    return _run(golay_encode_packed_cuda, "golay_encode", (data12,), torch.int32,
                (torch.int32,), golay_encode_plain)


@_counted("golay_decode")
def golay_decode_packed_cuda(codewords, sublanes: int = 64):
    """K7: Golay IMLD decode of int32 codewords (bits 24-31 ignored) ->
    (int32 data12, int32 error count 0-3, or 4 when uncorrectable, whose
    corrupt data bits are kept) (JAX: ``golay_decode_packed_tpu``,
    codec_kernels.py:168). ``sublanes`` is accepted and ignored."""
    return _run(golay_decode_packed_cuda, "golay_decode", (codewords,), torch.int32,
                (torch.int32, torch.int32), golay_decode_plain)


@_counted("golay_write_scrub")
def golay_write_scrub_cuda(data12, flip_mask):
    """K8: encode -> XOR ``flip_mask`` -> IMLD data correction
    (uncorrectable -> 0) -> re-encode, in one launch; int32 in, int32 24-bit
    codewords out (JAX: ``golay_write_scrub_tpu``, codec_kernels.py:191)."""
    return _run(golay_write_scrub_cuda, "golay_write_scrub", (data12, flip_mask),
                torch.int32, (torch.int32,), golay_write_scrub_plain)


def golay_encode_cuda(nibbles):
    """Triplets [..., 3] -> int32 codewords [...] through K7 (JAX:
    ``golay_encode_tpu``, codec_kernels.py:219)."""
    return golay_encode_packed_cuda(golay_pack(torch.as_tensor(nibbles)))


def golay_decode_cuda(codewords):
    """int32 codewords [...] -> (uint8 triplets [..., 3], int32 error count
    [...]) through K7 (JAX: ``golay_decode_tpu``, codec_kernels.py:226)."""
    data12, count = golay_decode_packed_cuda(codewords)
    return golay_unpack(data12), count


@_counted(*_INJECT_DTYPES.values())
def inject_bit_errors_cuda(data, ber, n_bits, seed):
    """K9: Bernoulli flips of the low ``n_bits`` bits of every element of
    uint8 or int32 ``data`` at rate ``ber``, deterministic per (seed,
    shape), returned in data's dtype and shape; the data itself when it is
    empty or ``ber <= 0`` (JAX: ``inject_bit_errors_tpu``,
    codec_kernels.py:251). The flips are the module docstring's counter
    hash."""
    data = torch.as_tensor(data)
    if data.numel() == 0 or ber <= 0:
        return data
    if data.dtype not in _INJECT_DTYPES:
        raise ValueError(f"inject_bit_errors_cuda: uint8 or int32 data, got {data.dtype}")
    if not 1 <= int(n_bits) <= 32:
        raise ValueError(f"inject_bit_errors_cuda: n_bits {n_bits} outside [1, 32]")
    threshold = min(int(float(ber) * 2.0 ** 32), 0xFFFFFFFF)
    if data.device.type == "cpu":
        return inject_bit_errors_plain(data, threshold, int(n_bits), int(seed))
    if data.device.type != "cuda":
        raise ValueError(f"inject_bit_errors_cuda: no kernel for device {data.device}")
    x = data.contiguous()
    out = torch.empty_like(x)
    rc = launcher("codec_kernels", "ppliiiip", "inject_launch")(
        x.data_ptr(), out.data_ptr(), x.numel(), x.element_size(), int(n_bits),
        C.i32_bits(threshold), C.i32_bits(int(seed)), _stream(x))
    if rc != 0:
        raise RuntimeError(f"inject_bit_errors kernel launch failed: cudaError {rc}")
    _count(inject_bit_errors_cuda, _INJECT_DTYPES[data.dtype])
    return out


WRAPPERS = (hamming74_encode_cuda, hamming74_decode_cuda, hamming84_encode_cuda,
            hamming84_decode_cuda, golay_encode_packed_cuda, golay_decode_packed_cuda,
            golay_write_scrub_cuda, inject_bit_errors_cuda)
