"""PyTorch/CUDA port of qkv_ecc_tpu: ECC-protected INT4 KV-cache decode and
serving on an NVIDIA H100.

The layout mirrors the JAX package (``codecs/``, ``kernels/``, ``cache/``,
``models/``, ``serving/``, ``benchmarks/``, ``evaluation/``) so each
module's counterpart is found by name.
Storage formats are kept bit for bit: a cache written here compares with
``torch.equal`` against a JAX cache converted through numpy.

Ported so far: the llama decode runtime in every mode, the packed-int ones
and the float arms fp16 and fp8 (``models/runtime.py``), the cache engine
and block manager (``cache/``), the continuous-batching server
(``serving/``), the codec layer's tables, oracles and fault injection
(``codecs/``), and the kernel benchmark harness, its timers and the
single-device scaling row (``benchmarks/``, ``evaluation/``). Kernels
written by hand in CUDA C++ carry them: the fused write+attend read of data
words and the float codecs' read (``csrc/write_attend.cu``), the correcting
read of the parity codecs (``csrc/decode_attend.cu``), and K4, each
kernel's read without a write (``kernels/paged_attention.py``); the
elementwise codec
kernels and the fault injector (``csrc/codec_kernels.cu``,
``kernels/codec_kernels.py``). The Monte-Carlo quality path
(``evaluation/``: the sweep, its metrics and tables, the CLI
``evaluation/experiments/monte_carlo.py``; the quantizers and fused codec
chains of ``codecs/``; ``training/``'s checkpoint loader) runs the forward,
which needs no kernel.
"""
