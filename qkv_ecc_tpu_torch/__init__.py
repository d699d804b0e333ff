"""PyTorch/CUDA port of qkv_ecc_tpu: ECC-protected INT4 KV-cache decode and
serving on an NVIDIA H100.

The layout mirrors the JAX package (``codecs/``, ``kernels/``, ``cache/``,
``models/``, ``serving/``) so each module's counterpart is found by name.
Storage formats are kept bit for bit: a cache written here compares with
``torch.equal`` against a JAX cache converted through numpy.

Ported so far: the llama decode runtime in every packed-int mode
(``models/runtime.py``), the cache engine and block manager (``cache/``)
and the continuous-batching server (``serving/``). Three kernels carry
them, written by hand in CUDA C++ (``kernels/paged_attention.py``): the
fused write+attend read of data words (``csrc/write_attend.cu``), the
correcting read of the parity codecs (``csrc/decode_attend.cu``), and K4,
either source's read without a write (``paged_attention_ecc``).
"""
