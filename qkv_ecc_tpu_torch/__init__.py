"""PyTorch/CUDA port of qkv_ecc_tpu: ECC-protected INT4 KV-cache decode and
serving on an NVIDIA H100.

The layout mirrors the JAX package (``codecs/``, ``kernels/``, ``cache/``,
``models/``, ``serving/``) so each module's counterpart is found by name.
Storage formats are kept bit for bit: a cache written here compares with
``torch.equal`` against a JAX cache converted through numpy.

Ported so far: the llama decode runtime in every mode, the packed-int ones
and the float arms fp16 and fp8 (``models/runtime.py``), the cache engine
and block manager (``cache/``), the continuous-batching server
(``serving/``) and the codec layer's tables, oracles and fault injection
(``codecs/``). Kernels written by hand in CUDA C++ carry them
(``kernels/paged_attention.py``): the fused write+attend read of data words
and the float codecs' read (``csrc/write_attend.cu``), the correcting read
of the parity codecs (``csrc/decode_attend.cu``), and K4, each kernel's
read without a write (``paged_attention_ecc``).
"""
