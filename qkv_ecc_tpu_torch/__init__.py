"""PyTorch/CUDA port of qkv_ecc_tpu: ECC-protected INT4 KV-cache decode on an
NVIDIA H100.

The layout mirrors the JAX package (``codecs/``, ``kernels/``, ``cache/``,
``models/``) so each module's counterpart is found by name. Storage formats
are kept bit for bit: a cache written here compares with ``torch.equal``
against a JAX cache converted through numpy.

This slice covers the scrubbed decode path of the ``int4-write-inject`` and
``int12-golay`` modes on the llama architecture. The one kernel on that path
is the fused write+attend kernel (``kernels/paged_attention.py``,
``csrc/write_attend.cu``).
"""
