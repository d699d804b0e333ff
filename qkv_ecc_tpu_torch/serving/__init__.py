"""Serving layer (counterpart of ``qkv_ecc_tpu/serving``): continuous
batching over the paged ECC cache on one card. The tensor-parallel servers
of the JAX package (``serving/tp_server.py``) come with the parallel
layer."""

from .scheduler import ContinuousBatchingServer, Request, RequestOutput

__all__ = ["ContinuousBatchingServer", "Request", "RequestOutput"]
