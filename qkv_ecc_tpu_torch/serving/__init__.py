"""Serving layer (counterpart of ``qkv_ecc_tpu/serving``): continuous
batching over the paged ECC cache on one card (``scheduler.py``), and over a
(data, model) mesh of ranks (``tp_server.py``)."""

from .scheduler import ContinuousBatchingServer, Request, RequestOutput
from .tp_server import MultihostTPContinuousBatchingServer, TPContinuousBatchingServer

__all__ = [
    "ContinuousBatchingServer",
    "TPContinuousBatchingServer",
    "MultihostTPContinuousBatchingServer",
    "Request",
    "RequestOutput",
]
