"""The unprotected INT4 control arm (counterpart of
``qkv_ecc_tpu/cache/unprotected.py``): the same engine with codec int4 and
fresh Bernoulli flips on the raw nibbles at every attend (read-time
injection), and the measured-BER accessors.
"""

from __future__ import annotations

import dataclasses

from .engine import ECCEngine, ECCEngineConfig


@dataclasses.dataclass
class UnprotectedEngineConfig(ECCEngineConfig):
    """Forces codec "int4" with read-time injection: during generation the
    same cached token is re-corrupted independently at every read, unlike
    the protected arms' persistent write-time corruption."""

    def __post_init__(self):
        self.codec = "int4"
        self.inject_at = "read"
        super().__post_init__()


class UnprotectedBackend(ECCEngine):
    """INT4 write/attend with Bernoulli read-time bit flips, no correction."""

    def __init__(self, config: UnprotectedEngineConfig, num_layers, num_heads, num_kv_heads,
                 head_dim, device=None):
        if not isinstance(config, UnprotectedEngineConfig):
            config = UnprotectedEngineConfig(
                ber=config.ber, block_size=config.block_size, num_blocks=config.num_blocks,
                inject_errors=config.inject_errors, seed=config.seed)
        super().__init__(config, num_layers, num_heads, num_kv_heads, head_dim, device=device)


def get_unprotected_stats(engine: ECCEngine) -> dict:
    """Measured corruption statistics."""
    s = engine.stats
    return {k: s[k] for k in ("bits_flipped", "total_bits", "actual_ber", "total_values",
                              "injection_count")}
