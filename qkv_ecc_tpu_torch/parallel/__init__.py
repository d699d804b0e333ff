"""Tensor-, data- and context-parallel decode over torch.distributed
(counterpart of ``qkv_ecc_tpu/parallel``), one process per rank:
``mesh.py`` (the (data, model) mesh, its subgroups and collectives),
``launch.py`` (spawning a group of ranks), ``sharding.py`` (which dimension
each parameter and cache array splits on), ``tp_runtime.py`` (the sharded
prefill and decode step, generate_tp), ``context_parallel.py`` (K4 over
page shards, merged across ranks) and ``multihost.py`` (the multi-host
bring-up and its demo CLI)."""
