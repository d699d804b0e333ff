"""Kernel microbenchmarks and decode scaling (counterpart of
``qkv_ecc_tpu/benchmarks``)."""
