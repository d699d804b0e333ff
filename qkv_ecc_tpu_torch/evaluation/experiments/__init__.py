"""Evaluation experiments (counterpart of ``qkv_ecc_tpu/evaluation/experiments``):
the Monte-Carlo fault-injection CLI."""
