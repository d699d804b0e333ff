"""Standalone runners (counterpart of ``qkv_ecc_tpu/evaluation/runners``):
the large-model perplexity sweep of ``tpu_eval``."""
