"""Evaluation helpers (counterpart of ``qkv_ecc_tpu/evaluation``): the
phase timers and the chips' memory rates the kernel benchmark reads. The
quality sweep, metrics and experiments come with the quality path."""
