"""Evaluation experiments (counterpart of ``qkv_ecc_tpu/evaluation/experiments``):
the Monte-Carlo fault-injection CLI and its KL study, training
(``train_tiny``), codec latency, the quantization x ECC study, the
generation demo, the architecture comparison and the fault-tolerance
benchmark, each with the JAX CLI's flags and ``--device``."""
