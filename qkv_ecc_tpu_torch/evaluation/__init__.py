"""Evaluation (counterpart of ``qkv_ecc_tpu/evaluation``): the Monte-Carlo
quality sweep (``sweep``, ``metrics``, ``data``, ``models``, the CLI in
``experiments/monte_carlo.py``) and its tables (``latex_tables``), the
other experiment CLIs (``experiments/``) and the perplexity runner
(``runners/tpu_eval.py``), the codecs' algebraic verification, the phase
timers, and the chips' memory rates the kernel benchmark reads."""
