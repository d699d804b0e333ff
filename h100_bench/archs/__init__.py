"""One module an architecture, ``archs/<name>.py``, named by a configuration
file's ``"reference"`` key (``reference/<name>.py`` is its plain model). It
may import torch and read the port's ModelConfig, and gives:

  port_sizes(config) -> dict     the port's ModelConfig fields and the
                                 values the published config gives them
  make_weights(cfg, normal, full) -> params
                                 the port's parameter tree, drawn with
                                 ``normal(shape, std)`` and
                                 ``full(shape, value)`` (core/weights.py)
  layers(config) -> list         per layer, what core/counts.py counts:
      heads                      query heads
      qk_width, pv_width         a head's q.k and p.v widths
      rows                       the cache rows a token stores, as
                                 (kind, count, width): ``count`` rows of
                                 ``width`` values held in the port's
                                 ``<kind>_cache`` (and ``<kind>_parity``);
                                 one row may serve as both K and V
      window                     tokens a query attends back (itself
                                 included), or None for the whole context
      products_active            matrix parameters one token multiplies
                                 through
      products_held              matrix parameters the step reads
      small                      norm and bias elements
  model(config) -> dict          embed_row (elements read a token: the
                                 embedding row, and a position row where
                                 there is one), lm_head (its parameters),
                                 final_norm (its elements), dtype
"""
