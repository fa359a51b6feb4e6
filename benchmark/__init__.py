"""The benchmark of kasa_tpu_torch: one harness driven by data.

BENCHMARK.json at the checkout's root names the cells; each cell is a
configuration (``configs/<name>.json``: an index deployment), a traffic
mix (``traffic/<name>.json``) and the limits of its correctness check
(``limits/<cell>.json``).  Every metric is a reader of its own
(``metrics/<name>.py``).  ``run.py`` runs one cell; ``calibrate.py``
reads the numbers that the limits are set from.

Nothing here imports JAX or the JAX package; the plain reference
(``reference.py``) imports nothing of the port either.
"""
