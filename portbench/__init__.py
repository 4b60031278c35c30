"""The benchmark of ``keto_tpu_torch``: one cell of ``BENCHMARK.json`` run
once, as ``python -m portbench.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by the name the cell gives:
``configs/<name>.json``, ``traffic/<name>.json``, ``metrics/<metric>.py``.
No module here imports ``jax`` or ``keto_tpu``; the program is reached only
through ``system.py``, and the reference (``reference/``) imports nothing of
it.
"""
