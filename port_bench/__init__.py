"""The benchmark of the PyTorch/CUDA port (``fish_tts_tpu_torch``).

``python -m port_bench --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once on one CUDA card and
prints one JSON result line; see ``run.py``.  Configurations, traffic mixes
and metrics are data and readers found by name under ``configs/``,
``traffic/`` and ``metrics/``; ``reference/`` is the plain float32 model
that decides ``correct``.  Nothing here imports JAX or the JAX package.
"""
