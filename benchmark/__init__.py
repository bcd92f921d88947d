"""Benchmark of the PyTorch/CUDA port ``pointnav_vo_tpu_torch`` on one H100.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  Configurations
(``configs/``), traffic mixes (``traffic/``) and per-layer metrics
(``metrics/``) are files found by the names ``BENCHMARK.json`` gives.
Nothing here imports ``jax`` or the JAX package; ``reference/`` and
``traffic_gen/`` import nothing of the port either.
"""
