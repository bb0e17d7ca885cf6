"""The benchmark of ``repro_torch`` on one NVIDIA H100.

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json``. Everything the harness needs
to run a cell is found by name: the cell in ``bench/workloads/<cell>.json``,
its configuration in ``bench/configs/<config>.json``, the traffic kind's
driver in ``bench/traffic/<kind>.py`` and each metric's reader in
``bench/metrics/<metric>.py``. A new cell, configuration or metric is a new
file. Nothing here imports ``jax`` or the JAX package ``repro``; the plain
reference in ``bench/reference/`` imports nothing of ``repro_torch``.
"""
