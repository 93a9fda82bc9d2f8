"""The benchmark of ``tpu_hnsw_torch`` on NVIDIA H100 cards.

``BENCHMARK.json`` at the root of the repo lists the cells; ``run.py`` runs
one (``python3 -m hnswbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``). Each configuration, traffic mix, system under test and
metric reader is a file of its own under ``configs/``, ``traffic/``,
``engines/`` and ``metrics/``, found by name (``spec.py``). Nothing here
imports JAX or the JAX package; the plain reference (``reference.py``)
imports nothing of the program.
"""
