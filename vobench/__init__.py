"""The benchmark of ``monocular_visual_odometry_va4mr_torch`` on one card.

``python3 -m vobench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``.  See README.md.
(This file imports nothing, so the run's clock starts before torch loads.)
"""
