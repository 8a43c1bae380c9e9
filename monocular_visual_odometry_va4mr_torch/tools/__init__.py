"""The port's measuring and diagnostic entry points, counterparts of the JAX
side's ``bench.py`` and ``tools/*.py`` (which import JAX and so cannot
measure the port).  Each runs as a module on ``cuda`` by default and raises
when CUDA is absent unless ``--device cpu`` is given:

    python -m monocular_visual_odometry_va4mr_torch.tools.bench [--seeds 0,1,2]
    python -m monocular_visual_odometry_va4mr_torch.tools.bench_datasets
    python -m monocular_visual_odometry_va4mr_torch.tools.profile_step \\
        [--dataset parking] [--scan] [--json]
    python -m monocular_visual_odometry_va4mr_torch.tools.diag_tracker
    python -m monocular_visual_odometry_va4mr_torch.tools.stress_klt_motion

``harness`` holds what more than one of them (and ``chip_smoke.py``) needs:
the spawn-pool renderer, the health gate, the profiler readings and the
``--device`` handling.  Outputs go to standard output as JSON lines; a file
is written only under ``build/`` or where ``--out`` says.
"""
