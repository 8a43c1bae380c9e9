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

The long stream and its data: ``make_kitti_seq`` (render the loop world as
KITTI PNGs), ``bench_stream_2761`` (2761 frames from PNG files with
recovery, block checkpoints and the Sim(3) pose graph), ``bench_stream``,
``bench_native_decode``.  The back end: ``profile_ba``, ``profile_branch``,
``profile_trigger``, ``diag_ba``, ``bench_ba_scaling`` and
``traj_ba_convergence`` (process groups of one rank on the card, gloo
worlds on the CPU).  Diagnostics: ``diag_e2e``, ``diag_drift``,
``diag_survival``, ``exp_ate``.  The JAX side's ``tools/run_reference.py``
has no counterpart: it runs the reference's own code through cv2.

``harness`` holds what more than one of them (and ``chip_smoke.py``) needs:
the spawn-pool renderer, the health gate, the profiler readings and the
``--device`` handling.  Outputs go to standard output as JSON lines; a file
is written only under ``build/`` or where ``--out`` says.
"""
