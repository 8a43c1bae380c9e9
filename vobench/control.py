"""The comparison's control and its planted faults, on the card at a
cell's own size: what ``limits/<cell>.json``'s upper readings come from and
what ``tests/test_vobench_card.py`` holds.  The benchmark's own runs never
run this.

    python3 -m vobench.control --workload <cell> --kind <kind> \\
        --seeds <a,b,c> --seconds <s>

Kinds:

* ``tf32``: the control.  The program with TF32 matmuls switched on
  (``torch.backends.cuda.matmul.allow_tf32``), the precision below the
  float32 the configuration states.
* ``frozen``: a step that returns its state unchanged (the step's body
  computes the new state and returns the old one, in every graph captured
  from it).
* ``altered``: an answer altered where it is produced: inside the step's
  body, the pose of every frame whose counter is 3 modulo 7 moved by
  ``ALTER_UNITS`` along the camera's x axis (the map's units: the
  bootstrap's baseline is one).

Prints ``vobench.control {...}`` a seed: the kind, the seed, the numbers
compared beside their limits, ``correct`` and the readings.  Exit code 2
without a card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

KINDS = ("tf32", "frozen", "altered")
ALTER_UNITS = 3.0


def plant(kind: str):
    """Switch ``kind`` on in this process; returns the function that
    switches it off."""
    import torch

    from monocular_visual_odometry_va4mr_torch.pipeline import vo as vomod

    if kind == "tf32":
        before = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True

        def undo():
            torch.backends.cuda.matmul.allow_tf32 = before
        return undo
    cls = vomod.VisualOdometry
    body = cls._step_body
    if kind == "frozen":
        def planted(self, state, image, draws, run_ba):
            body(self, state, image, draws, run_ba)
            return state
    elif kind == "altered":
        def planted(self, state, image, draws, run_ba):
            new = body(self, state, image, draws, run_ba)
            T = new.T_CW
            e = torch.eye(4, dtype=T.dtype, device=T.device)
            shift = e[:, 0:1] * e[3:4, :]  # 1 at row 0, column 3
            hit = (new.frame_idx.remainder(7) == 3).to(T.dtype)
            return new.replace(T_CW=T + ALTER_UNITS * hit * shift)
    else:
        raise ValueError(f"kind {kind!r}: expected one of {KINDS}")
    cls._step_body = planted

    def undo():
        cls._step_body = body
    return undo


def run_kind(cell, kind, seeds, seconds, device="cuda", **kw):
    """One ``vobench.run.run`` of ``cell`` a seed with ``kind`` planted:
    [{"seed", "correct", "check", "readings"}, ...]."""
    from . import run

    undo = plant(kind)
    try:
        out = []
        for seed in seeds:
            res, info = run.run(cell, seed, seconds, 0, device,
                                t0=time.perf_counter(), **kw)
            out.append(dict(kind=kind, seed=seed, correct=res["correct"],
                            check=res["check"], failed=res["failed"],
                            attempted=res["attempted"],
                            window=info["window"]))
        return out
    finally:
        undo()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--kind", choices=KINDS, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    import torch

    from . import cell as cellmod

    if not torch.cuda.is_available():
        print("vobench.control: no card", file=sys.stderr)
        return 2
    cell = cellmod.load(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s.strip()]
    for line in run_kind(cell, args.kind, seeds, args.seconds):
        print("vobench.control " + json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
