"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in a minute (a
120x160 drive of 26 frames), and the
one command's run of it on the CPU in this process:

    python -m vobench.tests.tiny <cell> [<seed> [<trace>]]

prints what ``vobench.run`` prints, then ``forbidden <JSON list>``: the
top-level modules of ``vobench.run.FORBIDDEN`` the run loaded."""
from __future__ import annotations

import argparse
import json
import copy
import sys

H, W, FRAMES = 120, 160, 26


def tiny(cell):
    c = copy.deepcopy(cell)
    d = c.config["drive"]
    d.update(frames=FRAMES, image_shape=[H, W],
             K=[[0.7 * W, 0.0, W / 2.0], [0.0, 0.7 * W, H / 2.0],
                [0.0, 0.0, 1.0]])
    c.config["pipeline"]["image_shape"] = [H, W]
    return c


def main(argv=None) -> int:
    from vobench import cell as cellmod, run

    argv = list(sys.argv[1:] if argv is None else argv)
    name = argv[0]
    args = argparse.Namespace(
        seed=int(argv[1]) if len(argv) > 1 else 2 ** 31 + 7, seconds=0.0,
        trace=int(argv[2]) if len(argv) > 2 else 0)
    rc = run.report(tiny(cellmod.load(name)), args, "cpu", workers=2)
    print("forbidden " + json.dumps(run.forbidden_modules()), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
