"""Run many sequences in data-parallel lockstep over mesh slots (port of
``parallel/multi_seq.py``).

Each slot owns one sequence; every frame steps the slots of each device as
one batch (``seq_dp.batched_step``: the step's body under
``torch.func.vmap``, one replay of the captured batched step a frame on a
card), with zero collectives, and reads the frame's poses, inlier counts and
statuses back in one copy per device (the batch's packed ``frame_outputs``
rows).  The bootstraps run per sequence, as the reference's do.

Random draws: sequence ``s`` of a run seeded ``seed`` draws exactly as a
solo ``runner.run_sequence(seed=sequence_seed(seed, s))`` does: its
bootstrap from ``frame_generator(sequence_seed(seed, s), 0)`` and the step of
frame ``f`` from ``frame_generator(sequence_seed(seed, s), f)``.  So sequence
``s`` computes, bit for bit, what it computes in a batch of one with those
draws, whatever its batch-mates; on the CPU that is also its solo run (one
whose recovery never fires), while on the card a solo step takes the
libraries' arithmetic and the batch its batch-invariant form
(``pipeline/vo.py``).  ``sequence_seed`` mixes the pair (seed, s) as
``runner.frame_seed`` does, so runs never share a sequence's draws by
pattern: with fewer than 256 sequences, two runs whose seeds differ by less
than 1_302_036 draw apart in every sequence.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..pipeline.runner import _T_WC, frame_generator, frame_seed
from ..pipeline.vo import VisualOdometry
from . import seq_dp


@dataclasses.dataclass
class MultiSeqResult:
    positions: np.ndarray  # (S, F, 3) camera centers per sequence per frame
    n_inliers: np.ndarray  # (S, F)
    status: np.ndarray  # (S, F)


def sequence_seed(seed: int, s: int) -> int:
    """The run seed of sequence ``s``, in [0, 2**31) (see the module
    docstring); seed 0 gives ``s``."""
    return frame_seed(seed, s) & 0x7FFFFFFF


def run_sequences_dp(
    vo: VisualOdometry,
    sequences: Sequence[List[np.ndarray]],
    *,
    n_devices: Optional[int] = None,
    bootstrap_stride: int = 2,
    seed: int = 0,
    axis: str = "data",
) -> MultiSeqResult:
    """Process S same-shape sequences in lockstep, one per mesh slot.

    ``sequences``: list of frame lists (all frames (H, W)); sequences shorter
    than the longest are padded by repeating their last frame (their status
    simply keeps tracking in place), and the batch is padded to
    ``n_devices`` slots by repeating the last sequence.  The slots run on
    every visible card when ``vo`` runs on one, on ``vo``'s device
    otherwise.  Outputs cover frames ``bootstrap_stride + 1`` on.
    """
    S = len(sequences)
    n_devices = n_devices or S
    if S > n_devices:
        raise ValueError(f"{S} sequences for {n_devices} mesh slots")
    mesh = seq_dp.make_mesh(n_devices, axis, None if vo.device.type == "cuda"
                            else [vo.device])
    vos = seq_dp.slot_vos(vo, mesh)

    F = max(len(s) for s in sequences)
    padded = [list(s) + [s[-1]] * (F - len(s)) for s in sequences]
    while len(padded) < n_devices:
        padded.append(padded[-1])
    seeds = [sequence_seed(seed, s) for s in range(n_devices)]

    b = bootstrap_stride
    states = [v.bootstrap(seq[0], seq[b], intermediate=seq[1:b],
                          generator=frame_generator(sd, 0, v.device))
              for v, seq, sd in zip(vos, padded, seeds)]
    batches = seq_dp.stack_slots(states, mesh)
    groups = seq_dp.device_groups(mesh)
    step = seq_dp.batched_step(vo, mesh)
    packing = vo.outputs[False]  # T_CW, n_inliers, n_tracked, status
    rows = [torch.empty((len(slots), packing.nbytes), dtype=torch.uint8,
                        device=dev) for dev, slots in groups]
    # Slot s's row in the devices' rows read back one after the other.
    at = np.argsort([s for _, slots in groups for s in slots])
    poses, inliers, statuses = [], [], []
    for f in range(b + 1, F):
        gens = [frame_generator(sd, f, dev)
                for sd, dev in zip(seeds, mesh.devices)]
        batches = step(batches, [seq[f] for seq in padded], gens,
                       outputs=rows)
        host = torch.cat([r.cpu() for r in rows])
        T_CW, n_inl, _, status = (v.numpy()[at]
                                  for v in packing.views(host))
        poses.append([_T_WC(T)[:3, 3] for T in T_CW])
        inliers.append(n_inl.tolist())
        statuses.append(status.tolist())

    return MultiSeqResult(
        positions=np.stack([np.stack(p) for p in poses], 1)[:S],
        n_inliers=np.asarray(inliers, np.int32).T[:S],
        status=np.asarray(statuses, np.int32).T[:S],
    )
