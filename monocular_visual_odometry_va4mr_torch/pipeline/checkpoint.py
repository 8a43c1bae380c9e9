"""Checkpoint / resume for the VO state (port of ``pipeline/checkpoint.py``).

The reference writes the state with orbax, the frame cursor and the
host-side refinement state (emitted ``FrameRecord``s, the BA ring, the
pose-graph keyframe bank) to files of their own.  The port writes all of
them into ONE file, ``checkpoint.pt``:
a dict of CPU tensors and plain values written with ``torch.save`` to a
temporary file and renamed over the previous checkpoint, then loaded with
``weights_only=True``.  The rename is atomic, so a crash leaves either the
previous checkpoint or the new one, never a state of one frame beside the
cursor or records of another.  A state saved by the JAX package reaches the
port through numpy: ``FrameState.from_numpy`` of its fields, then
:func:`save`; its keyframe bank through the same ``kf_*`` / ``bank_*``
arrays (``posegraph_runner.bank_from_arrays``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.state import FrameState

_FILE = "checkpoint.pt"


def _path(directory: str) -> str:
    return os.path.join(os.path.abspath(directory), _FILE)


def _load(directory: str) -> Optional[dict]:
    path = _path(directory)
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def save(directory: str, state: FrameState, frame_index: int, *,
         records=None, ring=None, bank=None) -> None:
    """Write a resumable checkpoint (replaces the previous one whole).

    ``records``: list of ``pipeline.runner.FrameRecord``; ``ring``:
    ``pipeline.ba_refine.BARing``; ``bank``:
    ``pipeline.posegraph_runner.KeyframeBank``."""
    tensors = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name == "prev_pyramid":
            tensors[f.name] = [p.detach().cpu() for p in v]
        else:
            tensors[f.name] = v.detach().cpu()
    aux = {}
    if records:
        aux.update(
            rec_frame=_tensor(np.array([r.frame for r in records], np.int64)),
            rec_T_WC=_tensor(np.stack([r.T_WC for r in records])),
            rec_n_inliers=_tensor(np.array([r.n_inliers for r in records])),
            rec_n_tracked=_tensor(np.array([r.n_tracked for r in records])),
            rec_status=_tensor(np.array([r.status for r in records])),
            rec_wall_ms=_tensor(np.array([r.wall_ms for r in records])),
        )
    if ring is not None and len(ring):
        aux.update(
            ring_window=int(ring.window),
            ring_poses=_tensor(np.stack(ring.poses)),
            ring_obs_uv=_tensor(np.stack(ring.obs_uv)),
            ring_obs_mask=_tensor(np.stack(ring.obs_mask)),
            ring_obs_gen=_tensor(np.stack(ring.obs_gen)),
        )
    if bank is not None and bank.keyframes:
        from .posegraph_runner import bank_to_arrays

        aux.update({k: int(v) if np.ndim(v) == 0 else _tensor(v)
                    for k, v in bank_to_arrays(bank).items()})
    payload = dict(frame_index=int(frame_index), state=tensors, aux=aux)
    path = _path(directory)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
    os.replace(tmp, path)


def saved_frame(directory: str) -> Optional[int]:
    """The frame index of the checkpoint in ``directory``, or None when
    there is none."""
    saved = _load(directory)
    return None if saved is None else int(saved["frame_index"])


def restore_aux(directory: str, vo=None):
    """Restore (records, ring, bank) from a checkpoint; each is None if it
    was not saved.  ``vo`` is needed to rebuild the bank."""
    saved = _load(directory)
    if saved is None:
        return None, None, None
    z = {k: (v if isinstance(v, int) else v.numpy())
         for k, v in saved["aux"].items()}
    records = ring = None
    if "rec_frame" in z:
        from .runner import FrameRecord

        records = [
            FrameRecord(frame=int(z["rec_frame"][i]), T_WC=z["rec_T_WC"][i],
                        n_inliers=int(z["rec_n_inliers"][i]),
                        n_tracked=int(z["rec_n_tracked"][i]),
                        status=int(z["rec_status"][i]),
                        wall_ms=float(z["rec_wall_ms"][i]))
            for i in range(len(z["rec_frame"]))
        ]
    if "ring_window" in z:
        from .ba_refine import BARing

        ring = BARing(window=z["ring_window"])
        for i in range(z["ring_poses"].shape[0]):
            ring.poses.append(z["ring_poses"][i])
            ring.obs_uv.append(z["ring_obs_uv"][i])
            ring.obs_mask.append(z["ring_obs_mask"][i])
            ring.obs_gen.append(z["ring_obs_gen"][i])
    bank = None
    if "kf_frame" in z and vo is not None:
        from .posegraph_runner import bank_from_arrays

        bank = bank_from_arrays(vo, **{k: v for k, v in z.items()
                                       if k.startswith(("kf_", "bank_"))})
    return records, ring, bank


def restore(directory: str,
            template: FrameState) -> Tuple[FrameState, int]:
    """Restore (state, frame index of the checkpoint) from a directory.

    ``template`` supplies the device and the shapes (a state from
    ``VisualOdometry.bootstrap``); a checkpoint of other shapes raises."""
    saved = _load(directory)
    if saved is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    d = {k: (tuple(p.numpy() for p in v) if k == "prev_pyramid"
             else v.numpy()) for k, v in saved["state"].items()}
    state = FrameState.from_numpy(d, device=template.T_CW.device)
    for f in dataclasses.fields(state):
        a, b = getattr(state, f.name), getattr(template, f.name)
        if f.name == "prev_pyramid":
            shapes_a = [tuple(p.shape) for p in a]
            shapes_b = [tuple(p.shape) for p in b]
        else:
            shapes_a, shapes_b = tuple(a.shape), tuple(b.shape)
            if a.dtype != b.dtype:
                raise ValueError(f"checkpoint field {f.name} is {a.dtype}, "
                                 f"the pipeline's {b.dtype}")
        if shapes_a != shapes_b:
            raise ValueError(f"checkpoint field {f.name} has shape "
                             f"{shapes_a}, the pipeline's {shapes_b}")
    return state, saved["frame_index"]


def latest_frame(directory: str) -> Optional[int]:
    saved = _load(directory)
    return None if saved is None else saved["frame_index"]
