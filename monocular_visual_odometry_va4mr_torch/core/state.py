"""The fixed-shape per-frame VO state (port of ``core/state.py``).

``FrameState`` is a dataclass of tensors with the reference's fields; one
step hands it to the next.  ``frame_idx`` is a device int32 scalar, as in
the reference, so the step reads it without the host.  Beside the fields a
state carries ``host_frame``, the same index on the host, set by the code
that makes the state (``init_state``, the bootstrap, the step,
``from_numpy``) and never read back from the device; the drivers pick the
in-step BA cadence from it (``pipeline/vo.py``).

``to_numpy`` / ``from_numpy`` carry a state across to and from the JAX
package: a dict of numpy arrays, one entry per field, with
``prev_pyramid`` as a tuple (``from_numpy`` also takes a JAX ``FrameState``
itself).

``Packing`` lays a fixed set of tensors out in one flat byte buffer, each a
view of it: the captured step (``pipeline/vo.py``) keeps its state there and
copies a whole state with one copy.

``stack_states`` puts S states of one layout on a leading axis, as the
batched step (``VisualOdometry.step_batch``) takes them; ``unstack_states``
takes them apart again.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .config import PipelineConfig

STATUS_TRACKING = 0
STATUS_LOST = 1


@dataclasses.dataclass
class FrameState:
    # --- pose ---
    frame_idx: torch.Tensor  # () int32 frame counter
    T_CW: torch.Tensor  # (4,4) f32 current extrinsics (world -> camera)

    # --- landmark-backed tracks ---
    lm_xyz: torch.Tensor  # (K,3) world-frame landmarks
    lm_uv: torch.Tensor  # (K,2) current pixel coords
    lm_valid: torch.Tensor  # (K,) bool
    lm_inlier: torch.Tensor  # (K,) bool, last PnP-RANSAC inlier mask
    lm_gen: torch.Tensor  # (K,) int32 slot generation, bumps on re-allocation

    # --- landmark anchor observation (sliding re-triangulation) ---
    lm_first_uv: torch.Tensor  # (K,2)
    lm_T_CW_first: torch.Tensor  # (K,4,4)
    lm_anchor_age: torch.Tensor  # (K,) int32

    # --- candidate tracks ---
    cand_uv: torch.Tensor  # (M,2)
    cand_first_uv: torch.Tensor  # (M,2)
    cand_T_CW_first: torch.Tensor  # (M,4,4)
    cand_first_frame: torch.Tensor  # (M,) int32
    cand_valid: torch.Tensor  # (M,) bool

    # --- in-step BA observation ring (length 1 when off) ---
    ba_T: torch.Tensor  # (Wb,4,4)
    ba_uv: torch.Tensor  # (Wb,K,2)
    ba_mask: torch.Tensor  # (Wb,K) bool
    ba_gen: torch.Tensor  # (Wb,K) int32

    # --- previous-frame flat pyramid for KLT ---
    prev_pyramid: Tuple[torch.Tensor, ...]

    # --- health/metrics (0-d device tensors) ---
    status: torch.Tensor  # () int32, STATUS_*
    n_inliers: torch.Tensor  # () int32
    n_tracked: torch.Tensor  # () int32

    # Not a field (no annotation): ``frame_idx`` on the host, or None where
    # the code that made the state did not set it.
    host_frame = None

    def replace(self, **kw) -> "FrameState":
        """A copy with the fields ``kw`` replaced; ``host_frame`` goes with
        it unless ``frame_idx`` is replaced."""
        new = dataclasses.replace(self, **kw)
        if "frame_idx" not in kw:
            new.host_frame = self.host_frame
        return new

    def host_frame_idx(self) -> int:
        """``frame_idx`` as a host int (``host_frame``).  Raises where the
        code that made the state did not set it: nothing reads the index
        back from the device."""
        if self.host_frame is None:
            raise ValueError("the state's frame index is not known on the "
                             "host: set host_frame where the state is made")
        return self.host_frame

    def tensors(self) -> List[torch.Tensor]:
        """Every field's tensor in field order, the pyramid's planes in
        place of ``prev_pyramid``."""
        out = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out.extend(v if f.name == "prev_pyramid" else (v,))
        return out

    def with_tensors(self, tensors: Sequence[torch.Tensor]) -> "FrameState":
        """A state of this one's layout made of ``tensors`` (as ``tensors``
        lists them); ``host_frame`` is not carried."""
        return FrameState.from_tensors(tensors, len(self.prev_pyramid))

    @staticmethod
    def from_tensors(tensors: Sequence[torch.Tensor],
                     levels: int) -> "FrameState":
        """The state of ``tensors`` (as ``tensors`` lists them) with a
        pyramid of ``levels`` planes; no ``host_frame``."""
        it = iter(tensors)
        kw = {}
        for f in dataclasses.fields(FrameState):
            if f.name == "prev_pyramid":
                kw[f.name] = tuple(next(it) for _ in range(levels))
            else:
                kw[f.name] = next(it)
        return FrameState(**kw)

    def to_numpy(self) -> dict:
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "prev_pyramid":
                out[f.name] = tuple(p.detach().cpu().numpy() for p in v)
            else:
                out[f.name] = v.detach().cpu().numpy()
        return out

    @staticmethod
    def from_numpy(d, device=None) -> "FrameState":
        """A state from a dict of arrays, one per field, or from any object
        with the fields as attributes (a JAX ``FrameState``: each field is
        read through ``np.asarray``)."""
        kw = {}
        host = None
        for f in dataclasses.fields(FrameState):
            v = d[f.name] if isinstance(d, dict) else getattr(d, f.name)
            if f.name == "prev_pyramid":
                kw[f.name] = tuple(torch.as_tensor(np.array(p)).to(device)
                                   for p in v)
            elif f.name == "frame_idx":
                # int32 whatever it was saved as (older checkpoints: int64).
                host = int(np.asarray(v))
                kw[f.name] = torch.tensor(host, dtype=torch.int32,
                                          device=device)
            else:
                kw[f.name] = torch.as_tensor(np.array(v)).to(device)
        state = FrameState(**kw)
        state.host_frame = host
        return state


class Packing:
    """Tensors of fixed shapes and dtypes laid out in one flat uint8 buffer
    of ``nbytes`` bytes, each at an offset aligned to 16 bytes, so that each
    is a view of the buffer and the whole set is copied with one copy."""

    ALIGN = 16

    def __init__(self, like: Sequence[torch.Tensor]):
        self.specs = [(tuple(t.shape), t.dtype) for t in like]
        self.offsets = []
        end = 0
        for shape, dtype in self.specs:
            start = -(-end // self.ALIGN) * self.ALIGN
            self.offsets.append(start)
            end = start + math.prod(shape) * dtype.itemsize
        self.nbytes = -(-end // self.ALIGN) * self.ALIGN

    def views(self, buf: torch.Tensor) -> List[torch.Tensor]:
        """The tensors as views of ``buf`` (``(..., nbytes)`` uint8: each
        view then has the leading dimensions of ``buf``)."""
        if buf.dtype != torch.uint8 or buf.shape[-1] != self.nbytes:
            raise ValueError(f"a packing of {self.nbytes} bytes needs a uint8 "
                             f"buffer of that last dimension; got "
                             f"{buf.dtype} {tuple(buf.shape)}")
        lead = tuple(buf.shape[:-1])
        return [buf[..., o:o + math.prod(s) * dt.itemsize].view(dt)
                .view(lead + s) for o, (s, dt) in zip(self.offsets,
                                                      self.specs)]

    def check(self, tensors: Sequence[torch.Tensor], lead=()) -> None:
        """Raise unless ``tensors`` have this packing's shapes, after the
        leading dimensions ``lead``, and dtypes."""
        got = [(tuple(t.shape), t.dtype) for t in tensors]
        want = [(tuple(lead) + s, dt) for s, dt in self.specs]
        if got != want:
            raise ValueError(f"tensors {got} do not fit the packing "
                             f"{want}")

    def pack(self, buf: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
        """Copy ``tensors`` into their views of ``buf``; a buffer ``(...,
        nbytes)`` takes tensors with its leading dimensions (a batch)."""
        self.check(tensors, buf.shape[:-1])
        for view, t in zip(self.views(buf), tensors):
            view.copy_(t)


def init_state(config: PipelineConfig, pyramid: Tuple[torch.Tensor, ...],
               device=None) -> FrameState:
    """Blank state at the identity pose."""
    K = config.capacity.max_landmarks
    M = config.capacity.max_candidates
    Wb = max(1, config.ba.window if config.ba.every else 1)
    f32, i32 = torch.float32, torch.int32

    def eyes(n):
        return torch.eye(4, dtype=f32, device=device).repeat(n, 1, 1)

    def zeros(shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    state = FrameState(
        frame_idx=zeros((), i32),
        T_CW=torch.eye(4, dtype=f32, device=device),
        lm_xyz=zeros((K, 3)),
        lm_uv=zeros((K, 2)),
        lm_valid=zeros((K,), torch.bool),
        lm_inlier=zeros((K,), torch.bool),
        lm_gen=zeros((K,), i32),
        lm_first_uv=zeros((K, 2)),
        lm_T_CW_first=eyes(K),
        lm_anchor_age=zeros((K,), i32),
        cand_uv=zeros((M, 2)),
        cand_first_uv=zeros((M, 2)),
        cand_T_CW_first=eyes(M),
        cand_first_frame=zeros((M,), i32),
        cand_valid=zeros((M,), torch.bool),
        ba_T=eyes(Wb),
        ba_uv=zeros((Wb, K, 2)),
        ba_mask=zeros((Wb, K), torch.bool),
        ba_gen=zeros((Wb, K), i32),
        prev_pyramid=pyramid,
        status=zeros((), i32),
        n_inliers=zeros((), i32),
        n_tracked=zeros((), i32),
    )
    state.host_frame = 0
    return state


def stack_states(states: Sequence[FrameState]) -> FrameState:
    """S states of one layout as one, every tensor stacked on a new leading
    axis: the batched step's state.  The states step in lockstep, so they
    must share ``host_frame``; raises otherwise."""
    frames = {s.host_frame for s in states}
    if len(frames) != 1 or None in frames:
        raise ValueError(f"states in lockstep share their host frame index; "
                         f"got {sorted(frames, key=str)}")
    out = states[0].with_tensors([torch.stack(ts) for ts in
                                  zip(*(s.tensors() for s in states))])
    out.host_frame = frames.pop()
    return out


def unstack_states(state: FrameState) -> List[FrameState]:
    """The S states of a stacked state, as views of its tensors, each with
    its ``host_frame``."""
    tensors = state.tensors()
    out = []
    for i in range(state.T_CW.shape[0]):
        one = state.with_tensors([t[i] for t in tensors])
        one.host_frame = state.host_frame
        out.append(one)
    return out
