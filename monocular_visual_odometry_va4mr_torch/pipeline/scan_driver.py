"""Block-wise sequence processing (port of ``pipeline/scan_driver.py``).

The reference compiles the step once and iterates it on the device with
``lax.scan``.  The port's counterpart: ``make_scan_step`` returns a callable
that replays the captured step (``VisualOdometry.step``, a CUDA graph on
the card) once per active frame of a block.  The host issues one graph
launch and a few copies per frame (the draws, the image, the state and
the frame's outputs) and reads nothing back inside the block: the activity
mask and the BA cadence are host data.  A masked frame is not stepped; its
outputs repeat the previous frame's.  Each frame's outputs (``frame_outputs``,
with the landmark snapshot where ``emit_landmarks`` asks for it) are written
by the graph into one preallocated device buffer for the block and come
back to the host once per block.  On the CPU
the same loop runs the step eagerly.

``run_streaming`` is the long-sequence path:
  * fixed-size blocks, the padded tail masked (inactive steps are identity),
    so the returned state is exactly the state after the last real frame;
  * re-bootstrap recovery from tracking loss, re-running the rest of the
    block with the recovered state;
  * optional per-frame landmark snapshots (``emit_landmarks``), which feed
    the map-based recovery scale;
  * optional checkpoints at block boundaries.

Random draws come from ``runner.frame_generator(seed, stream)``: frame
``idx`` from stream ``idx``, a re-bootstrap ending at frame ``idx`` from
``10_000_000 + idx``, as in ``pipeline/runner.py``.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.state import STATUS_TRACKING, FrameState
from .runner import (REBOOT_STREAM, frame_generator, map_scale_from_points,
                     median_step_len, reanchor_state)
from .vo import VisualOdometry, frame_outputs


class ScanOutputs(NamedTuple):
    T_CW: torch.Tensor  # (F, 4, 4)
    n_inliers: torch.Tensor  # (F,) int32
    n_tracked: torch.Tensor  # (F,) int32
    status: torch.Tensor  # (F,) int32


class ScanOutputsLm(NamedTuple):
    """ScanOutputs plus a compact per-frame landmark snapshot (pixel
    position, camera-frame depth, validity)."""

    T_CW: torch.Tensor  # (F, 4, 4)
    n_inliers: torch.Tensor  # (F,) int32
    n_tracked: torch.Tensor  # (F,) int32
    status: torch.Tensor  # (F,) int32
    lm_uv: torch.Tensor  # (F, K, 2)
    lm_z: torch.Tensor  # (F, K) camera-frame depth
    lm_valid: torch.Tensor  # (F, K) bool


def make_scan_step(vo: VisualOdometry, *, emit_landmarks: bool = False,
                   masked: bool = False):
    """Returns ``run(state, images (F, H, W), generators (F,)[, active
    (F,)]) -> (state, outputs)``.

    ``masked``: ``active`` is a host sequence of bools; an inactive frame
    passes the state through unchanged (identity), so padded tail frames
    are no-ops and the returned state is the one after the last ACTIVE
    frame.  ``emit_landmarks``: the outputs carry the per-frame landmark
    snapshot (``ScanOutputsLm``).  The outputs are views of the block's
    device buffer."""
    out_t = ScanOutputsLm if emit_landmarks else ScanOutputs
    packing = vo.outputs[emit_landmarks]

    def run(state: FrameState, images: torch.Tensor,
            generators: Sequence[torch.Generator],
            active: Optional[Sequence[bool]] = None):
        if masked == (active is None):
            raise ValueError("pass `active` exactly when masked=True")
        F = images.shape[0]
        rows = torch.empty((F, packing.nbytes), dtype=torch.uint8,
                           device=vo.device)
        for i in range(F):
            if not masked or active[i]:
                state = vo.step(state, images[i], generator=generators[i],
                                outputs=rows[i], landmarks=emit_landmarks)
            elif i:
                rows[i].copy_(rows[i - 1])
            else:
                packing.pack(rows[0], frame_outputs(state, emit_landmarks))
        return state, out_t(*packing.views(rows))

    return run


def run_block(vo: VisualOdometry, state: FrameState, images,
              generators: Sequence[torch.Generator]):
    """Process a stacked frame block on ``vo``'s device."""
    run = make_scan_step(vo)
    images = torch.as_tensor(np.asarray(images)).to(vo.device)
    return run(state, images, generators)


class StreamInfo(NamedTuple):
    recoveries: int
    lost: int  # total LOST frames across the returned outputs
    blocks: int


def run_streaming(vo: VisualOdometry, state: FrameState, frames, seed: int,
                  *, block: int = 64, emit_landmarks: bool = False,
                  recover: bool = False, recover_after: int = 2,
                  bootstrap_stride: int = 2, checkpoint_dir=None,
                  checkpoint_every_blocks: int = 0, verbose: bool = False):
    """Long-sequence streaming over fixed-size blocks on ``vo``'s device,
    the state carried across block boundaries.

    ``frames``: iterable of (frame_idx, image) pairs.  The upload dtype is
    chosen once per stream from the first frame: uint8 stays uint8 (4x fewer
    bytes to upload; the step casts on the device, exactly), anything else
    goes up as float32.  A later frame of another dtype is cast to the
    stream's float32, or raises on a uint8 stream.

    ``recover``: on a LOST streak of >= ``recover_after`` frames, re-bootstrap
    from the block's host-side images, transport the fresh state into the
    original world frame (``runner.reanchor_state``) and re-run the rest of
    the block with it.

    Returns (final_state, outputs over all frames as numpy, frame_ids,
    StreamInfo)."""
    dev = vo.device
    run = make_scan_step(vo, emit_landmarks=emit_landmarks, masked=True)
    out_t = ScanOutputsLm if emit_landmarks else ScanOutputs
    it = iter(frames)
    pending = []  # (idx, img) pushed back by recovery re-runs
    upload_dtype: List[np.dtype] = []

    def as_upload(img) -> np.ndarray:
        a = np.asarray(img)
        if not upload_dtype:
            upload_dtype.append(np.dtype(np.uint8) if a.dtype == np.uint8
                                else np.dtype(np.float32))
        dt = upload_dtype[0]
        if a.dtype != dt and dt == np.uint8:
            raise ValueError(f"a {a.dtype} frame in a uint8 stream")
        return a.astype(dt, copy=False)

    def next_block():
        ids, imgs = [], []
        while len(imgs) < block:
            if pending:
                idx, img = pending.pop(0)
            else:
                try:
                    idx, img = next(it)
                except StopIteration:
                    break
            ids.append(idx)
            imgs.append(as_upload(img))
        if not imgs:
            return None
        n = len(imgs)
        pad = block - n
        stacked = torch.from_numpy(np.stack(imgs + [imgs[-1]] * pad)).to(dev)
        active = [True] * n + [False] * pad
        gens = [frame_generator(seed, i, dev) for i in ids] + [None] * pad
        return ids, imgs, (stacked, gens, active), n

    def old_map_points(j):
        """World-frame landmark map of the last TRACKING frame before block
        index ``j``, rebuilt from the per-frame snapshot (uv + camera depth
        + pose); the snapshot carried from a previous block when the whole
        streak precedes this block."""
        snap = last_good_lm[0]
        for i in range(j - 1, -1, -1):
            if outs_np.status[i] == STATUS_TRACKING:
                snap = (outs_np.lm_uv[i], outs_np.lm_z[i],
                        outs_np.lm_valid[i], outs_np.T_CW[i])
                break
        if snap is None:
            return None
        uv, z, valid, T = snap
        if not np.any(valid):
            return None
        uv = np.asarray(uv, np.float64)[valid]
        z = np.asarray(z, np.float64)[valid]
        fx, fy = float(vo.cam.fx), float(vo.cam.fy)
        cx, cy = float(vo.cam.cx), float(vo.cam.cy)
        x_cam = np.stack([(uv[:, 0] - cx) / fx * z,
                          (uv[:, 1] - cy) / fy * z, z], axis=1)
        T = np.asarray(T, np.float64)
        return (x_cam - T[:3, 3]) @ T[:3, :3]  # R^T (x - t), row-vector

    def try_recover(ids, imgs, statuses, n):
        """Find the first LOST-streak trigger in this block and try a
        re-bootstrap at a few positions after it.  Returns (e, new_state),
        the last output index to keep and the recovered state, or None."""
        streak = streak_in
        j = None
        for i in range(n):
            streak = streak + 1 if statuses[i] != STATUS_TRACKING else 0
            if streak >= recover_after:
                j = i
                break
        if j is None:
            return None
        s = bootstrap_stride
        # First candidate: a re-bootstrap ENDING AT the trigger frame (on
        # content-driven loss the preceding images are good); on a blackout
        # it fails its status gate and the later candidates run.
        cands = [j] if j - s >= 0 else []
        cands += sorted({min(j + d, n - 1) for d in (s + 1, s + 4, s + 10)}
                        | {n - 1})
        for e in cands:
            if e - s < 0:
                continue
            span = imgs[e - s:e + 1]
            if len(span) < s + 1:
                continue
            fresh = vo.bootstrap(
                span[0], span[-1], intermediate=span[1:-1],
                generator=frame_generator(seed, REBOOT_STREAM + ids[e], dev))
            if int(fresh.status) != STATUS_TRACKING:
                continue
            # Anchor = the pose held through the LOST frames.
            anchor = np.asarray(outs_np.T_CW[max(e - s, 0)])
            scale = None
            src = "map"
            if emit_landmarks:
                X_old = old_map_points(j)
                if X_old is not None:
                    scale = map_scale_from_points(X_old, fresh, vo.cam,
                                                  anchor)
            if scale is None:
                src = "velocity-prior"
                # Include this block's pre-trigger frames.
                hist = pose_hist + [(int(statuses[i]), outs_np.T_CW[i])
                                    for i in range(j)]
                step_len = median_step_len(
                    [(st, -T[:3, :3].T @ T[:3, 3]) for st, T in hist])
                scale = step_len * s if step_len else 1.0
            new_state = reanchor_state(fresh, anchor, scale)
            if verbose:
                print(f"stream: re-bootstrapped at frame {ids[e]} "
                      f"(scale {scale:.3f}, {src})")
            return e, new_state
        return None

    outs_all = []
    frame_ids = []
    pose_hist = []  # (status, T_CW) of recent emitted frames
    last_good_lm = [None]  # snapshot of the last emitted TRACKING frame
    streak_in = 0
    recoveries = 0
    blocks = 0
    nxt = next_block()
    while nxt is not None:
        ids, imgs, dev_in, n = nxt
        new_state, outs = run(state, *dev_in)
        # Stack and upload the next block while the device works (not on
        # the recovery path: the block may need a re-run).
        nxt_pref = next_block() if not recover else None
        outs_np = out_t(*(o.cpu().numpy() for o in outs))
        statuses = outs_np.status

        keep = n
        state = new_state
        if recover:
            rec = try_recover(ids, imgs, statuses, n)
            if rec is not None:
                e, state = rec
                keep = e + 1
                # Re-run the rest of the block with the recovered state.
                pending[:0] = list(zip(ids[keep:n], imgs[keep:n]))
                recoveries += 1

        outs_all.append(out_t(*(o[:keep] for o in outs_np)))
        frame_ids.extend(ids[:keep])
        if emit_landmarks:
            for i in range(keep - 1, -1, -1):
                if statuses[i] == STATUS_TRACKING:
                    last_good_lm[0] = (outs_np.lm_uv[i], outs_np.lm_z[i],
                                       outs_np.lm_valid[i], outs_np.T_CW[i])
                    break
        for i in range(keep):
            pose_hist.append((int(statuses[i]), outs_np.T_CW[i]))
        del pose_hist[:-12]
        # LOST streak carried into the next block's trigger scan.
        streak_in = 0
        for st_i, _ in pose_hist:
            streak_in = streak_in + 1 if st_i != STATUS_TRACKING else 0
        blocks += 1
        if (checkpoint_dir and checkpoint_every_blocks
                and blocks % checkpoint_every_blocks == 0):
            from . import checkpoint

            checkpoint.save(checkpoint_dir, state, frame_ids[-1])
        nxt = nxt_pref if nxt_pref is not None else next_block()

    merged = out_t(*(np.concatenate([getattr(o, f) for o in outs_all])
                     for f in out_t._fields))
    lost = int(np.sum(merged.status != STATUS_TRACKING))
    return state, merged, frame_ids, StreamInfo(recoveries, lost, blocks)
