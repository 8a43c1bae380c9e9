"""Block-wise sequence processing (port of ``pipeline/scan_driver.py``).

The reference compiles the step once and iterates it on the device with
``lax.scan``.  The port's counterpart: ``make_scan_step`` returns a callable
that runs a block's active frames in chunks of K (``vo.chunk_frames``:
``ba.every``, or ``vo.CHUNK`` with the in-step BA off), each chunk one
call of ``VisualOdometry.step_chunk`` (on the card one replay of the
chunk's CUDA graph, keyed by the BA frames among its K), and the frames
that fill no chunk (a block's tail, a short block, the frames before the
ring fills) one ``step`` each.  The host plans the chunks (``plan_chunks``: the activity mask and the BA cadence are host
data), draws every frame's RANSAC bank before the block runs, copies a
chunk's images and draws in with one copy each and its outputs out with
one, and reads nothing back inside the block.  A masked frame is not
stepped; its outputs repeat the previous frame's.  Each frame's outputs
(``frame_outputs``, with the landmark snapshot where ``emit_landmarks`` asks
for it) are written into one preallocated device buffer for the block and
come back to the host once per block.  On the CPU the same chunks run
their body eagerly.

``run_streaming`` is the long-sequence path:
  * fixed-size blocks (their frames in pinned host memory on the card, each
    chunk's copied to the device on the way in), the padded tail masked
    (inactive steps are identity), so the returned state is exactly the
    state after the last real frame;
  * re-bootstrap recovery from tracking loss, re-running the rest of the
    block with the recovered state;
  * optional per-frame landmark snapshots (``emit_landmarks``), which feed
    the map-based recovery scale;
  * optional checkpoints at block boundaries.

Random draws come from ``runner.frame_generator(seed, stream)``: frame
``idx`` from stream ``idx``, a re-bootstrap ending at frame ``idx`` from
``10_000_000 + idx``, as in ``pipeline/runner.py``; a block's banks are
drawn when the block is stacked, before any of its frames runs.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core import spans
from ..core.state import STATUS_TRACKING, FrameState
from .runner import (REBOOT_STREAM, frame_generator, map_scale_from_points,
                     median_step_len, reanchor_state)
from .vo import VisualOdometry, ba_trigger, frame_outputs


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


class Stretch(NamedTuple):
    """One entry of a block's plan (``plan_chunks``): the frames from
    ``start``, ``len(flags)`` of them, and whether each runs the in-step
    BA; ``flags`` is None for an inactive frame.  ``chunk``: one call of
    ``step_chunk``, else one ``step``."""

    start: int
    flags: Optional[tuple]
    chunk: bool


def plan_chunks(host_frame: int, active: Sequence[bool], K: int, every: int,
                window: int) -> List[Stretch]:
    """The plan of a block whose first frame follows the state at
    ``host_frame``: each run of K active frames, from the block's start on,
    one chunk; an active frame that fills no chunk one step; an inactive
    frame a stretch of its own.  The BA flags follow the cadence frame by
    frame (``ba_trigger``).  With the BA on, a run whose K frames hold no
    BA frame (the ring not yet full) is stepped frame by frame: every chunk
    then holds the one BA frame of its K, at the same place while the phase
    holds, so a stream replays one chunk graph.  ``K == 0`` makes no
    chunks."""
    plan, i = [], 0
    while i < len(active):
        if not active[i]:
            plan.append(Stretch(i, None, False))
            i += 1
            continue
        chunk = bool(K) and i + K <= len(active) and all(active[i:i + K])
        n = K if chunk else 1
        flags = tuple(ba_trigger(host_frame + 1 + k, every, window)
                      for k in range(n))
        if chunk and (any(flags) or not every):
            plan.append(Stretch(i, flags, True))
        else:
            plan.extend(Stretch(i + k, (f,), False)
                        for k, f in enumerate(flags))
        host_frame += n
        i += n
    return plan


def frame_draws(vo: VisualOdometry, generators, active) -> list:
    """Each active frame's RANSAC bank (``vo.step_draws``) in frame order,
    None for an inactive one."""
    return [vo.step_draws(g) if a else None
            for g, a in zip(generators, active)]


def _scan(vo: VisualOdometry, state: FrameState, images: torch.Tensor,
          draws: Sequence, active: Sequence[bool], landmarks: bool):
    """The block by its plan: (the state after its last active frame, the
    (F, nbytes) device buffer of its frames' packed outputs)."""
    packing = vo.outputs[landmarks]
    K = vo.chunk_frames
    rows = torch.empty((images.shape[0], packing.nbytes), dtype=torch.uint8,
                       device=vo.device)
    ba = vo.config.ba
    for st in plan_chunks(state.host_frame_idx(), active, K, ba.every,
                          ba.window):
        i = st.start
        if st.chunk:
            state = vo.step_chunk(state, images[i:i + K], draws[i:i + K],
                                  outputs=rows[i:i + K], landmarks=landmarks)
        elif st.flags is not None:
            state = vo.step(state, images[i], draws=draws[i],
                            outputs=rows[i], landmarks=landmarks)
        elif i:
            rows[i].copy_(rows[i - 1])
        else:
            packing.pack(rows[0], frame_outputs(state, landmarks))
    return state, rows


def make_scan_step(vo: VisualOdometry, *, emit_landmarks: bool = False,
                   masked: bool = False):
    """Returns ``run(state, images (F, H, W), generators (F,)[, active
    (F,)]) -> (state, outputs)``.

    ``masked``: ``active`` is a host sequence of bools; an inactive frame
    passes the state through unchanged (identity), so padded tail frames
    are no-ops and the returned state is the one after the last ACTIVE
    frame.  ``emit_landmarks``: the outputs carry the per-frame landmark
    snapshot (``ScanOutputsLm``).  Each active frame's generator draws its
    bank, in frame order, before the first step.  The outputs are views of
    the block's device buffer."""
    out_t = ScanOutputsLm if emit_landmarks else ScanOutputs
    packing = vo.outputs[emit_landmarks]

    def run(state: FrameState, images: torch.Tensor,
            generators: Sequence[torch.Generator],
            active: Optional[Sequence[bool]] = None):
        if masked == (active is None):
            raise ValueError("pass `active` exactly when masked=True")
        active = [True] * images.shape[0] if active is None else active
        draws = frame_draws(vo, generators, active)
        state, rows = _scan(vo, state, images, draws, active, emit_landmarks)
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
    out_t = ScanOutputsLm if emit_landmarks else ScanOutputs
    packing = vo.outputs[emit_landmarks]
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
        with spans.span("stream.stack"):
            return stack_block()

    def stack_block():
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
        full = imgs + [imgs[-1]] * pad
        if dev.type == "cuda":
            # Pinned: each chunk's frames go up asynchronously.
            stacked = torch.empty((block,) + full[0].shape,
                                  dtype=torch.from_numpy(full[0]).dtype,
                                  pin_memory=True)
            np.stack(full, out=stacked.numpy())
        else:
            stacked = torch.from_numpy(np.stack(full))
        active = [True] * n + [False] * pad
        gens = [frame_generator(seed, i, dev) for i in ids] + [None] * pad
        return ids, imgs, (stacked, frame_draws(vo, gens, active),
                           active), n

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
            spans.COUNTS["recover.attempts"] += 1
            fresh = vo.bootstrap(
                span[0], span[-1], intermediate=span[1:-1],
                generator=frame_generator(seed, REBOOT_STREAM + ids[e], dev))
            if dev.type == "cuda":
                spans.d2h(fresh.status.nbytes)
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
        with spans.span("stream.block", block=blocks, frames=nxt[3]):
            ids, imgs, block_in, n = nxt
            new_state, rows = _scan(vo, state, *block_in, emit_landmarks)
            # Stack the next block and draw its banks while the device
            # works (not on the recovery path: the block may need a re-run).
            nxt_pref = next_block() if not recover else None
            with spans.span("stream.readback"):
                if dev.type == "cuda":
                    spans.d2h(rows.nbytes)
                outs_np = out_t(*(v.numpy()
                                  for v in packing.views(rows.cpu())))
            statuses = outs_np.status

            keep = n
            state = new_state
            if recover:
                with spans.span("stream.recover"):
                    rec = try_recover(ids, imgs, statuses, n)
                if rec is not None:
                    e, state = rec
                    keep = e + 1
                    # Re-run the rest of the block with the recovered state.
                    pending[:0] = list(zip(ids[keep:n], imgs[keep:n]))
                    recoveries += 1
                    spans.COUNTS["recover.done"] += 1

            outs_all.append(out_t(*(o[:keep] for o in outs_np)))
            frame_ids.extend(ids[:keep])
            if emit_landmarks:
                for i in range(keep - 1, -1, -1):
                    if statuses[i] == STATUS_TRACKING:
                        last_good_lm[0] = (outs_np.lm_uv[i], outs_np.lm_z[i],
                                           outs_np.lm_valid[i],
                                           outs_np.T_CW[i])
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
