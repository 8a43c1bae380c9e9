"""Keyframe bank, loop-closure detection and trajectory refinement (port of
``pipeline/posegraph_runner.py``).

The runner (or :func:`bank_from_stream` after a streamed run) collects
keyframes: pose, SIFT features and a snapshot of the VO map.  Loop
candidates come from one K x K product of pooled global descriptors; each
candidate pair is verified on the device (descriptor match, 5-point
essential RANSAC, cheirality pose, unit-baseline triangulation); the
verified loop edges and the odometry chain form a Sim(3) (default) or SE(3)
pose graph, whose corrections every frame then rides along with.

Departures from the reference, by design:
  * RANSAC banks come from ``sampler(generator, valid, iterations, 5)``, as
    in ``VisualOdometry``; :func:`detect_loops` calls it once per candidate
    pair in pair order (the reference's draw for pair k is
    ``fold_in(PRNGKey(seed), k)``).
  * A chunk of 8 pairs is verified in one batched call, as the reference's
    ``jax.jit(jax.vmap(...))`` of its verifier (``verify_chunk``): the
    matching takes the chunk as its leading axis, and the bank's selection,
    the essential RANSAC, pose and triangulation run under
    ``torch.func.vmap`` (``verify_geometry``); on a CUDA device the chunk
    replays a graph, with one copy to the host per chunk.  Each pair's
    bank is drawn before the call, in pair order (its uniforms, from the
    sampler's ``draw``).
  * Keyframe SIFT replays the VO's SIFT graph on a CUDA device
    (``VisualOdometry.sift_features``).
  * :func:`bank_to_arrays` / :func:`bank_from_arrays` carry a bank as the
    arrays of the reference's checkpoint (``kf_*``, ``bank_*``).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..backend import posegraph, posegraph_sim3
from ..core import graphs, linalg
from ..ops import essential, match, ransac, triangulate


@dataclasses.dataclass
class Keyframe:
    record_idx: int  # index into RunResult.records
    frame: int  # dataset frame index
    T_CW: np.ndarray  # (4, 4)
    uv: np.ndarray  # (F, 2) SIFT keypoints
    desc: np.ndarray  # (F, 128)
    valid: np.ndarray  # (F,)
    # VO-map snapshot for the loop-closure scale estimate: pixel positions
    # and camera-frame depths of the valid landmarks, in the odometry's
    # current scale.
    lm_uv: np.ndarray = None  # (L, 2)
    lm_z: np.ndarray = None  # (L,)
    med_depth: float = 0.0  # median of lm_z
    # Pooled global descriptor: the L2-normalized sum of the frame's
    # L2-normalized SIFT descriptors (a 1-cluster VLAD).
    gdesc: np.ndarray = None  # (128,)


def _global_desc(desc: np.ndarray, valid: np.ndarray) -> np.ndarray:
    d = np.asarray(desc, np.float32)
    n = np.linalg.norm(d, axis=1, keepdims=True)
    d = np.where(n > 1e-9, d / np.maximum(n, 1e-9), 0.0)
    g = (d * np.asarray(valid, np.float32)[:, None]).sum(0)
    return (g / max(np.linalg.norm(g), 1e-9)).astype(np.float32)


class KeyframeBank:
    """Collects keyframes during a run (pose + SIFT features on ``vo``'s
    device)."""

    def __init__(self, vo, every: int = 8, max_features: int = 512):
        self.vo = vo
        self.every = every
        self.max_features = max_features
        self.keyframes: List[Keyframe] = []

    def _features(self, image):
        # On a CUDA device a replay of the VO's SIFT graph, read back in one
        # copy (``VisualOdometry.sift_features``).
        f = self.vo.sift_features(image, self.max_features, host=True)
        return f.uv.numpy(), f.desc.numpy(), f.valid.numpy()

    def add_keyframe(self, record_idx: int, frame: int, T_CW, image,
                     lm_uv, lm_z) -> None:
        uv, desc, valid = self._features(image)
        lm_uv = np.asarray(lm_uv)
        z = np.asarray(lm_z)
        good = (np.isfinite(z) & (z > 0)
                & np.all(np.isfinite(lm_uv), axis=1))
        lm_uv, z = lm_uv[good], z[good]
        self.keyframes.append(Keyframe(
            record_idx=record_idx, frame=frame,
            T_CW=np.asarray(T_CW, np.float32).copy(),
            uv=uv, desc=desc, valid=valid, lm_uv=lm_uv, lm_z=z,
            med_depth=float(np.median(z)) if z.size else 0.0,
            gdesc=_global_desc(desc, valid)))

    def maybe_add(self, record_idx: int, frame: int, state, image) -> None:
        if int(state.status) != 0 or frame % self.every != 0:
            return
        T_CW = state.T_CW.cpu().numpy()
        lv = state.lm_valid.cpu().numpy()
        lm = state.lm_xyz.cpu().numpy()[lv]
        z = (lm @ T_CW[:3, :3].T + T_CW[:3, 3])[:, 2]
        self.add_keyframe(record_idx, frame, T_CW, image,
                          state.lm_uv.cpu().numpy()[lv], z)


def bank_to_arrays(bank: KeyframeBank) -> Dict[str, np.ndarray]:
    """A bank of at least one keyframe as the arrays of the reference's
    checkpoint: ``bank_every``, ``bank_max_features`` and ``kf_*`` (the
    landmark snapshots padded to the longest, their lengths in
    ``kf_lm_n``)."""
    kfs = bank.keyframes
    Lmax = max([1] + [len(k.lm_z) for k in kfs])
    lm_uv = np.zeros((len(kfs), Lmax, 2), np.float32)
    lm_z = np.zeros((len(kfs), Lmax), np.float32)
    for i, k in enumerate(kfs):
        lm_uv[i, :len(k.lm_z)] = k.lm_uv
        lm_z[i, :len(k.lm_z)] = k.lm_z
    return dict(
        bank_every=np.int64(bank.every),
        bank_max_features=np.int64(bank.max_features),
        kf_record_idx=np.array([k.record_idx for k in kfs], np.int64),
        kf_frame=np.array([k.frame for k in kfs], np.int64),
        kf_T_CW=np.stack([k.T_CW for k in kfs]).astype(np.float32),
        kf_uv=np.stack([k.uv for k in kfs]),
        kf_desc=np.stack([k.desc for k in kfs]),
        kf_valid=np.stack([k.valid for k in kfs]),
        kf_lm_uv=lm_uv, kf_lm_z=lm_z,
        kf_lm_n=np.array([len(k.lm_z) for k in kfs], np.int64),
        kf_gdesc=np.stack([k.gdesc for k in kfs]))


def bank_from_arrays(vo, **arrays) -> KeyframeBank:
    """A bank from the arrays of :func:`bank_to_arrays` (or of the
    reference's checkpoint ``aux.npz``)."""
    z = {k: np.asarray(v) for k, v in arrays.items()}
    bank = KeyframeBank(vo, every=int(z["bank_every"]),
                        max_features=int(z["bank_max_features"]))
    for i in range(len(z["kf_frame"])):
        n = int(z["kf_lm_n"][i])
        bank.keyframes.append(Keyframe(
            record_idx=int(z["kf_record_idx"][i]), frame=int(z["kf_frame"][i]),
            T_CW=z["kf_T_CW"][i], uv=z["kf_uv"][i], desc=z["kf_desc"][i],
            valid=z["kf_valid"][i], lm_uv=z["kf_lm_uv"][i, :n],
            lm_z=z["kf_lm_z"][i, :n],
            med_depth=float(np.median(z["kf_lm_z"][i, :n])) if n else 0.0,
            gdesc=z["kf_gdesc"][i]))
    return bank


def bank_from_stream(vo, outs, frame_ids, images: Dict[int, np.ndarray],
                     *, every: int = 8,
                     max_features: int = 512) -> KeyframeBank:
    """A KeyframeBank from ``scan_driver.run_streaming(...,
    emit_landmarks=True)`` outputs; ``images``: the keyframe images kept on
    the host by the caller (:func:`keep_every`), keyed by frame index."""
    bank = KeyframeBank(vo, every=every, max_features=max_features)
    status = np.asarray(outs.status)
    for local, fid in enumerate(frame_ids):
        if fid % every != 0 or int(status[local]) != 0 or fid not in images:
            continue
        lv = np.asarray(outs.lm_valid[local])
        bank.add_keyframe(local, fid, np.asarray(outs.T_CW[local]),
                          images[fid], np.asarray(outs.lm_uv[local])[lv],
                          np.asarray(outs.lm_z[local])[lv])
    return bank


def keep_every(frames, every: int, store: Dict[int, np.ndarray]):
    """Tee an (idx, image) stream, keeping every ``every``-th frame in
    ``store`` for later keyframe processing."""
    for idx, img in frames:
        if idx % every == 0:
            store[idx] = np.asarray(img)
        yield idx, img


def _metric_baseline(kf: Keyframe, uv_feat: np.ndarray, z_tri: np.ndarray,
                     sel: np.ndarray, *, max_px: float = 5.0,
                     min_assoc: int = 6) -> Optional[float]:
    """|t| of the loop pair in ``kf``'s local odometry scale: the median of
    z_vo / z_tri over loop matches associated (by pixel distance) with the
    keyframe's VO landmarks; None when too few associate or the ratios
    spread (inter-quartile range above the median)."""
    if kf.lm_uv is None or len(kf.lm_uv) == 0 or not sel.any():
        return None
    uv = uv_feat[sel]
    d2 = ((uv[:, None, :] - kf.lm_uv[None, :, :]) ** 2).sum(-1)
    nn = d2.argmin(1)
    ok = d2[np.arange(len(nn)), nn] < max_px ** 2
    zt = z_tri[sel][ok]
    zv = kf.lm_z[nn[ok]]
    good = np.isfinite(zt) & (zt > 1e-9)
    if good.sum() < min_assoc:
        return None
    r = zv[good] / zt[good]
    med = float(np.median(r))
    iqr = float(np.percentile(r, 75) - np.percentile(r, 25))
    if med <= 0 or iqr > med:
        return None
    return med


def retrieve_candidates(bank: KeyframeBank, *, min_gap_frames: int = 30,
                        topk: int = 3, min_sim: float = 0.5):
    """The top-k admissible partners of every keyframe by pooled-descriptor
    similarity (one K x K product).  Returns sorted (a, b) pairs, a < b."""
    kfs = bank.keyframes
    K = len(kfs)
    if K < 2:
        return []
    G = np.stack([k.gdesc for k in kfs])
    S = G @ G.T
    frames = np.array([k.frame for k in kfs])
    gap_ok = np.abs(frames[:, None] - frames[None, :]) >= min_gap_frames
    S = np.where(gap_ok, S, -np.inf)
    pairs = set()
    k = min(topk, K - 1)
    top = np.argpartition(-S, k - 1, axis=1)[:, :k]
    for b in range(K):
        for a in top[b]:
            if np.isfinite(S[b, a]) and S[b, a] >= min_sim:
                pairs.add((min(int(a), b), max(int(a), b)))
    return sorted(pairs)


VERIFY_CHUNK = 8


def verify_geometry(cam, u0, u1m, mok, idx, samp_ok, *,
                    threshold_px: float):
    """One pair's geometry: 5-point essential RANSAC over the bank ``(idx,
    samp_ok)`` on the matches ``(u0, u1m)`` flagged ``mok``, the cheirality
    pose and the unit-baseline DLT depths in both views.  It runs alone or
    under ``torch.func.vmap`` over a chunk of pairs, with the same result
    for each pair.  Returns (inl, ok, R, t, votes, z_i, z_j, n_match,
    n_inl)."""
    E, inl, ok = essential.find_essential_ransac(
        cam, u0, u1m, mok, idx, samp_ok, threshold_px=threshold_px,
        solver="5point")
    R, t, votes = essential.recover_pose(E, cam, u0, u1m, inl)
    n = u0.shape[0]
    Kmat = cam.matrix(u0.device)
    P0 = linalg.matmul(Kmat, torch.eye(3, 4, device=u0.device))
    P1 = linalg.matmul(Kmat, torch.cat([R, t[:, None]], 1))
    X = triangulate.triangulate_dlt(P0.expand(n, 3, 4), P1.expand(n, 3, 4),
                                    u0, u1m)
    return (inl, ok, R, t, votes, X[:, 2], linalg.matmul(X, R[2]) + t[2],
            mok.sum(), inl.sum())


def verify_chunk(cam, u0, u1, desc0, valid0, desc1, valid1, draws, *,
                 ratio: float, threshold_px: float, select):
    """One chunk of keyframe pairs stacked on a leading axis: ratio-test
    matching over the chunk, each pair's bank ``select``-ed from its draw
    (``draws`` (chunk, iterations, 5) uniforms) onto its matches, then
    ``verify_geometry`` under ``torch.func.vmap``.  Nothing in it reads the
    device on the host but the library calls that wait on it (captured
    around, ``pipeline/vo.py``).  Returns (idx1, inl, ok, R, t, votes,
    z_i, z_j, n_match, n_inl), each with the chunk's leading axis."""
    idx1, mok, u1m = _chunk_matches(u1, desc0, valid0, desc1, valid1, ratio)
    idx, samp_ok = torch.func.vmap(select)(draws, mok)
    return _chunk_geometry(cam, u0, u1m, mok, idx, samp_ok, idx1,
                           threshold_px)


def _chunk_matches(u1, desc0, valid0, desc1, valid1, ratio):
    """A chunk's ratio matches and the second views' matched points."""
    idx1, mok = match.match_ratio(desc0, valid0, desc1, valid1, ratio=ratio)
    return idx1, mok, torch.gather(u1, 1, idx1[..., None].expand(-1, -1, 2))


def _chunk_geometry(cam, u0, u1m, mok, idx, samp_ok, idx1, threshold_px):
    """``verify_geometry`` of every pair of a chunk on its bank, under
    ``torch.func.vmap``, after the matches ``idx1``."""
    return (idx1, *torch.func.vmap(functools.partial(
        verify_geometry, cam, threshold_px=threshold_px))(
            u0, u1m, mok, idx, samp_ok))


def verify_pairs(vo, cam, pairs, kfs, *, ransac_iters: int,
                 threshold_px: float, sampler, generator):
    """Geometric verification of keyframe pairs, a chunk of
    ``VERIFY_CHUNK`` at a time, each chunk one batched call
    (``verify_chunk``), on a CUDA device the replay of its graph
    (``VisualOdometry.graphed``), read back in one copy.  The last chunk is
    padded by repeating its last pair (and draw), and the padded results
    dropped.  The banks' uniforms are drawn pair by pair, in pair order,
    before the chunk's call, with the sampler's ``draw``; a sampler without
    one is called pair by pair on each pair's matches, and its chunk runs
    op by op.  Returns, per pair, the host arrays (idx1, inl, ok, R, t,
    votes, z_i, z_j, n_match, n_inl)."""
    dev = vo.device
    ratio = vo.config.sift.ratio
    draw = getattr(sampler, "draw", None)
    select = getattr(sampler, "select", ransac.select_minimal_sets)
    out = []
    for c0 in range(0, len(pairs), VERIFY_CHUNK):
        chunk = pairs[c0:c0 + VERIFY_CHUNK]
        padded = chunk + [chunk[-1]] * (VERIFY_CHUNK - len(chunk))
        inputs = chunk_inputs(kfs, padded, dev)
        if draw is not None:
            draws = [draw(generator, ransac_iters, 5) for _ in chunk]
            draws += draws[-1:] * (VERIFY_CHUNK - len(chunk))
            host = [a.numpy() for a in verify_chunk_replayed(
                vo, cam, inputs, torch.stack(draws),
                threshold_px=threshold_px, select=select)]
        else:
            host = [a.cpu().numpy()
                    for a in _verify_chunk_sampled(cam, inputs, len(chunk),
                                                   ransac_iters, ratio,
                                                   threshold_px, sampler,
                                                   generator)]
        out.extend(tuple(a[ci] for a in host) for ci in range(len(chunk)))
    return out


def chunk_inputs(kfs, pairs, device):
    """The keyframes of ``pairs`` stacked for ``verify_chunk`` on
    ``device``: (u0, u1, desc0, valid0, desc1, valid1)."""
    def stack(name, side):
        return torch.from_numpy(np.stack(
            [getattr(kfs[p[side]], name) for p in pairs])).to(device)

    return (stack("uv", 0), stack("uv", 1), stack("desc", 0),
            stack("valid", 0), stack("desc", 1), stack("valid", 1))


def verify_chunk_replayed(vo, cam, inputs, draws, *, threshold_px: float,
                          select=ransac.select_minimal_sets):
    """``verify_chunk`` of ``chunk_inputs`` and ``draws`` through
    ``vo.graphed`` (a graph per camera, ratio, threshold and selection on a
    CUDA device), its outputs on the host."""
    ratio = vo.config.sift.ratio
    return vo.graphed(("verify", cam, ratio, threshold_px, select),
                      functools.partial(verify_chunk, cam, ratio=ratio,
                                        threshold_px=threshold_px,
                                        select=select),
                      *inputs, draws, host=True)


def _verify_chunk_sampled(cam, inputs, n, ransac_iters, ratio, threshold_px,
                          sampler, generator):
    """``verify_chunk`` for a sampler without ``draw``: called pair by pair
    on each pair's matches (the chunk's first ``n`` pairs, the padding
    repeating the last bank)."""
    u0, u1, desc0, valid0, desc1, valid1 = inputs
    idx1, mok, u1m = _chunk_matches(u1, desc0, valid0, desc1, valid1, ratio)
    banks = [sampler(generator, mok[ci], ransac_iters, 5) for ci in range(n)]
    banks += banks[-1:] * (VERIFY_CHUNK - n)
    return _chunk_geometry(cam, u0, u1m, mok,
                           torch.stack([b[0] for b in banks]),
                           torch.stack([b[1] for b in banks]), idx1,
                           threshold_px)


def detect_loops(bank: KeyframeBank, cam=None, *, min_gap_frames: int = 30,
                 min_matches: int = 50, min_inliers: int = 30,
                 ransac_iters: int = 300, seed: int = 0,
                 mode: str = "retrieval", topk: int = 3,
                 min_depth_ratio: float = 3.0, sampler=None,
                 generator: Optional[torch.Generator] = None,
                 trace: Optional[dict] = None):
    """Find and verify loop-closure keyframe pairs.

    ``mode="retrieval"``: global-descriptor top-k candidates;
    ``"exhaustive"``: every admissible pair.  ``sampler``: draws the RANSAC
    banks (the VO's when None); ``generator``: the generator it is given,
    one seeded from ``seed`` on the VO's device when None.  ``cam``: the
    VO's camera when None.  ``trace``: a dict that receives the
    verifier's outputs per pair (``"verified"``), the loops returned
    (``"loops"``) and the seconds of the retrieval and of the verification
    (``"retrieval_s"``, ``"verification_s"``).

    Returns [(i_kf, j_kf, R, t_dir, n_inl, t_i, t_j)]: t_i / t_j are the
    loop baseline measured in keyframe i's / j's local odometry scale
    (:func:`_metric_baseline`; None when unobservable)."""
    vo = bank.vo
    kfs = bank.keyframes
    lap = posegraph.Laps(vo.device, trace)
    if mode == "retrieval":
        pairs = retrieve_candidates(bank, min_gap_frames=min_gap_frames,
                                    topk=topk)
    else:
        pairs = [(a, b) for a in range(len(kfs))
                 for b in range(a + 1, len(kfs))
                 if kfs[b].frame - kfs[a].frame >= min_gap_frames]
    lap("retrieval_s")
    if not pairs:
        return []
    if generator is None:
        generator = torch.Generator(device=vo.device)
        generator.manual_seed(seed)
    verified = verify_pairs(vo, cam if cam is not None else vo.cam, pairs,
                            kfs, ransac_iters=ransac_iters,
                            threshold_px=1.5,
                            sampler=sampler or vo.sampler,
                            generator=generator)
    loops = []
    if trace is not None:
        trace.update(verified=verified, loops=loops)
    for (a, b), res in zip(pairs, verified):
        idx1, inl, ok, R, t, votes, z_i, z_j, n_match, n_inl = res
        if (int(n_match) < min_matches or not bool(ok)
                or int(n_inl) < min_inliers or int(votes) < min_inliers // 2):
            continue
        m = (inl & np.isfinite(z_i) & np.isfinite(z_j) & (z_i > 0)
             & (z_j > 0))
        if m.sum() < min_inliers // 2:
            continue
        # Revisit gate: z is depth in units of the pair's baseline, so a
        # true revisit (small parallax) has a large median z; wide-baseline
        # co-observation along an arc does not.
        if float(np.median(z_i[m])) < min_depth_ratio:
            continue
        t_i = _metric_baseline(kfs[a], kfs[a].uv, z_i, m)
        t_j = _metric_baseline(kfs[b], kfs[b].uv[idx1], z_j, m)
        loops.append((a, b, R, t, int(n_inl), t_i, t_j))
    lap("verification_s")
    return loops


def refine_trajectory(records, bank: KeyframeBank, cam=None, *,
                      loop_weight: float = 3.0, iters: int = 15,
                      min_gap_frames: int = 30, min_matches: int = 40,
                      min_inliers: int = 25, method: str = "sim3",
                      mode: str = "retrieval", robust_delta: float = 0.5,
                      min_loop_edges: int = 2, verbose: bool = False,
                      sampler=None,
                      generator: Optional[torch.Generator] = None,
                      trace: Optional[dict] = None
                      ) -> Optional[np.ndarray]:
    """Build the pose graph (odometry chain + verified loop edges) on the
    VO's device, optimize it, and return corrected (len(records), 3)
    positions, or None if no keyframes or loops make a graph worthwhile.

    ``records``: anything with ``.T_WC`` per frame.  ``method="sim3"``:
    loop edges carry the relative scale measured from both keyframes' maps,
    Huber-robust solve with leave-one-out pruning; ``"se3"``: loop edges
    borrow |t| from the current estimate.  Non-keyframe poses ride along
    with their preceding keyframe's correction (rescaled by the node's scale
    on Sim(3)).  ``trace``: as :func:`detect_loops`'s, and the seconds of
    each later stage, each ended by a device sync: building the graph
    (``"graph_s"``), the solves with their nodes read back (``"solve_s"``;
    within it the first solve, the leave-one-out solves and the final
    solve, ``"solve_first_s"``, ``"solve_loo_s"``, ``"solve_final_s"``, and
    ``"suspects"``: ``optimize_consistent``'s; on SE(3) the one solve is
    the first), the graphs captured, their seconds (part of the first
    solve's) and the replays made by the solves (``"captures"``,
    ``"capture_s"``, ``"replays"``; 0 off a CUDA device), and the records'
    recomposition (``"recompose_s"``)."""
    kfs = bank.keyframes
    if len(kfs) < 3:
        return None
    loops = detect_loops(bank, cam, min_gap_frames=min_gap_frames,
                         min_matches=min_matches, min_inliers=min_inliers,
                         mode=mode, sampler=sampler, generator=generator,
                         trace=trace)
    if verbose:
        print(f"posegraph[{method}]: {len(kfs)} keyframes, "
              f"{len(loops)} loop edges")
    if not loops:
        return None
    dev = bank.vo.device
    lap = posegraph.Laps(dev, trace)
    T_nodes = torch.from_numpy(np.stack([k.T_CW for k in kfs]).astype(
        np.float32)).to(dev)

    if method == "sim3":
        graph = posegraph_sim3.from_se3_chain(T_nodes)
        n_edges = 0
        for (a, b, R, t_dir, _, t_a, t_b) in loops:
            # The metric baseline must be measurable from BOTH keyframes'
            # maps: a true revisit re-sees the same near structure.
            if t_a is None or t_b is None:
                continue
            graph = posegraph_sim3.add_loop_edge(
                graph, a, b, R, t_dir * t_a, t_b / max(t_a, 1e-9),
                weight=loop_weight)
            n_edges += 1
        # Quorum: a single loop edge cannot be checked against another.
        if n_edges < min_loop_edges:
            return None
        lap("graph_s")
        held = _GraphCounts(dev)
        out, _, dropped = posegraph_sim3.optimize_consistent(
            graph, n_odo=len(kfs) - 1, iters=iters,
            robust_delta=robust_delta, verbose=verbose, trace=trace)
        if dropped.all():
            return None
        T_new = posegraph_sim3.corrected_poses(out).cpu().numpy()
        S = out.S_CW.cpu().numpy()
        node_scale = np.asarray([
            float(np.linalg.det(S[n, :3, :3])) ** (1 / 3)
            for n in range(len(kfs))])
    else:
        graph = posegraph.odometry_edges(T_nodes)
        for (a, b, R, t_dir, _, _, _) in loops:
            # The unit loop translation at the graph's current estimate of
            # that displacement.
            T_rel_est = np.asarray(kfs[b].T_CW) @ np.linalg.inv(
                np.asarray(kfs[a].T_CW))
            T_meas = np.eye(4, dtype=np.float32)
            T_meas[:3, :3] = R
            T_meas[:3, 3] = t_dir * np.linalg.norm(T_rel_est[:3, 3])
            graph = posegraph.add_edge(graph, a, b, torch.from_numpy(T_meas),
                                       weight=loop_weight)
        lap("graph_s")
        held = _GraphCounts(dev)
        out, _ = posegraph.optimize(graph, iters=iters,
                                    robust_delta=robust_delta)
        T_new = out.T_CW.cpu().numpy()
        node_scale = np.ones(len(kfs))
        if trace is not None:  # the one solve, its nodes read back
            trace["solve_first_s"] = time.perf_counter() - lap.t
    lap("solve_s")
    held.into(trace)

    # Each record's pose relative to its keyframe, rescaled by the node's
    # scale correction, recomposed onto the corrected keyframe pose.
    positions = np.stack([r.T_WC[:3, 3] for r in records])
    kf_rec = [k.record_idx for k in kfs]
    for n, k in enumerate(kfs):
        T_old_WC = np.linalg.inv(k.T_CW)
        T_new_WC = np.linalg.inv(T_new[n])
        inv_old = np.linalg.inv(T_old_WC)
        hi = kf_rec[n + 1] if n + 1 < len(kfs) else len(records)
        for ridx in range(k.record_idx, hi):
            T_WC = np.eye(4)
            T_WC[:3, :3] = records[ridx].T_WC[:3, :3]
            T_WC[:3, 3] = records[ridx].T_WC[:3, 3]
            rel = inv_old @ T_WC
            rel[:3, 3] /= node_scale[n]
            positions[ridx] = (T_new_WC @ rel)[:3, 3]
    lap("recompose_s")
    return positions


class _GraphCounts:
    """The back end's graphs captured, their capture seconds and the
    replays made since it was made (``core.graphs.shared``)."""

    def __init__(self, device):
        self.device = device
        self.captures, self.capture_s = graphs.captures(device)
        self.replays = graphs.replays(device)

    def into(self, trace):
        if trace is None:
            return
        captures, capture_s = graphs.captures(self.device)
        trace.update(captures=captures - self.captures,
                     capture_s=capture_s - self.capture_s,
                     replays=graphs.replays(self.device) - self.replays)


@dataclasses.dataclass
class _LiteRecord:
    T_WC: np.ndarray


def refine_stream_trajectory(outs, frame_ids, bank: KeyframeBank, cam=None,
                             **kw) -> Optional[np.ndarray]:
    """:func:`refine_trajectory` over streamed outputs (T_CW per frame)."""
    T = np.asarray(outs.T_CW)
    records = []
    for i in range(T.shape[0]):
        T_WC = np.eye(4)
        T_WC[:3, :3] = T[i, :3, :3].T
        T_WC[:3, 3] = -T[i, :3, :3].T @ T[i, :3, 3]
        records.append(_LiteRecord(T_WC))
    return refine_trajectory(records, bank, cam, **kw)
