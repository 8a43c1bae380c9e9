"""The VO state machine: SIFT or KLT bootstrap + per-frame step (port of
``pipeline/vo.py``).

``VisualOdometry(cam, config, device)`` holds the camera, the config and the
device (``cuda`` unless the caller names another); ``bootstrap(img0, img1,
intermediate=..., generator=...)`` and ``step(state, image, generator=...)``
are driven from a Python loop, one call per frame (``pipeline/runner.py``,
``pipeline/scan_driver.py``).

Execution, as in the reference (``self._step = jax.jit(self._step_impl)``):
``_step_impl(state, image, draws, run_ba)`` is the step's body, run eagerly.
On a CUDA device ``step`` replays it as a CUDA graph (``StepGraphs``),
captured at first use: one graph for a frame without the in-step BA and
one for a frame that runs it, per upload dtype of the image (uint8 or
float32) and per outputs the caller asks for (none, the pose, the pose and
the landmark snapshot), all in one memory pool, over static buffers that
hold the state, the image and the RANSAC draws.  A replay is one launch from the host;
the launches of the kernels it holds are added to their wrappers' counts.
A capture or replay that fails raises: nothing falls back to eager
stepping.  On the CPU ``step`` runs ``_step_impl``.

Several frames, as in the reference's ``lax.scan`` over a block
(``pipeline/scan_driver.py``): ``step_chunk(state, images, draws)`` runs K
consecutive steps as one body (``_chunk_impl``), replayed on a CUDA device
from one graph per pattern of in-step BA frames among the K (and per upload
dtype, tracker and outputs), over the step's state buffer; on the CPU it
runs the same body.  Each frame's RANSAC bank is drawn before the call.

The reference's other compiled functions are graphs too on a CUDA device
(``graphed``, over a ``GraphCache`` of the VO's: one graph per key and
input shapes, captured at first use): the bootstrap's pieces (the first
frame's pyramid and corners, one KLT hop, SIFT, the ratio match, the
geometry: ``jax.jit(_bootstrap_geom_impl)``), the keyframe bank's SIFT
(``sift_features``) and the loop verifier's chunk
(``posegraph_runner.verify_chunk``).  torch's ``eigh`` and ``svd`` read
their error codes on the host on the card, which no capture allows, so a
function that calls them is captured in segments: the capture ends before
each such call, which runs between the replays (``core/graphs.py::
_Segments``).  The geometry's RANSAC bank is drawn before its replay, as
the step's is.  The capture machinery (``GraphCache``) lives in
``core/graphs.py``, where the back end's graphs reach it too.

Batched, as in the reference's ``jax.jit(jax.vmap(_step_impl))``
(``parallel/seq_dp.py``): ``step_batch(states, images, generators)`` steps S
sequences in lockstep.  Its body, ``_step_batch_impl``, is
``torch.func.vmap`` of ``_step_impl`` over the leading axis of the stacked
state (``core.state.stack_states``), the images and the draws; both LK
kernels fold the vmap's axis into their own batch axis (their custom ops'
vmap rules), so each kernel call of the body is one launch for every
sequence.  On a CUDA device it is captured per batch size as the solo step
is (``StepGraphs``): one replay a frame for all S sequences.  Each sequence
draws its bank from its own generator, as ``step`` would, so sequence s of a
batch computes bit for bit what it computes in a batch of one: the body's
contractions, long sums, solves and roots round alike in a batch
(``core/linalg.py``: the CPU's forms on the CPU, the card's batch-invariant
forms inside ``linalg.exact()``, which the batched body enters on the
card), and the LK kernels give each problem its own blocks.  A solo step
on the card takes the libraries' operations (``linalg.exact(False)``),
which take fewer kernels, so there a sequence stepped alone rounds
otherwise than in a batch; on the CPU both take the CPU's forms and agree
bit for bit.
The BA cadence is the host's (``host_frame``), one for the batch.

Stage order inside a step: KLT (forward on the /4 then the full plane,
backward check) -> PnP-RANSAC -> scale-locked landmark re-triangulation ->
candidate promotion -> anchor maintenance -> corner replenishment -> in-step
windowed BA on its cadence.

Trackers (``config.klt.backend``): ``"pallas2"`` (the packed LK kernel,
windows 5..15), ``"pallas"`` (the v1 LK kernel, window 15), both behind the
/16 prior -> /4 -> full-res chain on a flat pyramid; ``"xla"`` (the gather
tracker over a Gaussian pyramid); ``"auto"`` is ``pallas2`` on a CUDA
device and ``xla`` elsewhere, as the reference picks its kernel tracker on
the accelerator only.

Departures from the reference, by design:
  * RANSAC banks come from ``sampler(generator, valid, num_hypotheses,
    sample_size) -> (idx, ok)``; the default draws them with the
    ``torch.Generator`` given to the call (the reference takes a key per
    call).  The step's bank is drawn before the step, outside the graph:
    a sampler with a ``draw(generator, num_hypotheses, sample_size)``
    method (the default's is ``ransac.draw_uniforms``) gives a draw that
    the step maps onto the valid rows with the sampler's ``select``
    (``ransac.select_minimal_sets`` unless it names its own); the
    bootstrap's geometry draws and maps its bank the same way.  A sampler
    without one (tests inject the reference's own draws) is handed the
    generator inside ``_step_impl`` or ``_bootstrap_geom`` and runs only
    eagerly.
  * The in-step BA trigger is a cadence the host knows (``state.host_frame``,
    carried beside the device ``frame_idx``): the branch runs when
    ``new_frame >= window`` and ``new_frame % every == 0``, and its result is
    selected on the device with ``torch.where(pnp_ok, ...)``, which is what
    the reference's ``lax.cond`` skip branch returns when PnP fails.  The
    ring slot is ``new_frame % window`` on the device.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Sequence

import torch

from ..core import lie, linalg, spans
from ..core.graphs import _HOST_WAITS, GraphCache  # noqa: F401 (tests)
from ..core.camera import Camera
from ..core.config import PipelineConfig
from ..core.slots import (alloc_slots, scatter_add_rows, scatter_rows,
                          stable_top_k)
from ..core.state import (STATUS_LOST, STATUS_TRACKING, FrameState, Packing,
                          init_state)
from ..backend import ba as ba_mod
from ..ops import (corners, essential, image as imops, klt, klt_pallas,
                   klt_pallas2, match, pnp, ransac, sift, triangulate)

Sampler = Callable[[torch.Generator, torch.Tensor, int, int], tuple]

# Frames of a chunk (``step_chunk``) when the in-step BA is off; with it on, a
# chunk is ``ba.every`` frames, so each chunk after the ring fills holds one
# BA frame at the same place and replays one graph.
CHUNK = 8


def ba_trigger(new_frame: int, every: int, window: int) -> bool:
    """Whether the step that makes frame ``new_frame`` runs the in-step
    BA: a full ring and the trigger cadence."""
    return bool(every) and new_frame >= window and new_frame % every == 0


def _num_klt_levels(config: PipelineConfig) -> int:
    """Pyramid depth: reference maxLevel+1, capped so the coarsest level still
    contains the tracking window."""
    H, W = config.image_shape
    levels = config.klt.max_level + 1
    cap = 1
    size = min(H, W)
    while size // 2 >= 2 * config.klt.window and cap < levels:
        size //= 2
        cap += 1
    return cap


class VisualOdometry:
    """Bootstrap + per-frame step over a fixed-shape ``FrameState``."""

    def __init__(self, cam: Camera, config: PipelineConfig, device=None, *,
                 sampler: Optional[Sampler] = None, seed: int = 0):
        """``device``: where the step runs, ``"cuda"`` when None.
        ``sampler``: draws the RANSAC banks (default
        ``ops.ransac.sample_minimal_sets``).  ``seed``: seeds the generator
        of calls that are given none."""
        self.cam = cam
        self.config = config
        self.device = torch.device(device if device is not None else "cuda")
        if config.bootstrap_method not in ("sift", "klt"):
            raise ValueError(f"bootstrap_method={config.bootstrap_method!r}: "
                             "expected 'sift' or 'klt'")
        self.num_levels = max(_num_klt_levels(config),
                              min(klt_pallas.COARSE_LEVEL + 1, 6))
        backend = config.klt.backend
        if backend == "auto":
            # The reference's auto picks its kernel tracker on the
            # accelerator and the gather tracker elsewhere.
            backend = "pallas2" if self.device.type == "cuda" else "xla"
        if backend not in ("pallas", "pallas2", "xla"):
            raise ValueError(f"klt.backend={backend!r}: expected 'auto', "
                             "'pallas', 'pallas2' or 'xla'")
        self.klt_backend = backend
        w = config.klt.window
        if backend == "pallas2" and (w % 2 == 0 or not 5 <= w <= 15):
            raise ValueError(
                f"klt.window={w} unsupported by the pallas2 backend "
                "(odd, 5..15); set klt.backend='xla' for other windows.")
        if backend == "pallas" and w != 15:
            raise ValueError(
                "the legacy 'pallas' backend is fixed at window 15; use "
                "'pallas2' (5..15) or 'xla'.")
        self.sampler = sampler or ransac.sample_minimal_sets
        # Draws the step's bank outside the step, or None: the sampler then
        # takes the generator inside ``_step_impl``.  A sampler with a draw
        # may name the map of its draw onto the valid rows (``select``).
        self._draw = getattr(self.sampler, "draw", None)
        self._select = getattr(self.sampler, "select",
                               ransac.select_minimal_sets)
        self.seed = seed
        self.generator = None  # made at first use, on self.device
        self.ba_runs = 0  # in-step BA branches run (host-known cadence)
        self.graphs = None  # the captured step (StepGraphs), at first use
        self.fn_graphs = None  # the other graphs (GraphCache), at first use
        # How ``step`` packs a frame's outputs (``frame_outputs``), without
        # and with the landmark snapshot.
        K = config.capacity.max_landmarks
        specs = (((4, 4), torch.float32), ((), torch.int32),
                 ((), torch.int32), ((), torch.int32),
                 ((K, 2), torch.float32), ((K,), torch.float32),
                 ((K,), torch.bool))
        self.outputs = {lm: Packing([torch.empty(shape, dtype=dt,
                                                 device="meta")
                                     for shape, dt in specs[:7 if lm else 4]])
                        for lm in (False, True)}

    # ------------------------------------------------------------------
    def make_pyramid(self, image: torch.Tensor):
        if self.klt_backend in ("pallas", "pallas2"):
            mid_f, coarse_f = self._pallas_factors()
            return imops.build_flat_pyramid(image, coarse_f, mid_f)
        return imops.build_pyramid(image, self.num_levels)

    def _pallas_factors(self):
        ml = self.config.klt.max_level
        if ml >= 4:
            return 4, 16
        if ml == 3:
            return 4, 8
        return 2, 4

    def _generator(self, generator):
        if generator is not None:
            return generator
        if self.generator is None:
            self.generator = torch.Generator(device=self.device)
            self.generator.manual_seed(self.seed)
        return self.generator

    def _as_image(self, img) -> torch.Tensor:
        if not torch.is_tensor(img):
            img = torch.as_tensor(img)
        out = img.to(self.device, torch.float32)
        if out.device != img.device:
            spans.h2d(out.nbytes)
        return out

    def _detect(self, image: torch.Tensor):
        det = self.config.detector
        return corners.detect_corners(
            image, max_corners=det.max_corners,
            quality_level=det.quality_level, cell=int(det.min_dist),
            block_size=det.block_size, use_harris=det.use_harris,
            harris_k=det.harris_k)

    def _track(self, prev_pyr, next_pyr, pts, valid):
        cfg = self.config.klt
        if self.klt_backend in ("pallas", "pallas2"):
            fn = (klt_pallas2.track_features_pallas2
                  if self.klt_backend == "pallas2"
                  else klt_pallas.track_features_pallas)
            return klt_pallas2.track_multilevel(
                prev_pyr, next_pyr, pts, valid, track_fn=fn,
                # min(..., 8): the kernels' prior is within a few px, so
                # iterations beyond 8 are pure latency (reference
                # vo.py:135-136).
                num_iters=min(cfg.num_iters, 8),
                mid_iters=min(cfg.mid_iters, 8),
                eps=cfg.eps, min_eig_threshold=cfg.min_eig_threshold,
                max_residual=cfg.max_residual, win=cfg.window)
        return klt.track_features(
            prev_pyr, next_pyr, pts, valid, window=cfg.window,
            num_iters=cfg.num_iters, eps=cfg.eps,
            min_eig_threshold=cfg.min_eig_threshold,
            max_residual=cfg.max_residual)

    def _track_fb(self, prev_pyr, next_pyr, pts, valid):
        """Forward tracking plus the forward-backward check: the backward
        pass re-tracks accepted features from their new position (on the
        kernel trackers with the negated forward flow as its prior), and a
        track survives if it lands within ``fb_max_err_px`` of its start and
        the destination window passes the min-eig/residual gates."""
        cfg = self.config.klt
        new_pts, ok, resid = self._track(prev_pyr, next_pyr, pts, valid)
        if cfg.fb_check:
            kw = dict(num_iters=min(cfg.num_iters, cfg.fb_iters, 8),
                      eps=cfg.eps, min_eig_threshold=cfg.min_eig_threshold,
                      max_residual=cfg.max_residual)
            if self.klt_backend == "pallas2":
                back_pts, back_ok, _ = klt_pallas2.track_features_pallas2(
                    prev_pyr, next_pyr, new_pts, ok, prior=pts - new_pts,
                    swap_planes=True, win=cfg.window, **kw)
            elif self.klt_backend == "pallas":
                back_pts, back_ok, _ = klt_pallas.track_features_pallas(
                    next_pyr, prev_pyr, new_pts, ok, prior=pts - new_pts,
                    **kw)
            else:
                back_pts, back_ok, _ = self._track(next_pyr, prev_pyr,
                                                   new_pts, ok)
            fb2 = torch.sum((back_pts - pts) ** 2, -1)
            ok = ok & back_ok & (fb2 < cfg.fb_max_err_px ** 2)
        return new_pts, ok, resid

    # ------------------------------------------------------------------
    def _bootstrap_geom(self, uv0, uv1, pair_valid, pyr1,
                        draws) -> FrameState:
        """E-RANSAC -> pose -> triangulation -> initial state (without its
        ``host_frame``).  ``draws``: the bank's uniforms from the sampler's
        ``draw`` (``bootstrap_draws``), mapped onto the valid pairs here
        with its ``select``, or the generator of a sampler without one."""
        cfg = self.config
        cap = cfg.capacity
        M, K = cap.max_candidates, cap.max_landmarks
        dev = self.device

        if self._draw is not None:
            idx, samp_ok = self._select(draws.to(dev), pair_valid)
        else:
            idx, samp_ok = self.sampler(draws, pair_valid,
                                        cfg.essential.iterations,
                                        self._essential_sample_size())
        E, inliers, ess_ok = essential.find_essential_ransac(
            self.cam, uv0, uv1, pair_valid, idx, samp_ok,
            threshold_px=cfg.essential.threshold_px,
            solver=cfg.essential.solver)
        R, t, _ = essential.recover_pose(E, self.cam, uv0, uv1, inliers)
        T_CW = lie.rt_to_matrix(R, t)  # world = camera-0 frame, |t| = 1

        T0 = torch.eye(4, dtype=torch.float32, device=dev).expand(M, 4, 4)
        X, promote, keep = triangulate.triangulate_candidates(
            self.cam, uv0, uv1, T0, T_CW, inliers,
            torch.ones(M, dtype=torch.int32, device=dev),
            min_baseline_frames=cfg.landmarks.min_baseline_frames,
            min_baseline_angle_deg=cfg.landmarks.min_baseline_angle_deg,
            min_dist=cfg.landmarks.min_dist,
            max_dist=cfg.landmarks.max_dist,
            enforce_age=False)

        no_lm = torch.zeros(K, dtype=torch.bool, device=dev)
        lm_slots, lm_acc = alloc_slots(no_lm, promote)
        zeros2 = torch.zeros((K, 2), dtype=torch.float32, device=dev)
        lm_valid = scatter_rows(no_lm, lm_slots, lm_acc)

        state = init_state(cfg, pyr1, dev)
        ok = ess_ok & (promote.sum() >= cfg.landmarks.min_bootstrap_landmarks)
        return state.replace(
            frame_idx=torch.ones((), dtype=torch.int32, device=dev),
            T_CW=T_CW,
            lm_gen=scatter_add_rows(state.lm_gen, lm_slots, lm_acc),
            lm_xyz=scatter_rows(torch.zeros((K, 3), device=dev), lm_slots, X),
            lm_uv=scatter_rows(zeros2, lm_slots, uv1),
            lm_valid=lm_valid,
            lm_inlier=lm_valid,
            lm_first_uv=scatter_rows(zeros2, lm_slots, uv0),
            cand_uv=uv1,
            cand_first_uv=uv0,
            cand_T_CW_first=T0.clone(),
            cand_valid=keep,
            status=torch.where(ok, STATUS_TRACKING, STATUS_LOST).to(
                torch.int32),
            n_inliers=inliers.sum().to(torch.int32),
            n_tracked=pair_valid.sum().to(torch.int32),
        )

    def _essential_sample_size(self) -> int:
        return 5 if self.config.essential.solver == "5point" else 8

    def bootstrap_draws(self, generator: Optional[torch.Generator] = None):
        """The bootstrap's RANSAC draws from ``generator`` (the VO's own if
        None): (essential.iterations, 5 or 8) float32 uniforms, or the
        generator itself for a sampler without ``draw``."""
        gen = self._generator(generator)
        if self._draw is None:
            return gen
        return self._draw(gen, self.config.essential.iterations,
                          self._essential_sample_size())

    def _first_frame(self, img0):
        """The first bootstrap frame's pyramid and its corners in the first
        ``max_candidates`` rows: (planes..., uv0 (M, 2), valid (M,))."""
        M = self.config.capacity.max_candidates
        dev = self.device
        uv0_det, _, det_valid = self._detect(img0)
        n = min(int(uv0_det.shape[0]), M)
        uv0 = torch.zeros((M, 2), dtype=torch.float32, device=dev)
        uv0[:n] = uv0_det[:n]
        valid = torch.zeros(M, dtype=torch.bool, device=dev)
        valid[:n] = det_valid[:n]
        return (*self.make_pyramid(img0), uv0, valid)

    def _hop(self, *inputs):
        """One hop of the KLT bootstrap chain: (the previous image's
        planes..., the next image, uv, valid) -> (the next image's
        planes..., uv tracked to it, valid & tracked)."""
        *prev_pyr, image, uv, valid = inputs
        pyr = self.make_pyramid(image)
        uv, tracked, _ = self._track_fb(tuple(prev_pyr), pyr, uv, valid)
        return (*pyr, uv, valid & tracked)

    def _sift(self, image, max_features: int):
        """``sift.detect_and_compute`` of ``image`` with the config's SIFT
        knobs, as a tuple (``SiftFeatures``' fields)."""
        sc = self.config.sift
        return tuple(sift.detect_and_compute(
            image, max_features=max_features, num_octaves=sc.num_octaves,
            scales_per_octave=sc.scales_per_octave,
            contrast_threshold=sc.contrast_threshold,
            edge_threshold=sc.edge_threshold, sigma=sc.sigma,
            first_octave=sc.first_octave))

    def _match(self, desc0, valid0, desc1, valid1):
        return match.match_ratio(desc0, valid0, desc1, valid1,
                                 ratio=self.config.sift.ratio)

    def graphed(self, key, fn, *inputs, host: bool = False):
        """``fn(*inputs)``, a tuple of tensors: on a CUDA device the replay of
        its graph in ``self.fn_graphs`` (``GraphCache.call``, keyed by
        ``key`` and the inputs' shapes and dtypes; ``host``: the outputs
        come back on the host, in one copy), on the CPU ``fn`` itself."""
        if self.device.type != "cuda":
            out = fn(*inputs)
            return [t.cpu() for t in out] if host else out
        if self.fn_graphs is None:
            self.fn_graphs = GraphCache(self.device)
        return self.fn_graphs.call(key, fn, inputs, host=host)

    def sift_features(self, image, max_features: int,
                      host: bool = False) -> sift.SiftFeatures:
        """SIFT of an (H, W) image on the device with the config's knobs
        and ``max_features`` rows (``sift.detect_and_compute``); replayed
        from a graph per image shape and ``max_features`` on a CUDA
        device (``graphed``)."""
        return sift.SiftFeatures(*self.graphed(
            ("sift", max_features), functools.partial(
                self._sift, max_features=max_features),
            self._as_image(image), host=host))

    def bootstrap(self, img0, img1, intermediate=(),
                  generator: Optional[torch.Generator] = None) -> FrameState:
        """Initialize from two frames.  ``bootstrap_method="sift"``: SIFT on
        both frames, ratio-test matched (``intermediate`` unused);
        ``"klt"``: Shi-Tomasi corners on ``img0``, KLT chain-tracked through
        ``intermediate`` to ``img1``.  ``generator`` draws the RANSAC bank
        (one seeded from ``seed`` if None).

        On a CUDA device each piece replays its graph (``graphed``), as the
        reference runs each as a compiled function: the first frame's
        pyramid and corners (``_first_frame``), one graph per hop
        (``_hop``: the next image's pyramid and ``_track_fb``), SIFT and
        the ratio match, and the geometry (``_bootstrap_geom``, its bank
        drawn before its replay; a sampler without ``draw`` runs it op by
        op).  On the CPU each runs op by op."""
        return self._bootstrap(img0, img1, intermediate, generator,
                               self.graphed)

    def bootstrap_eager(self, img0, img1, intermediate=(),
                        generator: Optional[torch.Generator] = None
                        ) -> FrameState:
        """``bootstrap`` op by op on any device: what its graphs replay."""
        return self._bootstrap(img0, img1, intermediate, generator,
                               lambda key, fn, *inputs: fn(*inputs))

    @spans.spanned("vo.bootstrap")
    def _bootstrap(self, img0, img1, intermediate, generator,
                   run) -> FrameState:
        spans.COUNTS["bootstraps"] += 1
        cfg = self.config
        img0 = self._as_image(img0)
        img1 = self._as_image(img1)
        if cfg.bootstrap_method == "sift":
            M = cfg.capacity.max_candidates
            f0, f1 = (sift.SiftFeatures(*run(
                ("sift", M), functools.partial(self._sift, max_features=M),
                img)) for img in (img0, img1))
            idx1, pair_valid = run(("match",), self._match, f0.desc,
                                   f0.valid, f1.desc, f1.valid)
            uv0, uv1 = f0.uv, f1.uv[idx1]
            pyr1 = tuple(run(("pyramid",), self.make_pyramid, img1))
        else:
            *pyr, uv0, valid = run(("first_frame",), self._first_frame, img0)
            uv1 = uv0
            for image in [*map(self._as_image, intermediate), img1]:
                spans.COUNTS["bootstrap.hops"] += 1
                *pyr, uv1, valid = run(("hop",), self._hop, *pyr, image,
                                       uv1, valid)
            pyr1, pair_valid = tuple(pyr), valid
        draws = self.bootstrap_draws(generator)
        if torch.is_tensor(draws):
            state = FrameState.from_tensors(run(
                ("geometry",), self._geometry, uv0, uv1, pair_valid, *pyr1,
                draws), len(pyr1))
        else:
            state = self._bootstrap_geom(uv0, uv1, pair_valid, pyr1, draws)
        state.host_frame = 1
        return state

    def _geometry(self, uv0, uv1, pair_valid, *rest):
        """``_bootstrap_geom`` over (uv0, uv1, pair_valid, pyramid
        planes..., draws), as the state's tensors."""
        *pyr1, draws = rest
        return tuple(self._bootstrap_geom(uv0, uv1, pair_valid, tuple(pyr1),
                                          draws).tensors())

    # ------------------------------------------------------------------
    def step(self, state: FrameState, image,
             generator: Optional[torch.Generator] = None, *,
             outputs: Optional[torch.Tensor] = None,
             landmarks: bool = False, draws=None) -> FrameState:
        """One frame of continuous operation: a replay of the captured step
        on a CUDA device, ``_step_impl`` on the CPU.  ``generator`` draws the
        RANSAC bank (one seeded from ``seed`` if None), unless ``draws``
        gives the bank ``step_draws`` drew before.  ``outputs``: a uint8
        tensor of ``self.outputs[landmarks].nbytes`` bytes on the device,
        which gets the new state's ``frame_outputs`` packed, with the
        landmark snapshot if ``landmarks``."""
        run_ba = self.ba_due(state)
        spans.COUNTS["steps"] += 1
        with spans.span("vo.step", ba=run_ba):
            if draws is None:
                draws = self.step_draws(generator)
            if self.device.type == "cuda":
                if self.graphs is None:
                    self.graphs = StepGraphs(self)
                new = self.graphs.step(state, image, draws, run_ba, outputs,
                                       landmarks)
            else:
                new = self._step_impl(state, image, draws, run_ba)
                if outputs is not None:
                    with spans.span("stage.pack"):
                        self.outputs[landmarks].pack(
                            outputs, frame_outputs(new, landmarks))
        new.host_frame = state.host_frame_idx() + 1
        if run_ba:
            self.ba_runs += 1
        return new

    def step_batch(self, states: FrameState, images,
                   generators: Sequence[torch.Generator], *,
                   outputs: Optional[torch.Tensor] = None,
                   landmarks: bool = False) -> FrameState:
        """One frame of S sequences in lockstep: a replay of the captured
        batched step on a CUDA device, ``_step_batch_impl`` on the CPU.

        ``states``: S states stacked on a leading axis
        (``core.state.stack_states``), one ``host_frame`` for all.
        ``images``: (S, H, W), a tensor or S frames.  ``generators``: one
        per sequence; sequence s draws its bank from ``generators[s]`` as
        ``step`` draws it.  ``outputs``: a uint8 tensor (S,
        ``self.outputs[landmarks].nbytes``) on the device, which gets each
        sequence's ``frame_outputs``.  Returns the S new states, stacked."""
        S = states.T_CW.shape[0]
        if states.T_CW.shape != (S, 4, 4) or len(generators) != S:
            raise ValueError(f"a batch of {states.T_CW.shape[:-2]} states "
                             f"with {len(generators)} generators")
        if self._draw is None:
            raise TypeError("the batched step takes its RANSAC draws as "
                            "tensors: a sampler without draw() runs only "
                            "through step")
        run_ba = self.ba_due(states)
        draws = torch.stack([self.step_draws(g).to(self.device)
                             for g in generators])
        if not torch.is_tensor(images):
            images = torch.stack([torch.as_tensor(im) for im in images])
        if self.device.type == "cuda":
            if self.graphs is None:
                self.graphs = StepGraphs(self)
            new = self.graphs.step(states, images, draws, run_ba, outputs,
                                   landmarks, batch=S)
        else:
            new = self._step_batch_impl(states, images.to(self.device),
                                        draws, run_ba)
            if outputs is not None:
                self.outputs[landmarks].pack(
                    outputs, batch_frame_outputs(new, landmarks))
        new.host_frame = states.host_frame_idx() + 1
        if run_ba:
            self.ba_runs += 1
        return new

    def step_chunk(self, state: FrameState, images, draws, *,
                   outputs: Optional[torch.Tensor] = None,
                   landmarks: bool = False) -> FrameState:
        """K consecutive frames in one call: a replay of the captured chunk
        (``StepGraphs.chunk``) on a CUDA device, ``_chunk_impl`` on the
        CPU; the state after the K frames, as K calls of ``step`` would
        leave it.

        ``images``: (K, H, W).  ``draws``: the K frames' banks from
        ``step_draws`` in frame order (a sequence of K tensors, or one (K,
        iterations, 3) tensor).  ``outputs``: a uint8 tensor (K,
        ``self.outputs[landmarks].nbytes``) on the device, row k of which
        gets frame k's ``frame_outputs``.  The BA frames among the K follow
        from ``state.host_frame`` (``ba_flags``)."""
        if self._draw is None:
            raise TypeError("a chunk takes its RANSAC draws as tensors: a "
                            "sampler without draw() runs only through step")
        K = images.shape[0]
        if len(draws) != K:
            raise ValueError(f"{K} images with {len(draws)} draws")
        flags = self.ba_flags(state, K)
        spans.COUNTS["steps"] += K
        spans.COUNTS["chunks"] += 1
        with spans.span("vo.chunk", K=K, ba=flags):
            if self.device.type == "cuda":
                if self.graphs is None:
                    self.graphs = StepGraphs(self)
                new = self.graphs.chunk(state, images, draws, flags, outputs,
                                        landmarks)
            else:
                new = self._chunk_impl(state, images, draws, flags, outputs,
                                       landmarks)
        new.host_frame = state.host_frame_idx() + K
        self.ba_runs += sum(flags)
        return new

    @property
    def chunk_frames(self) -> int:
        """K, the frames of a chunk (``step_chunk``): ``ba.every``, or
        ``CHUNK`` with the in-step BA off; 0 for a sampler without
        ``draw``, whose banks cannot be drawn before the step."""
        if self._draw is None:
            return 0
        return self.config.ba.every or CHUNK

    def ba_flags(self, state: FrameState, n: int = 1) -> tuple:
        """For each of the ``n`` steps after ``state``, whether it runs the
        in-step BA (``ba_trigger``), decided from ``state.host_frame``."""
        ba = self.config.ba
        first = state.host_frame_idx() + 1
        return tuple(ba_trigger(f, ba.every, ba.window)
                     for f in range(first, first + n))

    def ba_due(self, state: FrameState) -> bool:
        """Whether the step after ``state`` runs the in-step BA: a full ring
        and the trigger cadence, decided from ``state.host_frame``."""
        return self.ba_flags(state)[0]

    def step_draws(self, generator: Optional[torch.Generator] = None):
        """The step's RANSAC draws from ``generator`` (the VO's own if
        None): (pnp.iterations, 3) float32 uniforms, or the generator itself
        for a sampler without ``draw``."""
        gen = self._generator(generator)
        if self._draw is None:
            return gen
        return self._draw(gen, self.config.pnp.iterations, 3)

    def _step_impl(self, state: FrameState, image, draws,
                   run_ba: bool) -> FrameState:
        """The step's body: ``image`` (H, W) of any dtype, ``draws`` from
        ``step_draws``, ``run_ba`` from ``ba_due``.  Nothing in it reads a
        device value on the host, so it can be captured.  On the card it
        takes the libraries' arithmetic, whatever ``linalg.exact`` the
        caller is in, so a graph's arithmetic follows from its key."""
        with linalg.exact(False):
            return self._step_body(state, image, draws, run_ba)

    def _step_body(self, state: FrameState, image, draws,
                   run_ba: bool) -> FrameState:
        cfg = self.config
        K = cfg.capacity.max_landmarks
        dev = self.device
        with spans.span("stage.klt"):
            image = self._as_image(image)
            pyr = self.make_pyramid(image)

            # (1) KLT both tables in one batched call.
            all_pts = torch.cat([state.lm_uv, state.cand_uv], 0)
            all_valid = torch.cat([state.lm_valid, state.cand_valid], 0)
            new_pts, tracked, _ = self._track_fb(state.prev_pyramid, pyr,
                                                 all_pts, all_valid)
            lm_uv, lm_valid = new_pts[:K], tracked[:K]
            cand_uv, cand_valid = new_pts[K:], tracked[K:]

        with spans.span("stage.pnp"):
            # (2) PnP-RANSAC; hold the pose and report LOST on failure.
            if self._draw is not None:
                idx, hyp_ok = self._select(draws.to(dev), lm_valid)
            else:
                idx, hyp_ok = self.sampler(draws, lm_valid,
                                           cfg.pnp.iterations, 3)
            T_CW, pnp_inliers, pnp_ok = pnp.solve_pnp_ransac(
                self.cam, state.lm_xyz, lm_uv, lm_valid, idx, hyp_ok,
                reproj_threshold_px=cfg.pnp.reproj_err_px,
                refine_iters=cfg.pnp.refine_iters,
                min_points=cfg.pnp.min_points)
            T_CW = torch.where(pnp_ok, T_CW, state.T_CW)
            lm_valid_kept = torch.where(pnp_ok, lm_valid & pnp_inliers,
                                        lm_valid)

        with spans.span("stage.retri"):
            # (2b) Landmark re-triangulation against the sliding anchor.
            lm_xyz_base = state.lm_xyz
            lmc = cfg.landmarks
            gates = dict(min_baseline_frames=lmc.min_baseline_frames,
                         min_baseline_angle_deg=lmc.min_baseline_angle_deg,
                         min_dist=lmc.min_dist, max_dist=lmc.max_dist)
            if lmc.retriangulate:
                X_re, re_ok, _ = triangulate.triangulate_candidates(
                    self.cam, state.lm_first_uv, lm_uv, state.lm_T_CW_first,
                    T_CW, lm_valid_kept,
                    torch.zeros(K, dtype=torch.int32, device=dev),
                    enforce_age=False, **gates)
                if lmc.retri_scale_lock:
                    # Keep the re-triangulated bearing, pull the depth back
                    # toward the previous estimate (geometric blend) so
                    # depth refreshes cannot random-walk the monocular
                    # scale.
                    z_old = (linalg.matmul(state.lm_xyz, T_CW[2, :3])
                             + T_CW[2, 3])
                    z_new = linalg.matmul(X_re, T_CW[2, :3]) + T_CW[2, 3]
                    C = -linalg.matmul(T_CW[:3, :3].T, T_CW[:3, 3])
                    blend = lmc.retri_depth_blend
                    z_new_safe = torch.where(z_new.abs() > 1e-6, z_new,
                                             torch.ones_like(z_new))
                    full_ratio = z_old / z_new_safe
                    depth_ok = (z_old > lmc.min_dist) & (z_new > 1e-6)
                    ratio = torch.where(
                        depth_ok & (full_ratio > 0),
                        linalg.power(torch.clamp(full_ratio, min=1e-6),
                                     1.0 - blend),
                        torch.ones_like(full_ratio))
                    X_re = torch.where(depth_ok[:, None],
                                       C + (X_re - C) * ratio[:, None], X_re)
                lm_xyz_base = torch.where((re_ok & lm_valid_kept)[:, None],
                                          X_re, state.lm_xyz)

        with spans.span("stage.triangulate"):
            # (3) Candidate triangulation + promotion.
            age = state.frame_idx + 1 - state.cand_first_frame
            X, promote, keep = triangulate.triangulate_candidates(
                self.cam, state.cand_first_uv, cand_uv, state.cand_T_CW_first,
                T_CW, cand_valid, age, **gates)
            lm_slots, lm_acc = alloc_slots(lm_valid_kept, promote)
            lm_xyz = scatter_rows(lm_xyz_base, lm_slots, X)
            lm_uv = scatter_rows(lm_uv, lm_slots, cand_uv)
            lm_valid_new = scatter_rows(lm_valid_kept, lm_slots, lm_acc)
            # Bump the generation of re-allocated slots so windowed BA can
            # mask observations of a slot's previous tenant.
            lm_gen = scatter_add_rows(state.lm_gen, lm_slots, lm_acc)
            cand_valid = keep

            # Anchor maintenance: promoted landmarks inherit their
            # candidate's first observation; anchors older than
            # reanchor_age slide forward.
            anchor_age = state.lm_anchor_age + 1
            lm_first_uv = scatter_rows(state.lm_first_uv, lm_slots,
                                       state.cand_first_uv)
            lm_T_CW_first = scatter_rows(state.lm_T_CW_first, lm_slots,
                                         state.cand_T_CW_first)
            anchor_age = scatter_rows(anchor_age, lm_slots,
                                      torch.where(lm_acc, age, 0))
            re_anchor = lm_valid_new & (anchor_age >= lmc.reanchor_age)
            lm_first_uv = torch.where(re_anchor[:, None], lm_uv,
                                      lm_first_uv)
            lm_T_CW_first = torch.where(re_anchor[:, None, None],
                                        T_CW.expand(K, 4, 4), lm_T_CW_first)
            anchor_age = torch.where(re_anchor, 0, anchor_age)

        with spans.span("stage.detect"):
            # (4) Corner replenishment with min-dist dedup.
            det_uv, _, det_valid = self._detect(image)
            min_d2 = cfg.detector.min_dist ** 2
            inf = torch.full((), float("inf"), device=dev)
            d2_cand = torch.sum((det_uv[:, None, :] - cand_uv[None]) ** 2,
                                -1)
            d2_lm = torch.sum((det_uv[:, None, :] - lm_uv[None]) ** 2, -1)
            far_from_cand = torch.all(
                torch.where(cand_valid[None, :], d2_cand, inf) > min_d2, 1)
            far_from_lm = torch.all(
                torch.where(lm_valid_new[None, :], d2_lm, inf) > min_d2, 1)
            new_mask = det_valid & far_from_cand & far_from_lm
            c_slots, c_acc = alloc_slots(cand_valid, new_mask)
            n_det = det_uv.shape[0]
            cand_uv = scatter_rows(cand_uv, c_slots, det_uv)
            cand_first_uv = scatter_rows(state.cand_first_uv, c_slots,
                                         det_uv)
            cand_T_CW_first = scatter_rows(state.cand_T_CW_first, c_slots,
                                           T_CW.expand(n_det, 4, 4))
            cand_first_frame = scatter_rows(
                state.cand_first_frame, c_slots,
                (state.frame_idx + 1).expand(n_det))
            cand_valid = scatter_rows(cand_valid, c_slots, c_acc)

            n_inl = (pnp_inliers & lm_valid).sum().to(torch.int32)
            status = torch.where(pnp_ok, STATUS_TRACKING, STATUS_LOST).to(
                torch.int32)
            lm_inlier = pnp_inliers & lm_valid
            n_tracked = tracked[:K].sum().to(torch.int32)

        with spans.span("stage.ring"):
            # (5) In-step windowed BA: push this frame into the ring; on the
            # cadence, Schur GN over the window and fold the result back.
            ba_T, ba_uv, ba_mask, ba_gen = (state.ba_T, state.ba_uv,
                                            state.ba_mask, state.ba_gen)
            new_frame = state.frame_idx + 1
            if cfg.ba.every:
                Wb = cfg.ba.window
                # The ring slot on the device: a select over the slots, not
                # a write at a host index.
                slot = torch.remainder(new_frame, Wb)
                hit = torch.arange(Wb, device=dev) == slot
                ba_T = torch.where(hit[:, None, None], T_CW, ba_T)
                ba_uv = torch.where(hit[:, None, None], lm_uv, ba_uv)
                ba_mask = torch.where(hit[:, None], lm_valid_new, ba_mask)
                ba_gen = torch.where(hit[:, None], lm_gen, ba_gen)
        # Only with a FULL ring (otherwise the frozen gauge rows would be
        # unfilled identity poses) and on the trigger cadence: the host
        # decides (``ba_due``).
        if cfg.ba.every and run_ba:
            with spans.span("stage.ba"):
                ba_T_out, lm_out, T_ba = self._run_ba_branch(
                    ba_T, ba_uv, ba_mask, ba_gen, lm_xyz, lm_gen,
                    lm_valid_new, slot)
                ba_T = torch.where(pnp_ok, ba_T_out, ba_T)
                lm_xyz = torch.where(pnp_ok, lm_out, lm_xyz)
                T_CW = torch.where(pnp_ok, T_ba, T_CW)

        return state.replace(
            frame_idx=new_frame,
            T_CW=T_CW,
            lm_xyz=lm_xyz,
            lm_uv=lm_uv,
            lm_valid=lm_valid_new,
            lm_inlier=lm_inlier,
            lm_gen=lm_gen,
            lm_first_uv=lm_first_uv,
            lm_T_CW_first=lm_T_CW_first,
            lm_anchor_age=anchor_age,
            cand_uv=cand_uv,
            cand_first_uv=cand_first_uv,
            cand_T_CW_first=cand_T_CW_first,
            cand_first_frame=cand_first_frame,
            cand_valid=cand_valid,
            ba_T=ba_T,
            ba_uv=ba_uv,
            ba_mask=ba_mask,
            ba_gen=ba_gen,
            prev_pyramid=pyr,
            status=status,
            n_inliers=n_inl,
            n_tracked=n_tracked,
        )

    def _chunk_impl(self, state: FrameState, images, draws, flags,
                    outputs: Optional[torch.Tensor] = None,
                    landmarks: bool = False) -> FrameState:
        """The chunk's body: ``_step_impl`` once a frame over ``images[k]``,
        ``draws[k]`` and ``flags[k]``, each frame's ``frame_outputs`` packed
        into ``outputs[k]`` when given; returns the last state.  Nothing in
        it reads a device value on the host."""
        for k, run_ba in enumerate(flags):
            state = self._step_impl(state, images[k], draws[k], run_ba)
            if outputs is not None:
                with spans.span("stage.pack"):
                    self.outputs[landmarks].pack(
                        outputs[k], frame_outputs(state, landmarks))
        return state

    def _step_batch_impl(self, states: FrameState, images: torch.Tensor,
                         draws: torch.Tensor, run_ba: bool) -> FrameState:
        """The batched step's body: ``torch.func.vmap`` of ``_step_impl``
        over the leading axis of ``states``' tensors, of ``images`` (S, H,
        W) and of ``draws`` (S, iterations, 3).  Every op of the body has a
        batching rule (none falls back to a loop over the slices), and the
        LK kernels' custom ops take the whole batch in one launch."""
        if not torch.is_tensor(draws):
            raise TypeError("the batched step takes its RANSAC draws as a "
                            "tensor (S, iterations, 3)")

        def one(tensors, image, d):
            return self._step_body(states.with_tensors(tensors), image, d,
                                   run_ba).tensors()

        # The card's batch-invariant forms on the card; the CPU's own forms
        # are batch-invariant there (core/linalg.py).
        with linalg.exact(self.device.type == "cuda"):
            return states.with_tensors(
                torch.func.vmap(one)(states.tensors(), images, draws))

    def _run_ba_branch(self, ba_T, ba_uv, ba_mask, ba_gen, lm_xyz_in, lm_gen,
                       lm_valid_new, slot):
        """Windowed BA over the ring, oldest..newest, with the
        accept-if-improves guard.  Returns (ring poses, landmarks, newest
        pose)."""
        cfg = self.config.ba
        Wb = cfg.window
        order = torch.remainder(slot + 1 + torch.arange(Wb, device=self.device),
                                Wb)
        Tw = ba_T[order]
        uvw = ba_uv[order]
        mw = ba_mask[order] & (ba_gen[order] == lm_gen[None, :])
        n_obs = mw.sum(0)
        part = (n_obs >= cfg.min_obs) & lm_valid_new
        Kba = cfg.max_landmarks
        if Kba and Kba < lm_xyz_in.shape[0]:
            # Compact to the best-observed Kba landmarks; ties in
            # observation count keep ascending slot order (lax.top_k's).
            _, sel = stable_top_k(
                torch.where(part, n_obs, torch.full_like(n_obs, -1)), Kba)
            part_s = part[sel]
            win = ba_mod.BAWindow(T_CW=Tw, lm_xyz=lm_xyz_in[sel],
                                  obs_uv=uvw[:, sel],
                                  obs_mask=mw[:, sel] & part_s)
            out = self._ba_accept(win)
            lm_out = lm_xyz_in.clone()
            lm_out[sel] = torch.where(part_s[:, None], out.lm_xyz,
                                      lm_xyz_in[sel])
        else:
            win = ba_mod.BAWindow(T_CW=Tw, lm_xyz=lm_xyz_in, obs_uv=uvw,
                                  obs_mask=mw & part[None, :])
            out = self._ba_accept(win)
            lm_out = torch.where(part[:, None], out.lm_xyz, lm_xyz_in)
        ba_T_out = ba_T.clone()
        ba_T_out[order] = out.T_CW
        return ba_T_out, lm_out, out.T_CW[-1]

    def _ba_accept(self, win: ba_mod.BAWindow) -> ba_mod.BAWindow:
        """Run BA; keep the update only when the window RMS does not get
        worse (a GN step on an ill-conditioned window can raise it)."""
        cfg = self.config.ba
        # Contiguous: the window's gathers leave other layouts under
        # torch.func.vmap, and a sum over another layout may add in another
        # order; laid out alike, a batch rounds as its slices alone.
        win = ba_mod.BAWindow(*(t.contiguous() for t in win))
        out, _ = ba_mod.run_ba(win, self.cam, iters=cfg.iters,
                               huber_px=cfg.huber_px, n_fixed=2)
        rms_pre = ba_mod.reprojection_rms(win, self.cam)
        rms_post = ba_mod.reprojection_rms(out, self.cam)
        good = torch.isfinite(rms_post) & (rms_post <= rms_pre)
        return ba_mod.BAWindow(*(torch.where(good, a, b)
                                 for a, b in zip(out, win)))


def frame_outputs(state: FrameState, landmarks: bool = False):
    """What the block driver keeps of a frame: T_CW, n_inliers, n_tracked,
    status, and if ``landmarks`` the landmark snapshot (pixel position,
    camera-frame depth, and validity with a finite positive depth)."""
    out = (state.T_CW, state.n_inliers, state.n_tracked, state.status)
    if not landmarks:
        return out
    z = linalg.matmul(state.lm_xyz, state.T_CW[2, :3]) + state.T_CW[2, 3]
    return out + (state.lm_uv, z,
                  state.lm_valid & torch.isfinite(z) & (z > 0))


def batch_frame_outputs(states: FrameState, landmarks: bool = False):
    """``frame_outputs`` of each of S stacked states, as (S, ...) tensors."""
    return torch.func.vmap(lambda ts: frame_outputs(states.with_tensors(ts),
                                                    landmarks))(
        states.tensors())


class _Inputs:
    """The static inputs and outputs of one leading shape (none for a
    frame, (S,) for a batch of S, (K,) for a chunk of K frames): the image
    per upload dtype, the RANSAC draws, and the outputs without and with
    the landmark snapshot."""

    def __init__(self, lead: tuple, vo: "VisualOdometry"):
        self.device = vo.device
        self.images: Dict[torch.dtype, torch.Tensor] = {}
        self.draws = None
        self.outputs = {lm: torch.empty(lead + (p.nbytes,),
                                        dtype=torch.uint8, device=vo.device)
                        for lm, p in vo.outputs.items()}

    def load(self, image, draws) -> torch.Tensor:
        """Copy ``image`` and ``draws`` (a tensor, or a sequence of tensors
        stacked on the leading axis) into their buffers, each with one copy
        (the image's asynchronous from pinned host memory); returns the
        image buffer of the image's upload dtype (uint8, or float32)."""
        img = torch.as_tensor(image)
        dtype = torch.uint8 if img.dtype == torch.uint8 else torch.float32
        if dtype not in self.images:
            self.images[dtype] = torch.empty(tuple(img.shape), dtype=dtype,
                                             device=self.device)
        img_buf = self.images[dtype]
        if img.shape != img_buf.shape:
            raise ValueError(f"image of shape {tuple(img.shape)}; the step "
                             f"was captured at {tuple(img_buf.shape)}")
        img_buf.copy_(img, non_blocking=True)
        if img.device.type == "cpu":
            spans.h2d(img.nbytes)
        if torch.is_tensor(draws):
            shape, dt = tuple(draws.shape), draws.dtype
        elif (isinstance(draws, (list, tuple)) and draws
              and all(torch.is_tensor(d) for d in draws)):
            shape, dt = (len(draws),) + tuple(draws[0].shape), draws[0].dtype
        else:
            raise TypeError("the captured step takes its RANSAC draws as "
                            "tensors: a sampler without draw() runs only "
                            "through _step_impl")
        if self.draws is None:
            self.draws = torch.empty(shape, dtype=dt, device=self.device)
        if shape != tuple(self.draws.shape) or dt != self.draws.dtype:
            raise ValueError(f"draws {dt} {shape}; the step was captured "
                             f"with {self.draws.dtype} "
                             f"{tuple(self.draws.shape)}")
        if torch.is_tensor(draws):
            if draws.device.type == "cpu":
                spans.h2d(draws.nbytes)
            self.draws.copy_(draws)
        elif all(d.device == self.draws.device for d in draws):
            torch.stack(draws, out=self.draws)
        else:
            spans.h2d(self.draws.nbytes)
            self.draws.copy_(torch.stack(draws))
        return img_buf


class _Buffers:
    """The static buffers of one batch size: the state (one packed row, or
    S rows), which the state's graphs read and write over, and the inputs
    of each leading shape that reads it (``_Inputs``).  ``resident``: the
    snapshot whose state the state buffer holds (the last replay's, or the
    one last copied in) with its version then, or None."""

    def __init__(self, lead: tuple, packing: Packing, like: FrameState,
                 vo: "VisualOdometry"):
        self.vo = vo
        self.state = torch.empty(lead + (packing.nbytes,), dtype=torch.uint8,
                                 device=vo.device)
        self.static = like.with_tensors(packing.views(self.state))
        self.inputs: Dict[tuple, _Inputs] = {}
        self.resident = None

    def io(self, lead: tuple) -> _Inputs:
        if lead not in self.inputs:
            self.inputs[lead] = _Inputs(lead, self.vo)
        return self.inputs[lead]


class StepGraphs(GraphCache):
    """``VisualOdometry._step_impl`` captured as CUDA graphs over static
    buffers: the counterpart of the reference's ``jax.jit(_step_impl)``,
    of ``jax.jit(jax.vmap(_step_impl))`` for a batch, and of its
    ``lax.scan`` over a block for a chunk of K frames (``_chunk_impl``).

    The buffers, per batch size (none for one sequence, S for the batched
    step ``_step_batch_impl``): the state (every tensor of a ``FrameState``
    packed in one uint8 row, ``Packing``, or S rows), and per leading shape
    of the inputs (``_Inputs``: a frame, a batch, a chunk of K) one image
    buffer per upload dtype (uint8, float32), the RANSAC draws, and the
    frames' outputs (``frame_outputs``, packed as ``vo.outputs``) for
    callers that ask for them.  A graph reads the state, the images and the
    draws and writes the next state back over the state buffer (and the
    outputs into theirs), so a frame's and a chunk's graphs chain.  One
    graph per (upload dtype, in-step BA or not, tracker, outputs: none,
    without or with the landmark snapshot, batch size), and one a chunk per
    (upload dtype, in-step BA flags of its K frames, tracker, outputs),
    captured at first use (``GraphCache.capture``, its warm-up one run of
    the body, or for a chunk one step of each kind it holds), all in one
    memory pool.  A batched graph holds as many
    launches as the solo one: each kernel call of the body takes every
    sequence.

    ``step`` and ``chunk`` copy the state in (nothing for the state the
    last replay returned, still in the buffer and unwritten since; one copy
    for another replay's; a copy per tensor otherwise), replay, and return
    the new state as views of one copy of the state buffer, so a later
    replay leaves it as it is.  Every failure raises."""

    def __init__(self, vo: "VisualOdometry"):
        super().__init__(vo.device)
        self.vo = vo
        self.packing: Optional[Packing] = None
        self.bufs: Dict[Optional[int], _Buffers] = {}
        self.bodies: Dict[tuple, tuple] = {}  # key -> (body, its buffers)

    def step(self, state: FrameState, image, draws, run_ba: bool,
             outputs: Optional[torch.Tensor], landmarks: bool,
             batch: Optional[int] = None) -> FrameState:
        """Replay the step for one state, or for ``batch`` stacked states
        (``image`` (S, H, W), ``draws`` (S, iterations, 3))."""
        vo = self.vo
        with spans.span("vo.load"):
            b = self._load_state(state, batch)
            io = b.io(() if batch is None else (batch,))
            img_buf = io.load(image, draws)
        out = None if outputs is None else landmarks
        key = (img_buf.dtype, run_ba, vo.klt_backend, out, batch)
        if key not in self.graphs:
            body, outs_of = ((vo._step_impl, frame_outputs) if batch is None
                             else (vo._step_batch_impl, batch_frame_outputs))

            def run(static, img, draws, outs):
                new = body(static, img, draws, run_ba)
                if outs is not None:
                    with spans.span("stage.pack"):
                        vo.outputs[out].pack(outs, outs_of(new, out))
                return new

            self._capture(key, b, io, img_buf, out, run,
                          lambda: body(b.static, img_buf, io.draws, run_ba))
        return self._replayed(key, b, io, outputs, landmarks)

    def chunk(self, state: FrameState, images, draws, flags: tuple,
              outputs: Optional[torch.Tensor],
              landmarks: bool) -> FrameState:
        """Replay ``len(flags)`` steps from one state (``images`` (K, H, W),
        ``draws`` K banks, ``flags`` the BA frames, ``outputs`` (K, nbytes)
        or None)."""
        vo = self.vo
        with spans.span("vo.load"):
            b = self._load_state(state, None)
            io = b.io((len(flags),))
            img_buf = io.load(images, draws)
        out = None if outputs is None else landmarks
        key = ("chunk", img_buf.dtype, flags, vo.klt_backend, out)
        if key not in self.graphs:

            def warm_up():
                # A step of each kind the chunk holds runs every op of its
                # body; K of them would only repeat those.
                for run_ba in set(flags):
                    k = flags.index(run_ba)
                    vo._step_impl(b.static, img_buf[k], io.draws[k], run_ba)

            self._capture(
                key, b, io, img_buf, out,
                lambda static, img, draws, outs: vo._chunk_impl(
                    static, img, draws, flags, outs, bool(out)),
                warm_up)
        return self._replayed(key, b, io, outputs, landmarks)

    def _replayed(self, key, b: _Buffers, io: _Inputs,
                  outputs: Optional[torch.Tensor],
                  landmarks: bool) -> FrameState:
        self.replay(key)
        with spans.span("vo.out"):
            snap = b.state.clone()
            b.resident = (snap, snap._version)
            if outputs is not None:
                outputs.copy_(io.outputs[landmarks])
        new = b.static.with_tensors(self.packing.views(snap))
        new._step_buf = (self.packing.specs, snap)
        return new

    def _load_state(self, state: FrameState,
                    batch: Optional[int]) -> _Buffers:
        tensors = state.tensors()
        if self.packing is None:
            self.packing = Packing(tensors if batch is None
                                   else [t[0] for t in tensors])
        if batch not in self.bufs:
            self.bufs[batch] = _Buffers(() if batch is None else (batch,),
                                        self.packing, state, self.vo)
        b = self.bufs[batch]
        specs, buf = getattr(state, "_step_buf", (None, None))
        if (specs != self.packing.specs or buf.shape != b.state.shape
                or buf.device != b.state.device):
            spans.h2d(sum(t.nbytes for t in tensors
                          if t.device.type == "cpu"))
            self.packing.pack(b.state, tensors)
            b.resident = None
        # The snapshot's views share its version counter, which a write
        # through any of them moves on.
        elif (b.resident is None or b.resident[0] is not buf
              or b.resident[1] != buf._version):
            b.state.copy_(buf)
            b.resident = (buf, buf._version)
        return b

    def _capture(self, key, b: _Buffers, io: _Inputs, img_buf, out,
                 run: Callable, warm_up: Callable[[], object]) -> None:
        """Capture ``run(static state, image, draws, outputs or None)``, a
        body over ``b``'s and ``io``'s buffers, with the new state it
        returns written over the state buffer; the key's buffers and body
        are kept for ``stage_map``."""
        bufs = (b.state, b.static, img_buf, io.draws,
                None if out is None else io.outputs[out])
        self.bodies[key] = (run, bufs)
        # Warm-up: its result is dropped, the buffers keep the input.
        self.capture(key, lambda: self._record(run, *bufs), warm_up)

    def _record(self, run, state, static, img, draws, outs) -> None:
        new = run(static, img, draws, outs)
        with spans.span("stage.pack"):
            # Through a scratch buffer: the new state may share tensors with
            # the one it was made from.
            scratch = torch.empty_like(state)
            self.packing.pack(scratch, new.tensors())
            state.copy_(scratch)

    def stage_map(self) -> Dict[tuple, list]:
        """For each step and chunk key captured, the stage of each device
        operation of its graph, in launch order: ``{key: [(name, stage),
        ...]}``, ``name`` by ``op_kind``, ``stage`` the innermost
        ``stage.*`` span (``core.spans``) around the call that queued it,
        or None.

        Each key's body runs op by op on copies of its state, image,
        draws and outputs buffers (a replay's results stay as they are),
        twice, under ``torch.profiler`` with the spans on and mirrored into
        the profiler's own ranges, so the stage of each device operation of
        the second run is read on the profiler's clock.  A replay of the
        key on one stream runs the same operations in this order, so its
        device events split by index into stages where their names agree.
        Raises if spans or a profiler are recording."""
        from torch.profiler import ProfilerActivity, profile

        maps = {}
        for key, (run, bufs) in self.bodies.items():
            state, static, img, draws, outs = bufs
            copy = state.clone()
            scratch = (copy, static.with_tensors(self.packing.views(copy)),
                       img.clone(), draws.clone(),
                       None if outs is None else outs.clone())
            torch.cuda.synchronize(self.device)
            spans.start(mirror=True)
            try:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    # A profile can lose the first device operations it
                    # records (on an H100, after earlier profiles in the
                    # process: a uint8 step's cast and pyramid), so the
                    # body runs twice and the second run is read.
                    self._record(run, *scratch)
                    torch.cuda.synchronize(self.device)
                    begun = spans.clock()
                    self._record(run, *scratch)
                    torch.cuda.synchronize(self.device)
            finally:
                spans.stop()
            t0 = prof.profiler.kineto_results.trace_start_ns()
            events, links, _ = spans.trace_events(
                prof.profiler.kineto_results.events(), t0)
            maps[key] = device_stages(events, links, (begun - t0) / 1e3)
        return maps


def device_stages(events, links, after_us: float = -math.inf) -> list:
    """``[(name, stage), ...]`` of the device events of
    ``core.spans.trace_events``' ``(events, links)`` whose runtime call
    started from ``after_us`` on (an event with no call stays in), in the
    order they started, ``name`` by ``op_kind`` and ``stage`` the innermost
    ``stage.*`` range around the call, or None: ``StepGraphs.stage_map``'s
    arithmetic."""
    ranges = [(s, t, name) for kind, name, s, t in events
              if kind == "range" and name.startswith("stage.")]
    out = []
    device = [d for d, e in enumerate(events) if e[0] == "device"]
    for d in sorted(device, key=lambda d: events[d][2]):
        at = events[links[d]][2] if d in links else None
        if at is not None and at < after_us:
            continue
        inner = [r for r in ranges if at is not None and r[0] <= at <= r[1]]
        stage = min(inner, key=lambda r: r[1] - r[0])[2] if inner else None
        out.append((op_kind(events[d][1]), stage))
    return out


def op_kind(name: str) -> str:
    """A device op's name as a graph's replay and an op-by-op run both
    give it: a graph runs a device-to-device copy as a ``memcpy<bits>_post``
    kernel where an op-by-op run shows ``Memcpy DtoD``, so copies and fills
    are named by their kind alone."""
    low = name.lower()
    for kind in ("memcpy", "memset"):
        if low.startswith(kind):
            return kind
    return name
