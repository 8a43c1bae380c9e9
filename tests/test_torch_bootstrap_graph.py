"""What lets the bootstrap, SIFT, the ratio match and the loop verifier's
chunk replay as CUDA graphs (``VisualOdometry.graphed``,
``pipeline/vo.py::GraphCache``), on the CPU.

* Each piece reads no device value on the host and makes no tensor from
  host data: run under ``tests/test_torch_step_graph.py``'s ``NoHostReads``
  with the default device ``meta``, bit for bit its own run without the
  mode: the first frame's pyramid and corners (``_first_frame``), a KLT
  hop (``_hop``: the next pyramid and ``_track_fb``) on each tracker, the
  geometry on an outside draw (``_geometry``), SIFT (``_sift``),
  ``match_ratio`` and ``posegraph_runner.verify_chunk``.  The library calls
  that wait on the device inside them on the card (``_HOST_WAITS``: torch's
  ``eigh`` and ``svd`` read their error codes on the host, below what a
  dispatch mode sees) are where a capture is split; the geometry and the
  chunk make only those, and the same number each time.
* The bootstrap's bank drawn outside (``bootstrap_draws``) and mapped onto
  the valid pairs inside (``select_minimal_sets``) equals the generator
  path bit for bit, as ``test_split_draw_equals_the_generator_path`` holds
  it for the step; ``bootstrap`` (its pieces through ``graphed``, on the CPU
  each run as is) equals ``bootstrap_eager`` on each tracker and on SIFT.
  The JAX parity of both bootstraps is held by ``tests/test_torch_vo.py``
  (the KLT slice) and ``tests/test_torch_sift_bootstrap.py``, which run
  through the same pieces.
* SIFT's binned sums on the CPU are bit for bit the reference order's
  ``scatter_add_`` (one scatter, corner-major); the card's fixed-order form
  (``_fixed_order``) agrees with them within float32 rounding and gives the
  same features.

Scene and config: ``tests/test_torch_vo.py``'s (the textured scene at
96x160, seed 7, 128-slot tables); SIFT on seed 9 (``tests/
test_torch_sift_bootstrap.py``'s) with 128 features.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from monocular_visual_odometry_va4mr_tpu.dataio import synthetic
from monocular_visual_odometry_va4mr_torch.core.camera import Camera
from monocular_visual_odometry_va4mr_torch.core.config import (
    kitti_tuned_config as t_kitti_tuned_config)
from monocular_visual_odometry_va4mr_torch.ops import match, ransac, sift
from monocular_visual_odometry_va4mr_torch.pipeline import posegraph_runner
from monocular_visual_odometry_va4mr_torch.pipeline import vo as vo_mod
from monocular_visual_odometry_va4mr_torch.pipeline.vo import VisualOdometry
from test_torch_step_graph import NoHostReads
from test_torch_vo import small_config

torch.set_num_threads(1)

STRIDE = 3


def scene_frames(seed=7, n=STRIDE + 1):
    scene = synthetic.make_textured_scene(seed=seed, num_frames=n,
                                          image_shape=(96, 160), step=1.0)
    return scene, [torch.as_tensor(scene.render(i)) for i in range(n)]


def make_vo(backend="pallas2", method="klt", sampler=None, seed=7):
    scene, frames = scene_frames(seed)
    cfg = small_config(t_kitti_tuned_config, backend).replace(
        bootstrap_method=method)
    return VisualOdometry(Camera.from_matrix(scene.K), cfg, "cpu",
                          sampler=sampler, seed=0), frames


def on_meta(fn, *args):
    """``fn(*args)`` under ``NoHostReads`` with the default device
    ``meta``."""
    torch.set_default_device("meta")
    try:
        with NoHostReads():
            return fn(*args)
    finally:
        torch.set_default_device(None)


def assert_same(out, ref):
    out, ref = list(out), list(ref)
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        assert a.device.type == "cpu" and a.dtype == b.dtype
        assert torch.equal(a, b) or (a.is_floating_point() and torch.equal(
            a.view(torch.int32), b.view(torch.int32)))


class HostWaits(TorchDispatchMode):
    """Counts the calls of ``_HOST_WAITS`` and of any other ``linalg``
    operation."""

    def __init__(self):
        super().__init__()
        self.waits, self.other = 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in vo_mod._HOST_WAITS:
            self.waits += 1
        elif "linalg" in str(func):
            self.other.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def chain():
    """A pallas2 VO, its first frame's outputs and the inputs of its first
    hop."""
    vo, frames = make_vo()
    *pyr0, uv0, valid = vo._first_frame(frames[0])
    return vo, frames, pyr0, uv0, valid


def test_first_frame_reads_nothing_on_the_host(chain):
    vo, frames, pyr0, uv0, valid = chain
    assert valid.sum() > 20
    assert_same(on_meta(vo._first_frame, frames[0]),
                vo._first_frame(frames[0]))


@pytest.mark.parametrize("backend", ["pallas2", "pallas", "xla"])
def test_hop_reads_nothing_on_the_host(backend):
    vo, frames = make_vo(backend)
    *pyr0, uv0, valid = vo._first_frame(frames[0])
    args = (*pyr0, frames[1], uv0, valid)
    eager = vo._hop(*args)
    assert eager[-1].sum() > 10
    assert_same(on_meta(vo._hop, *args), eager)


def hop_chain(vo, frames):
    *pyr, uv0, valid = vo._first_frame(frames[0])
    uv1 = uv0
    for image in frames[1:STRIDE + 1]:
        *pyr, uv1, valid = vo._hop(*pyr, image, uv1, valid)
    return uv0, uv1, valid, pyr


def test_geometry_reads_nothing_on_the_host(chain):
    vo, frames, *_ = chain
    uv0, uv1, valid, pyr1 = hop_chain(vo, frames)
    draws = vo.bootstrap_draws(torch.Generator().manual_seed(3))
    args = (uv0, uv1, valid, *pyr1, draws)
    eager = vo._geometry(*args)
    assert_same(on_meta(vo._geometry, *args), eager)
    # Where the card's capture is split: torch's eigh and svd, and no other
    # linalg call that waits on the device; the same count every run.
    counts = []
    for _ in range(2):
        mode = HostWaits()
        with mode:
            vo._geometry(*args)
        counts.append(mode.waits)
        assert set(mode.other) <= {"aten._linalg_det.default",
                                   "aten.linalg_cross.default",
                                   "aten.linalg_vector_norm.default",
                                   "aten._linalg_solve_ex.default",
                                   "aten.linalg_lu_factor_ex.default",
                                   "aten.linalg_lu_solve.default"}, mode.other
    assert counts[0] == counts[1] == 4


def test_split_bank_equals_the_generator_path():
    """The default sampler's draw, made before the geometry and selected
    inside it, against a sampler without a draw that is handed the
    generator (the path a replay cannot take): the same bootstrap."""
    vo, frames = make_vo()
    plain, _ = make_vo(sampler=lambda g, v, n, k:
                       ransac.sample_minimal_sets(g, v, n, k))
    assert vo._draw is not None and plain._draw is None
    a = vo.bootstrap(frames[0], frames[STRIDE],
                     intermediate=frames[1:STRIDE],
                     generator=torch.Generator().manual_seed(11))
    b = plain.bootstrap(frames[0], frames[STRIDE],
                        intermediate=frames[1:STRIDE],
                        generator=torch.Generator().manual_seed(11))
    assert int(a.status) == 0 and a.lm_valid.sum() > 8
    assert a.host_frame == b.host_frame == 1
    assert_same(a.tensors(), b.tensors())


@pytest.mark.parametrize("backend,method", [("pallas2", "klt"),
                                            ("pallas", "klt"),
                                            ("xla", "klt"),
                                            ("pallas2", "sift")])
def test_bootstrap_is_its_eager_form(backend, method):
    vo, frames = make_vo(backend, method, seed=9 if method == "sift" else 7)
    kw = dict(intermediate=frames[1:STRIDE])
    a = vo.bootstrap(frames[0], frames[STRIDE],
                     generator=torch.Generator().manual_seed(2), **kw)
    b = vo.bootstrap_eager(frames[0], frames[STRIDE],
                           generator=torch.Generator().manual_seed(2), **kw)
    assert a.host_frame == b.host_frame == 1
    assert_same(a.tensors(), b.tensors())
    assert vo.fn_graphs is None  # nothing is captured on the CPU


@pytest.fixture(scope="module")
def sift_inputs():
    vo, frames = make_vo(method="sift", seed=9)
    return vo, frames[0], frames[STRIDE]


def test_sift_and_match_read_nothing_on_the_host(sift_inputs):
    vo, f0, f1 = sift_inputs
    sift_fn = functools.partial(vo._sift, max_features=128)
    a, b = sift_fn(f0), sift_fn(f1)
    assert a[-1].sum() > 20
    assert_same(on_meta(sift_fn, f0), a)
    args = (a[4], a[5], b[4], b[5])
    eager = vo._match(*args)
    assert eager[1].sum() >= 16
    assert_same(on_meta(vo._match, *args), eager)
    # A chunk of pairs on a leading axis, as the verifier matches them.
    stacked = [torch.stack([x, x.flip(0)]) for x in args]
    ratio = functools.partial(match.match_ratio, ratio=0.8)
    assert_same(on_meta(ratio, *stacked), ratio(*stacked))


def test_verify_chunk_reads_nothing_on_the_host(sift_inputs):
    """The verifier's chunk body: matching, the banks selected from their
    draws onto the matches under ``torch.func.vmap``, and the geometry of
    every pair; it makes only the calls a capture is split at, as many
    each run."""
    vo, f0, f1 = sift_inputs
    feats = [sift.SiftFeatures(*vo._sift(f, 128)) for f in (f0, f1)]
    kfs = [posegraph_runner.Keyframe(0, 0, np.eye(4), f.uv.numpy(),
                                     f.desc.numpy(), f.valid.numpy())
           for f in feats]
    pairs = [(0, 1), (1, 0)] * (posegraph_runner.VERIFY_CHUNK // 2)
    inputs = posegraph_runner.chunk_inputs(kfs, pairs, "cpu")
    gen = torch.Generator().manual_seed(4)
    draws = torch.stack([ransac.draw_uniforms(gen, 300, 5) for _ in pairs])
    fn = functools.partial(posegraph_runner.verify_chunk, vo.cam, ratio=0.8,
                           threshold_px=1.5,
                           select=ransac.select_minimal_sets)
    eager = fn(*inputs, draws)
    assert eager[-2].min() >= 16  # matches in every pair
    assert_same(on_meta(fn, *inputs, draws), eager)
    mode = HostWaits()
    with mode:
        fn(*inputs, draws)
    assert mode.waits == 4
    # Each pair as verify_geometry computes it alone on its selected bank.
    idx1, mok = match.match_ratio(*inputs[2:], ratio=0.8)
    for ci in (0, 1):
        idx, ok = ransac.select_minimal_sets(draws[ci], mok[ci])
        u1m = inputs[1][ci][idx1[ci]]
        want = posegraph_runner.verify_geometry(
            vo.cam, inputs[0][ci], u1m, mok[ci], idx, ok, threshold_px=1.5)
        assert_same([t[ci] for t in eager[1:]], want)


def reference_sums(m, w, bins, val, idx):
    """The histogram and descriptor sums as the port computed them before
    the card's fixed order: one ``scatter_add_`` each, corner-major."""
    hist = torch.zeros((m.shape[0], 36), dtype=m.dtype)
    hist.scatter_add_(1, bins, m * w)
    desc = torch.zeros((val.shape[0], 128), dtype=val.dtype)
    desc.scatter_add_(1, idx, val)
    return hist, desc


def descriptor_terms(a, mw):
    """The descriptor's bins and values of orientation samples ``a`` (K,
    256) and weighted magnitudes ``mw`` (K, 256), as ``sift._descriptors``
    laid them out before the fixed order (per corner: iy * 32 + ix * 8 +
    io)."""
    import math

    dgrid = sift.imops.window_coords(16)
    cell = (dgrid + 8.0) / 4.0 - 0.5
    cx, cy = cell[:, 0], cell[:, 1]
    ob = (a / (2 * math.pi) + 1.5) * 8.0
    cx0, cy0, ob0 = torch.floor(cx), torch.floor(cy), torch.floor(ob)
    idx, val = [], []
    for dxc in (0, 1):
        for dyc in (0, 1):
            for dob in (0, 1):
                wx = 1 - (cx - cx0) if dxc == 0 else cx - cx0
                wy = 1 - (cy - cy0) if dyc == 0 else cy - cy0
                wo = 1 - (ob - ob0) if dob == 0 else ob - ob0
                ix = torch.clamp(cx0 + dxc, 0, 3).to(torch.int64)
                iy = torch.clamp(cy0 + dyc, 0, 3).to(torch.int64)
                io = torch.remainder(ob0.to(torch.int64) + dob, 8)
                inside = ((cx0 + dxc >= 0) & (cx0 + dxc <= 3)
                          & (cy0 + dyc >= 0) & (cy0 + dyc <= 3))
                idx.append((iy * 32 + ix * 8)[None] + io)
                val.append(torch.where(inside, mw * wx * wy * wo, 0.0))
    return torch.cat(idx, 1), torch.cat(val, 1)


@pytest.mark.parametrize("fixed", [False, True], ids=["cpu", "fixed_order"])
def test_sift_sums(fixed):
    """``_orientations`` and ``_descriptors`` on the CPU, with the CPU's
    scatter (bit for bit the reference order) and with the card's
    fixed-order form (within float32 rounding), against the scatter of the
    form before the fixed order existed, on random samples."""
    g = torch.Generator().manual_seed(5)
    L, H, W, K = 3, 40, 48, 64
    mag = torch.rand((L, H, W), generator=g) * 30
    ang = (torch.rand((L, H, W), generator=g) * 2 - 1) * np.pi
    li = torch.randint(0, L, (K,), generator=g)
    xy = torch.rand((K, 2), generator=g) * torch.tensor([W - 1.0, H - 1.0])
    sig = 1 + torch.rand(K, generator=g) * 2
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sift, "_fixed_order", lambda t: fixed)
        theta1, theta2, has2 = sift._orientations(mag, ang, li, xy, sig)
        desc = sift._descriptors(mag, ang, li, xy, sig, theta1)

    # The reference: the same samples, one scatter each.
    grid = sift.imops.window_coords(17)
    coords = xy[:, None, :] + grid[None] * (0.75 * sig)[:, None, None]
    m = sift._sample_levels(mag, li, coords)
    a = sift._sample_levels(ang, li, coords)
    w = torch.exp(-torch.sum((grid * 0.75) ** 2, -1) / (2 * (1.5 ** 2)))
    bins = torch.remainder(
        torch.floor((a / (2 * np.pi) + 0.5) * 36).to(torch.int64), 36)
    dgrid = sift.imops.window_coords(16)
    c, s_ = torch.cos(theta1), torch.sin(theta1)
    rot = torch.stack([torch.stack([c, -s_], -1),
                       torch.stack([s_, c], -1)], -2)
    dcoords = xy[:, None, :] + (dgrid @ rot.transpose(-1, -2)) * (
        0.4 * sig)[:, None, None]
    dm = sift._sample_levels(mag, li, dcoords)
    da = sift._sample_levels(ang, li, dcoords) - theta1[:, None]
    dw = torch.exp(-torch.sum(dgrid ** 2, -1) / (2 * 8.0 ** 2))
    idx, val = descriptor_terms(da, dm * dw)
    hist, raw = reference_sums(m, w, bins, val, idx)
    for _ in range(2):
        hist = (torch.roll(hist, 1, 1) + hist + torch.roll(hist, -1, 1)) / 3.0
    ref_theta = sift._peak_theta(hist, torch.argmax(hist, 1))
    v = raw / torch.clamp(torch.linalg.vector_norm(raw, dim=1),
                          min=1e-9)[:, None]
    v = torch.clamp(v, 0.0, 0.2)
    ref_desc = v / torch.clamp(torch.linalg.vector_norm(v, dim=1),
                               min=1e-9)[:, None]
    if fixed:
        torch.testing.assert_close(theta1, ref_theta, rtol=0, atol=1e-4)
        torch.testing.assert_close(desc, ref_desc, rtol=0, atol=1e-5)
    else:
        assert torch.equal(theta1, ref_theta)
        assert torch.equal(desc, ref_desc)


def test_fixed_order_sift_finds_the_same_features(sift_inputs):
    """``detect_and_compute`` with the card's fixed-order sums on the CPU:
    the same keypoints, orientations within 1e-4 rad, descriptors within
    1e-5; and two calls bit for bit alike."""
    _, f0, _ = sift_inputs
    ref = sift.detect_and_compute(f0, max_features=128)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sift, "_fixed_order", lambda t: True)
        out = sift.detect_and_compute(f0, max_features=128)
        again = sift.detect_and_compute(f0, max_features=128)
    assert_same(out, again)
    assert torch.equal(out.valid, ref.valid) and out.valid.sum() > 20
    assert torch.equal(out.uv, ref.uv)
    v = ref.valid
    torch.testing.assert_close(out.orientation[v], ref.orientation[v],
                               rtol=0, atol=1e-4)
    torch.testing.assert_close(out.desc[v], ref.desc[v], rtol=0, atol=1e-5)


def test_bank_features_are_the_vo_sift(sift_inputs):
    """``KeyframeBank._features`` (on the card a replay read back in one
    copy) is ``detect_and_compute`` with the config's knobs."""
    vo, f0, _ = sift_inputs
    bank = posegraph_runner.KeyframeBank(vo, max_features=96)
    uv, desc, valid = bank._features(f0.numpy())
    ref = sift.detect_and_compute(f0, max_features=96)
    assert np.array_equal(uv, ref.uv.numpy())
    assert np.array_equal(desc, ref.desc.numpy())
    assert np.array_equal(valid, ref.valid.numpy())


def test_loop_repeat_names_the_first_stage_that_differs():
    """``tools/diag_loop_repeat``'s comparison: bit for bit through tuples,
    NaN equal to NaN, and the first differing stage with its entries."""
    from monocular_visual_odometry_va4mr_torch.tools import diag_loop_repeat

    def record(desc_bump=0.0, refined=1.0):
        uv = np.array([[1.0, np.nan]], np.float32)
        return dict(features=[(uv, np.array([True]))] * 3,
                    descriptors=[np.zeros(4, np.float32) + desc_bump,
                                 np.zeros(4, np.float32)],
                    matches=[(np.arange(3), 2)], verification=[(None, 1)],
                    edges=[(0, 1, np.eye(3), np.ones(3), 40, 1.0, None)],
                    refined=np.full((2, 3), refined))

    same = diag_loop_repeat.first_difference
    assert same(record(), record()) is None
    assert same(record(), record(desc_bump=1e-7)) == dict(
        stage="descriptors", entries=1, lengths=[2, 2])
    assert same(record(), record(refined=2.0))["stage"] == "refined"
    summary = diag_loop_repeat.summary(record())
    assert summary == dict(keyframes=3, candidates=1, edges=1,
                           refined_finite=True)


@pytest.mark.parametrize("edges", [50, 400, 4000])
def test_gradient_put_adds_in_index_order_on_the_cpu(edges):
    """``backend/posegraph.py`` assembles the GN gradient by
    ``index_put_(accumulate=True)``, the card's fixed order; on the CPU, up
    to torch's grain of 32768 terms (4681 Sim(3) edges), it adds in index
    order, bit for bit the ``index_add_`` the gradient had before."""
    rng = np.random.default_rng(edges)
    idx = torch.from_numpy(rng.integers(0, 80, edges))
    terms = torch.from_numpy(
        (rng.standard_normal((edges, 7)) * 100).astype(np.float32))
    put = torch.zeros(80, 7).index_put_((idx,), terms, accumulate=True)
    add = torch.zeros(80, 7).index_add_(0, idx, terms)
    assert torch.equal(put, add)
