"""``core/linalg.py``'s batch-invariant forms, the ones the batched step
runs on the card, against the libraries' operations at the step's shapes.

``linalg.exact()`` selects these forms on any device: contractions as one
broadcast product with sums over more than ``SMALL_SUM`` terms by halving,
Gauss-Jordan solves, the polar complex square root and ``**`` roots.  Each
is held here, on the CPU and (marked ``cuda``) on the card, against
``torch.einsum``, ``torch.linalg.solve_ex``, ``sum`` and numpy in float64
on the CPU, with float32 tolerances:

* contractions and sums: within 1e-5 of the sum of the terms' magnitudes
  (float32 products and pairwise sums of up to 2048 terms err by a few
  1e-7 of it);
* solves: the backward error ``|A x - b| / (|A| |x| + |b|)`` within 1e-5
  (a stable float32 solve of n <= 60 reaches a few 1e-7), and the error
  against the float64 solution at most 4x the float32 library solve's
  plus 1e-6 of the solution;
* roots and powers: within 2e-6 relative (a few float32 roundings).

The inputs are the in-step BA's (``tools/profile_ba.py``'s window: W = 10
poses, L = 256 landmarks, its damped 60x60 reduced camera system) and the
PnP refinement's (N = 1024 rows of (2, 6) Jacobians, its damped 6x6
system), made from a seed with numpy.  Each function is also run under
``torch.func.vmap`` over a batch of 3 and must give every slice what it
gives alone, bit for bit.  The cases run on the CPU and, marked ``cuda``,
on the card (skipped without one).  This file imports neither jax nor the
JAX package.
"""
import numpy as np
import pytest
import torch

from monocular_visual_odometry_va4mr_torch.backend import ba
from monocular_visual_odometry_va4mr_torch.core import linalg
from monocular_visual_odometry_va4mr_torch.tools import profile_ba

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]
SUM_TOL = 1e-5
BACKWARD_TOL = 1e-5
ROOT_TOL = 2e-6


@pytest.fixture(params=DEVICES)
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device(request.param)


def ba_terms(device):
    """The BA window's residuals, Jacobians and weights (r, Jc, Jp, w)."""
    win, cam = profile_ba.make_window(device)
    return ba._residuals_and_jacobians(win, cam, huber_px=3.0)


def pnp_terms(device, n=1024, seed=0):
    """PnP-refinement-like rows: weighted Jacobians (n, 2, 6), Jacobians,
    residuals (n, 2)."""
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(n, 2, 6)) * np.array([700.0, 700, 30, 5, 5, 700])
    w = rng.uniform(0.0, 1.0, size=(n, 1, 1))
    r = rng.normal(size=(n, 2)) * 2.0
    return [torch.from_numpy(a.astype(np.float32)).to(device)
            for a in (J * w, J, r)]


def ba_operands(device):
    """Every contraction of ``build_normal_blocks`` / ``apply_updates`` with
    its operands: {case: (equation, operands)}."""
    r, Jc, Jp, w = ba_terms(device)
    Hpp = torch.einsum("wl,wlai,wlaj->lij", w, Jp, Jp)
    Hpp_inv = linalg.inv3(Hpp + 1e-4 * torch.eye(3, device=device))
    Hcp = torch.einsum("wl,wlai,wlaj->wlij", w, Jc, Jp)
    HcpHpi = torch.einsum("wlij,ljk->wlik", Hcp, Hpp_inv)
    b_p = torch.einsum("wl,wlai,wla->li", w, Jp, r)
    delta = torch.from_numpy(np.random.default_rng(1).normal(
        size=(10, 6)).astype(np.float32) * 1e-2).to(device)
    Jw, J, rp = pnp_terms(device)
    return {
        "Hcc": ("wl,wlai,wlaj->wij", (w, Jc, Jc)),
        "Hpp": ("wl,wlai,wlaj->lij", (w, Jp, Jp)),
        "b_c": ("wl,wlai,wla->wi", (w, Jc, r)),
        "S": ("wlik,vljk->wvij", (HcpHpi, Hcp)),
        "rhs": ("wlik,lk->wi", (HcpHpi, b_p)),
        "HcpT_dc": ("wlij,wi->lj", (Hcp, delta)),
        "pnp_H": ("nij,nik->jk", (Jw, J)),
        "pnp_g": ("nij,ni->j", (Jw, rp)),
    }


def f64(t):
    return t.detach().double().cpu()


@pytest.mark.parametrize("case", ["Hcc", "Hpp", "b_c", "S", "rhs", "HcpT_dc",
                                  "pnp_H", "pnp_g"])
def test_einsum_matches_the_library(device, case):
    eq, ops = ba_operands(device)[case]
    with linalg.exact():
        got = linalg.einsum(eq, *ops)
    ref = torch.einsum(eq, *(f64(t) for t in ops))
    scale = torch.einsum(eq, *(f64(t).abs() for t in ops))
    lib = torch.einsum(eq, *ops)
    assert got.shape == lib.shape and got.dtype == torch.float32
    err = (f64(got) - ref).abs()
    assert bool((err <= SUM_TOL * scale + 1e-30).all()), float(
        (err / scale.clamp(min=1e-30)).max())
    # vmap over a batch of 3 copies, the second scaled: each slice alone.
    batch = [torch.stack([t, 2.0 * t, t.flip(0)]) for t in ops]
    with linalg.exact():
        mapped = torch.func.vmap(lambda *a: linalg.einsum(eq, *a))(*batch)
        alone = [linalg.einsum(eq, *(b[k] for b in batch)) for k in range(3)]
    for k in range(3):
        assert torch.equal(mapped[k], alone[k]), (case, k)


def test_matmul_and_total_match_the_library(device):
    r, Jc, Jp, w = ba_terms(device)
    A = Jc[..., :, :3]  # (W, L, 2, 3)
    B = Jp.transpose(-1, -2)  # (W, L, 3, 2)
    v = Jp[0, 0, 0].contiguous()  # (3,)
    cost = w * torch.sum(r * r, -1)  # BA's cost terms, (W, L)
    with linalg.exact():
        got_mm = linalg.matmul(A, B)
        got_mv = linalg.matmul(A, v)
        got_sum = linalg.total(cost, (0, 1))
        got_sum1 = linalg.total(Jc, (1, 3))
    for got, ref, scale in (
            (got_mm, f64(A) @ f64(B), f64(A).abs() @ f64(B).abs()),
            (got_mv, f64(A) @ f64(v), f64(A).abs() @ f64(v).abs()),
            (got_sum, f64(cost).sum(), f64(cost).abs().sum()),
            (got_sum1, f64(Jc).sum((1, 3)), f64(Jc).abs().sum((1, 3)))):
        assert got.shape == ref.shape
        err = (f64(got) - ref).abs()
        assert bool((err <= SUM_TOL * scale + 1e-30).all())
    batch = torch.stack([cost, cost.flip(1), 3.0 * cost])
    with linalg.exact():
        mapped = torch.func.vmap(lambda c: linalg.total(c, (0, 1)))(batch)
        alone = [linalg.total(batch[k], (0, 1)) for k in range(3)]
    assert all(torch.equal(mapped[k], alone[k]) for k in range(3))


def camera_system(device):
    """The BA window's damped reduced camera system as
    ``ba.solve_camera_system`` assembles it: (60x60 matrix, right side)."""
    win, cam = profile_ba.make_window(device)
    S, rhs, *_ = ba.build_normal_blocks(win, cam)
    W, n_fixed = rhs.shape[0], 2
    S = S.clone()
    S[:n_fixed] = 0.0
    S[:, :n_fixed] = 0.0
    for i in range(n_fixed):
        S[i, i] = torch.eye(6, device=device)
    rhs = rhs.clone()
    rhs[:n_fixed] = 0.0
    return S.permute(0, 2, 1, 3).reshape(6 * W, 6 * W), -rhs.reshape(-1)


def pnp_system(device):
    """The PnP refinement's damped 6x6 system (H, g)."""
    Jw, J, r = pnp_terms(device)
    H = torch.einsum("nij,nik->jk", Jw, J) + 1e-6 * torch.eye(6, device=device)
    return H, torch.einsum("nij,ni->j", Jw, r)


@pytest.mark.parametrize("system", ["ba_60", "pnp_6"])
def test_solve_matches_the_library(device, system):
    A, b = (camera_system if system == "ba_60" else pnp_system)(device)
    with linalg.exact():
        x = linalg.solve(A, b)
    lib = torch.linalg.solve_ex(A, b)[0]
    A64, b64 = f64(A), f64(b)
    ref = torch.linalg.solve(A64, b64)
    backward = ((A64 @ f64(x) - b64).abs().max()
                / (A64.abs().sum(1).max() * f64(x).abs().max()
                   + b64.abs().max()))
    assert float(backward) <= BACKWARD_TOL
    err = float((f64(x) - ref).abs().max())
    err_lib = float((f64(lib) - ref).abs().max())
    assert err <= 4.0 * err_lib + 1e-6 * float(ref.abs().max()), (err,
                                                                 err_lib)
    batch_A = torch.stack([A, 2.0 * A, A])
    batch_b = torch.stack([b, b, -b])
    with linalg.exact():
        mapped = torch.func.vmap(linalg.solve)(batch_A, batch_b)
        alone = [linalg.solve(batch_A[k], batch_b[k]) for k in range(3)]
    assert all(torch.equal(mapped[k], alone[k]) for k in range(3))


def test_roots_and_powers_match_the_library(device):
    rng = np.random.default_rng(2)
    re = rng.normal(size=4096) * 10.0 ** rng.uniform(-3, 3, size=4096)
    im = rng.normal(size=4096) * 10.0 ** rng.uniform(-3, 3, size=4096)
    im[:64] = 0.0  # real arguments, both signs
    im[64:128] = -0.0
    pos = np.abs(re) + 1e-6
    t = [torch.from_numpy(a.astype(np.float32)).to(device)
         for a in (re, im, pos)]
    with linalg.exact():
        sr, si = linalg.csqrt(t[0], t[1])
        cb = linalg.cbrt(t[0])
        pw = linalg.power(t[2], 0.75)
    z = np.empty(4096, np.complex128)  # -0.0 kept in the imaginary parts
    z.real, z.imag = f64(t[0]).numpy(), f64(t[1]).numpy()
    ref = np.sqrt(z)
    mag = np.abs(ref)
    assert np.all(np.abs(f64(sr).numpy() - ref.real) <= ROOT_TOL * mag)
    assert np.all(np.abs(f64(si).numpy() - ref.imag) <= ROOT_TOL * mag)
    # The polar form's branch: the root's imaginary part has im's sign.
    assert torch.equal(torch.signbit(si[:128]), torch.signbit(t[1][:128]))
    x = f64(t[0]).numpy()
    assert np.allclose(f64(cb).numpy(), np.cbrt(x), rtol=ROOT_TOL, atol=0)
    assert np.allclose(f64(pw).numpy(), f64(t[2]).numpy() ** 0.75,
                       rtol=ROOT_TOL, atol=0)
    batch = torch.stack([t[0], t[0].flip(0), -t[0]])
    with linalg.exact():
        mapped = torch.func.vmap(linalg.cbrt)(batch)
        mapped_sq = torch.func.vmap(linalg.csqrt)(batch, batch.flip(1))
        for k in range(3):
            assert torch.equal(mapped[k], linalg.cbrt(batch[k]))
            alone = linalg.csqrt(batch[k], batch[k].flip(0))
            assert torch.equal(mapped_sq[0][k], alone[0])
            assert torch.equal(mapped_sq[1][k], alone[1])
