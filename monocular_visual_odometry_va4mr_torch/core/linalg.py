"""Closed-form small-matrix helpers (port of ``core/linalg.py``).

Batched 2x2 / 3x3 inverses in adjugate form: pure elementwise arithmetic
over any leading batch shape, used by every small solve on the hot path.

``matmul``, ``einsum``, ``total``, ``solve``, ``power``, ``csqrt`` and
``cbrt`` stand for ``@``, ``torch.einsum``, ``sum``,
``torch.linalg.solve_ex``, ``**``, the complex square root and the real cube
root.  This module alone picks their form, by the tensor's device and
``exact()``, one of three:

* The card's batch-invariant forms, inside ``exact()`` (the batched step
  enters it on the card, ``pipeline/vo.py``): they round alike for any
  leading dimensions on the card, so a body run under ``torch.func.vmap``
  gives each slice bit for bit what it gives alone and a sequence's
  trajectory does not depend on its batch-mates.  A contraction is one
  broadcast product summed over the contracted indices, sums of more than
  ``SMALL_SUM`` terms taken by halving in elementwise adds; a solve is
  Gauss-Jordan elimination in elementwise operations, for the
  well-conditioned systems (damped normal equations) of the step; roots
  and powers are the polar form and ``**``.  The libraries would not do:
  on the card a batched product or factorisation picks another algorithm,
  and a reduction another split of its sum, by the batch's size.
  ``exact()`` selects these forms on the CPU too, where
  ``tests/test_torch_linalg.py`` holds them against the libraries.
* The CPU's forms, outside ``exact()``: batch-invariant on the CPU, where
  MKL's batched products, and ``atan2`` and fractional powers at a
  tensor's tail (past its last full vector, in scalar code), round a batch
  otherwise than its slices.  A contraction is the same broadcast product
  with the library's sums, a solve the library's (one factorisation per
  matrix there), a power and a cube root go through ``exp`` / ``log``, a
  complex square root through half angles.  The CPU's tests against the
  JAX package count inliers exactly over long runs, and two of them
  (``tests/test_torch_drivers.py``'s blackout recovery, the orbit run of
  ``tests/test_torch_posegraph_pipeline.py``) fail with forms like the
  card's (halving sums, Gauss-Jordan solves), so the CPU keeps these.
* The libraries' operations, on the card outside ``exact()``: a step run
  alone (``exact(False)``); fewer kernels.

``constant`` gives a small constant tensor on a device, made there once and
kept, so a captured step (``pipeline/vo.py``) reads it and copies nothing
from the host; ``kept`` does the same for a tensor made on the CPU by a
function, keyed by the caller.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

def constant(values, device) -> torch.Tensor:
    """The float32 tensor of the nested list ``values`` on ``device``, made
    at the first call for these values and device and the same tensor at
    every later one (``kept``).  Callers never write to it."""
    a = np.asarray(values, np.float32)
    return kept(("constant", a.shape, a.tobytes()), device,
                lambda: torch.from_numpy(a))


_KEPT = {}


def kept(key, device, make) -> torch.Tensor:
    """``make()``, a tensor made on the CPU, copied to ``device`` at the
    first call for ``key`` and ``device``, and the same tensor at every
    later one.  Callers never write to it."""
    device = torch.device("cpu" if device is None else device)
    if (key, device) not in _KEPT:
        _KEPT[key, device] = make().to(device)
    return _KEPT[key, device]


def _safe_det(det: torch.Tensor) -> torch.Tensor:
    return torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)


def inv2(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 2x2 inverse."""
    a, b = M[..., 0, 0], M[..., 0, 1]
    c, d = M[..., 1, 0], M[..., 1, 1]
    det = _safe_det(a * d - b * c)
    row0 = torch.stack([d, -b], -1)
    row1 = torch.stack([-c, a], -1)
    return torch.stack([row0, row1], -2) / det[..., None, None]


def inv3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = _safe_det(a * A + b * B + c * C)
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], -1),
        ],
        -2,
    )
    return adj / det[..., None, None]


def solve3(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 solve via the closed-form inverse."""
    return einsum("...ij,...j->...i", inv3(M), b)


_EXACT = threading.local()


@contextlib.contextmanager
def exact(on: bool = True):
    """Within it (when ``on``), the helpers below take the card's
    batch-invariant forms, on any device (see the module docstring)."""
    was = getattr(_EXACT, "on", False)
    _EXACT.on = on
    try:
        yield
    finally:
        _EXACT.on = was


def _form(t: torch.Tensor) -> str:
    """``"exact"``, ``"cpu"`` or ``"library"``: the form ``t`` takes (see
    the module docstring)."""
    if getattr(_EXACT, "on", False):
        return "exact"
    return "cpu" if t.device.type == "cpu" else "library"


# Sums of at most this many terms are the library's in the card's forms
# too: its kernel adds so few in one order whatever the batch
# (``tests/test_torch_cuda.py`` holds the batched step to batches of one bit
# for bit on the card).
SMALL_SUM = 16


def _halving_sum(x: torch.Tensor, first: int, count: int) -> torch.Tensor:
    """Sum of ``x`` over its dimensions ``first .. first + count - 1``: the
    library's for at most SMALL_SUM terms, else by halving, each pass adding
    the second half to the first, an elementwise add whose order no batch
    changes."""
    x = x.flatten(first, first + count - 1)
    if x.shape[first] <= SMALL_SUM:
        return x.sum(first)
    while x.shape[first] > 1:
        n = x.shape[first]
        h = n // 2
        y = x.narrow(first, 0, h) + x.narrow(first, h, h)
        x = torch.cat([y, x.narrow(first, 2 * h, 1)], first) if n % 2 else y
    return x.squeeze(first)


def total(x: torch.Tensor, dims) -> torch.Tensor:
    """``x.sum(dims)`` (see the module docstring)."""
    if _form(x) != "exact":
        return x.sum(dims)
    dims = sorted(d % x.dim() for d in (dims if isinstance(dims, tuple)
                                        else (dims,)))
    x = x.movedim(dims, tuple(range(len(dims))))
    return _halving_sum(x, 0, len(dims))


def matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A @ B`` for a matrix or vector ``B`` (see the module docstring)."""
    form = _form(A)
    if form == "library":
        return A @ B
    if form == "exact":
        return einsum("...ik,...k->...i" if B.dim() == 1
                      else "...ik,...kj->...ij", A, B)
    if B.dim() == 1:
        return (A * B).sum(-1)
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, *operands)`` (see the module docstring); each
    operand's subscripts are letters after an optional leading ``...``.
    Off the libraries, the operands are multiplied in turn, laid out as
    (the leading dimensions, the summed letters in order of appearance, the
    output's letters), and summed over the summed letters."""
    form = _form(operands[0])
    if form == "library":
        return torch.einsum(eq, *operands)
    lhs, out = eq.replace(" ", "").split("->")
    terms = lhs.split(",")
    out = out.replace("...", "")
    summed = [c for c in dict.fromkeys("".join(terms).replace(".", ""))
              if c not in out]
    order = "".join(summed) + out
    prod = None
    for t, term in zip(operands, terms):
        sub = term.replace("...", "")
        lead = t.dim() - len(sub)
        x = t.permute(*range(lead),
                      *(lead + sub.index(c) for c in order if c in sub))
        x = x.reshape(tuple(x.shape[:lead]) + tuple(
            t.shape[lead + sub.index(c)] if c in sub else 1 for c in order))
        prod = x if prod is None else prod * x
    if not summed:
        return prod
    first = prod.dim() - len(order)
    if form == "cpu":
        return prod.sum(tuple(range(first, first + len(summed))))
    return _halving_sum(prod, first, len(summed))


def solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.solve_ex(A, b)[0]`` for (..., n, n) systems without a
    pivot near zero (see the module docstring); a singular system gives
    non-finite values, as ``solve_ex`` does, instead of raising."""
    if _form(A) != "exact":
        return torch.linalg.solve_ex(A, b)[0]
    n = A.shape[-1]
    M = torch.cat([A, b[..., None]], -1)
    rows = torch.eye(n, dtype=torch.bool, device=A.device)[..., None]
    for k in range(n):
        pivot_row = M[..., k, :] / M[..., k, k:k + 1]
        M = torch.where(rows[k], pivot_row[..., None, :],
                        M - M[..., :, k:k + 1] * pivot_row[..., None, :])
    return M[..., :, n]


def power(x: torch.Tensor, p: float) -> torch.Tensor:
    """``x ** p`` for x >= 0 (see the module docstring)."""
    if _form(x) != "cpu":
        return x ** p
    return torch.exp(p * torch.log(x))


def csqrt(ar: torch.Tensor, ai: torch.Tensor):
    """Principal square root of the complex ``ar + i ai`` as (re, im) (see
    the module docstring).  The CPU's half-angle form gives the root's
    imaginary part the sign of ``ai``, -0.0 included, as the polar form's
    ``atan2`` branch does."""
    r = torch.sqrt(ar * ar + ai * ai)
    if _form(ar) == "cpu":
        re = torch.sqrt(torch.clamp((r + ar) * 0.5, min=0.0))
        im = torch.sqrt(torch.clamp((r - ar) * 0.5, min=0.0))
        return re, torch.copysign(im, ai)
    theta = torch.atan2(ai, ar) * 0.5
    s = torch.sqrt(r)
    return s * torch.cos(theta), s * torch.sin(theta)


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root (torch has none; see the module docstring)."""
    if _form(x) == "cpu":
        return torch.sign(x) * torch.exp(torch.log(torch.abs(x)) / 3.0)
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)
