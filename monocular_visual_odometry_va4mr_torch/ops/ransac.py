"""Fixed-budget RANSAC utilities (port of ``ops/ransac.py``).

The hypothesis bank is drawn up front and scored in parallel.  ``jax.random``
cannot be reproduced in torch, so the solvers (``ops/pnp.py``,
``ops/essential.py``) take the bank ``(idx, ok)`` as an argument;
``sample_minimal_sets`` draws one with a ``torch.Generator``, the same way the
reference draws its bank.  It is two halves: ``draw_uniforms``, the random
draw, and ``select_minimal_sets``, which maps the draw onto the valid rows
without the host.  The captured step (``pipeline/vo.py``) draws outside the
graph and maps inside it.
"""
from __future__ import annotations

import torch


def sample_minimal_sets(generator: torch.Generator, valid: torch.Tensor,
                        num_hypotheses: int, sample_size: int):
    """Draw ``num_hypotheses`` index tuples from the valid rows of a table:
    ``select_minimal_sets`` of ``draw_uniforms`` (``generator`` lies on
    ``valid``'s device).

    Returns idx (num_hypotheses, sample_size) int64 and ok (num_hypotheses,)
    bool."""
    return select_minimal_sets(
        draw_uniforms(generator, num_hypotheses, sample_size), valid)


def draw_uniforms(generator: torch.Generator, num_hypotheses: int,
                  sample_size: int) -> torch.Tensor:
    """The random half of ``sample_minimal_sets``: (num_hypotheses,
    sample_size) float32 uniforms in [0, 1) on ``generator``'s device."""
    return torch.rand((num_hypotheses, sample_size), generator=generator,
                      device=generator.device)


# The sampler's draw: ``VisualOdometry`` draws the step's bank with it before
# the step (``pipeline/vo.py``), as it does for any sampler that has one.
sample_minimal_sets.draw = draw_uniforms


def select_minimal_sets(u: torch.Tensor, valid: torch.Tensor):
    """The index tuples of the draw ``u`` (num_hypotheses, sample_size) over
    the valid rows of a table.

    Valid rows come first in a stable order, each tuple's uniforms are
    scaled to ints in [0, n_valid) and it is ok only if they are pairwise
    distinct and there are enough valid rows.  Nothing waits on the device
    for n_valid.

    Returns idx (num_hypotheses, sample_size) int64 and ok (num_hypotheses,)
    bool."""
    sample_size = u.shape[-1]
    order = torch.argsort((~valid).to(torch.int32), stable=True)
    n_valid = torch.sum(valid)
    hi = torch.clamp(n_valid, min=1)
    r = torch.minimum((u * hi).to(torch.int64), hi - 1)
    idx = order[r]
    eq = r[..., :, None] == r[..., None, :]
    eq = eq & ~torch.eye(sample_size, dtype=torch.bool, device=valid.device)
    distinct = ~torch.any(eq.flatten(-2), -1)
    ok = distinct & (n_valid >= sample_size)
    return idx, ok


def best_hypothesis(scores: torch.Tensor, ok: torch.Tensor):
    """Argmax (first maximum) of the scores over the bank.

    Returns (index, score, any_ok)."""
    masked = torch.where(ok, scores, torch.full_like(scores, -1))
    i = torch.argmax(masked)
    # A gather, not a 0-d index: nothing is read on the host.
    best = masked.gather(0, i.view(1))[0]
    return i, best, best >= 0
