"""Fixed-capacity slotted-table utilities (port of ``core/slots.py``).

Every table has a static capacity plus a validity mask; "append" is a
deterministic scatter of new rows into free slots.  Rows that found no slot
carry slot ``cap``; the scatters here drop them, as ``mode="drop"`` does in
the reference, by writing them to a scratch row past the end of the table.
That keeps every scatter free of host syncs (no boolean indexing).
"""
from __future__ import annotations

import torch


def alloc_slots(valid: torch.Tensor, new_mask: torch.Tensor):
    """Assign new items to free slots of a fixed-capacity table.

    Args:
      valid: (cap,) bool - currently occupied slots.
      new_mask: (n,) bool - which of the n offered items are real.

    Returns:
      slots: (n,) int64 - target slot per item; ``cap`` for items not
        accepted (dropped by the scatters below).
      accepted: (n,) bool - new_mask AND a free slot was available.
    """
    cap = valid.shape[0]
    # A STABLE argsort puts the free slots (False = 0) first, in ascending
    # index order: the deterministic free list of the reference.
    free_order = torch.argsort(valid.to(torch.int32), stable=True)
    n_free = torch.sum(~valid)
    rank = torch.cumsum(new_mask.to(torch.int64), 0) - 1
    accepted = new_mask & (rank < n_free)
    slots = torch.where(accepted, free_order[rank.clamp(0, cap - 1)],
                        torch.full_like(rank, cap))
    return slots, accepted


def _with_scratch_row(table: torch.Tensor) -> torch.Tensor:
    return torch.cat([table, table[:1]], 0)


def scatter_rows(table: torch.Tensor, slots: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """``table[slots[i]] = values[i]``; rows with slot == cap are dropped."""
    out = _with_scratch_row(table)
    out.index_put_((slots,), values.to(table.dtype))
    return out[:-1]


def scatter_add_rows(table: torch.Tensor, slots: torch.Tensor,
                     values: torch.Tensor) -> torch.Tensor:
    """``table[slots[i]] += values[i]``; rows with slot == cap are dropped."""
    out = _with_scratch_row(table)
    out.index_put_((slots,), values.to(table.dtype), accumulate=True)
    return out[:-1]


def stable_top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of a 1-D tensor, equal
    values in ascending index order: ``lax.top_k``'s order, which
    ``torch.topk`` does not promise."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def masked_top_k(scores: torch.Tensor, mask: torch.Tensor, k: int):
    """Top-k of ``scores`` restricted to ``mask``, equal scores in ascending
    index order (``lax.top_k``'s); returns (values, indices, valid)."""
    neg = torch.finfo(scores.dtype).min
    vals, idx = stable_top_k(torch.where(mask, scores, neg), k)
    return vals, idx, vals > neg
