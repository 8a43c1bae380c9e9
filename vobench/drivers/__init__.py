"""How frames reach the program: one driver a file, ``drivers/<name>.py``,
found by the name a traffic file gives under ``driver``
(``cell.driver``), each set by the traffic file's other parameters.

A driver file defines ``Driver(vo, frames, config, traffic, seed)``.  Its
``run_pass(index)`` runs the traffic's frames once with draws from
``pass_seed(seed, index)`` and returns the pass's outputs as
``reference.check.Pass`` records, the frames it completed and what it
stamped on the host (``recoveries``; a closed loop's ``latency_ms``,
``ba`` flags and ``bootstrap_ms``).  Set-up runs the pass ``SETUP``.
"""
from __future__ import annotations

MASK64 = (1 << 64) - 1
SETUP = 0xFFFF  # the pass index of set-up's own draws


def pass_seed(seed: int, index: int) -> int:
    """A 31-bit run seed for pass ``index`` of a run seeded ``seed`` (any
    whole number), by SplitMix64: distinct passes and seeds draw apart."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(index) + 1) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return (x ^ (x >> 31)) & 0x7FFFFFFF
