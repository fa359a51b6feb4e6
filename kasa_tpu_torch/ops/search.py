"""Lexicographic lower bound over limb-encoded keys (port of
kasa_tpu/ops/search.py:30 searchsorted_limbs).

`lower_bound_plain` is the plain PyTorch version: a fixed number of
bisection steps for every query row at once, comparing int32 limbs
(non-negative 30-bit values) as kasa_tpu does.  On the card the same
lower bound is part of kernels K9 (csrc/classic_classify.cu) and K10
(csrc/join_match.cu), which narrow it through the classic tables'
prefix buckets and limb-0 runs (csrc/common.cuh lower_bound_full).

One difference from kasa_tpu: its bisect keeps stepping after lo == hi,
and a query above every key ends at n + 1 there (its gather clamps to
row n - 1); here it ends at n, the true lower bound.  Every caller reads
only whether the bound is below n.
"""

from __future__ import annotations

import torch


def num_steps_for(n: int) -> int:
    """Bisection steps that resolve a lower bound over n entries:
    the least s >= 1 with 2^s >= n + 1."""
    steps = 0
    while (1 << steps) < n + 1:
        steps += 1
    return max(steps, 1)


def _lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise a < b over (M, L) limbs (non-negative 30-bit values)."""
    less = torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
    decided = torch.zeros_like(less)
    for i in range(a.shape[1]):
        less |= ~decided & (a[:, i] < b[:, i])
        decided |= a[:, i] != b[:, i]
    return less


def lower_bound_plain(idx_limbs: torch.Tensor,
                      q: torch.Tensor) -> torch.Tensor:
    """(M,) int64 lower bound in [0, n] of each (M, L) query row in the
    sorted (n, L) index, by num_steps_for(n) bisection steps."""
    n = idx_limbs.shape[0]
    lo = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    hi = torch.full_like(lo, n)
    for _ in range(num_steps_for(n)):
        mid = (lo + hi) >> 1
        less = _lex_less(idx_limbs[mid.clamp(max=n - 1)], q)
        open_ = lo < hi
        lo = torch.where(open_ & less, mid + 1, lo)
        hi = torch.where(open_ & ~less, mid, hi)
    return lo
