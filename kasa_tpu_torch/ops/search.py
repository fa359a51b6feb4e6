"""Search helpers (port of the host part of kasa_tpu/ops/search.py).

The vectorised limb search itself (kasa_tpu's searchsorted_limbs) serves
the join engine, a later slice; the classic engine's search lives in
kernel K9 (csrc/classic_classify.cu) and its plain version
(match/device.py)."""

from __future__ import annotations


def num_steps_for(n: int) -> int:
    """Bisection steps that resolve a lower bound over n entries:
    the least s >= 1 with 2^s >= n + 1."""
    steps = 0
    while (1 << steps) < n + 1:
        steps += 1
    return max(steps, 1)
