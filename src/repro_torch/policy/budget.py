"""Equal-memory budget solver.

The paper's headline comparisons hold *total storage* fixed while varying
how the budget is spent (§5: "with the same number of real parameters").
Given a target total real-parameter count and the free slots' virtual
sizes, every free slot gets ``c_i = clip(c*, floor_i, cap_i)`` for one
common waterlevel ``c*``.  Unbounded slots therefore share one ratio —
proportional-to-size allocation of real parameters — while bounded slots
saturate at their floor/cap and the others absorb the difference.

``total(c*) = sum(v_i * clip(c*, lo_i, hi_i))`` is continuous and
nondecreasing in ``c*``, so the exact waterlevel is a 1-D root found by
bisection; whenever a feasible allocation exists it is hit exactly (up
to float precision, then HashedSpec bucket rounding).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

# (key, virtual_size, floor, cap) per free slot
FreeSlot = Tuple[object, int, float, float]


def solve(target_real: float, free: Sequence[FreeSlot], *,
          fixed_real: float = 0.0) -> Dict[object, float]:
    """Allocate per-slot compression ratios.

    target_real: desired total real params across ALL hashed slots.
    free:        slots the solver controls (pinned slots are accounted in
                 ``fixed_real`` and excluded).
    fixed_real:  real params already committed by pinned rules.

    Returns {key: compression}.  If floors force the total above target
    (or caps below), the result saturates at the bounds — the closest
    achievable allocation.
    """
    pool: List[FreeSlot] = [(k, int(v), float(lo), float(hi))
                            for k, v, lo, hi in free]
    if not pool:
        return {}
    remaining = max(float(target_real) - float(fixed_real), 0.0)

    def total(level: float) -> float:
        return sum(v * min(max(level, lo), hi) for _, v, lo, hi in pool)

    lo_level, hi_level = 0.0, max(hi for _, _, _, hi in pool)
    if total(lo_level) >= remaining:      # floors already overshoot
        level = lo_level
    elif total(hi_level) <= remaining:    # caps can't reach the target
        level = hi_level
    else:
        for _ in range(100):              # monotone bisection: exact c*
            mid = 0.5 * (lo_level + hi_level)
            if total(mid) < remaining:
                lo_level = mid
            else:
                hi_level = mid
        level = 0.5 * (lo_level + hi_level)
    return {k: min(max(level, lo), hi) for k, _, lo, hi in pool}
