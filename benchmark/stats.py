"""The arithmetic of the benchmark's numbers, apart from any device."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of every value, linear between closest
    ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: int, seconds: float) -> float:
    """Work completed per second over the whole window."""
    if seconds <= 0:
        raise ValueError("a window has positive length")
    return count / seconds


def union_length(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """The length of the union of the intervals, clipped to [lo, hi]."""
    spans = sorted((max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi)
    total, cur_a, cur_b = 0.0, None, None
    for a, b in spans:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers, in order."""
    out, t = [], lo
    for a, b in sorted(intervals):
        if b <= t:
            continue
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def norm_gap(program: float, reference: float, floor: float) -> float:
    """The gap between two norms over the larger of the reference's norm and
    `floor` (the median leaf's): 0 where they agree, 1 where the program's
    is 0 and the reference's is not."""
    return abs(program - reference) / max(reference, floor, 1e-30)
