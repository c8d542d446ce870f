"""Bounded, mergeable log-bucketed latency histogram (a copy of
``rapid_tpu/utils/histogram.py``: the port keeps its own, so it imports
nothing of the JAX package).

Upper bounds grow geometrically by sqrt(2) per bucket from 0.01 ms, so any
sample lands within a factor of sqrt(2) of its true value, memory is
O(NUM_BUCKETS) whatever the sample count, and two histograms merge by
bucket-wise addition. The schedule is a module constant shared by every
instance, the same as the JAX package's, so a summary written by either
package reads in the other.
"""

from __future__ import annotations

import math
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional

#: Geometric growth per bucket. sqrt(2) bounds any quantile's relative error
#: at ~41% while covering 0.01 ms .. ~9 hours in 64 buckets.
GROWTH = 2.0 ** 0.5

#: Upper bound of the first bucket, in milliseconds.
FIRST_UPPER_MS = 0.01

#: Finite buckets; one extra overflow bucket (index NUM_BUCKETS) plays the
#: Prometheus ``+Inf`` role.
NUM_BUCKETS = 64

#: The fixed schedule: ``UPPER_BOUNDS_MS[i]`` is the inclusive upper bound of
#: bucket i. Values above the last bound land in the overflow bucket.
UPPER_BOUNDS_MS = tuple(FIRST_UPPER_MS * GROWTH**i for i in range(NUM_BUCKETS))


def bucket_index(value_ms: float) -> int:
    """Index of the bucket holding ``value_ms`` (<= its upper bound);
    non-positive values fall into bucket 0, values past the last finite
    bound into the overflow bucket NUM_BUCKETS."""
    if value_ms <= FIRST_UPPER_MS:
        return 0
    return bisect_left(UPPER_BOUNDS_MS, value_ms)


class LogHistogram:
    """Fixed-schedule log-bucketed histogram of millisecond durations.

    Quantiles come back as the upper bound of the bucket containing the
    requested rank, clamped to the exact recorded max — so for any recorded
    distribution ``true_q <= quantile(q) <= true_q * GROWTH`` (the rank
    bound). ``merge`` adds
    bucket counts, counts, and sums, and takes the max of maxima: associative
    and commutative over everything except ``last`` (which is a display
    nicety, defined as the most recent operand's last sample).
    """

    __slots__ = ("_counts", "count", "sum", "max", "last")

    def __init__(self) -> None:
        self._counts: List[int] = [0] * (NUM_BUCKETS + 1)
        self.count = 0
        self.sum = 0.0
        self.max = 0.0
        self.last = 0.0

    def observe(self, value_ms: float) -> None:
        self._counts[bucket_index(value_ms)] += 1
        self.count += 1
        self.sum += value_ms
        if value_ms > self.max:
            self.max = value_ms
        self.last = value_ms

    # -- merging -------------------------------------------------------

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Fold ``other`` into self (in place); returns self for chaining."""
        for i, c in enumerate(other._counts):
            self._counts[i] += c
        self.count += other.count
        self.sum += other.sum
        if other.max > self.max:
            self.max = other.max
        if other.count:
            self.last = other.last
        return self

    @classmethod
    def merged(cls, histograms: Iterable["LogHistogram"]) -> "LogHistogram":
        out = cls()
        for hist in histograms:
            out.merge(hist)
        return out

    # -- quantiles -----------------------------------------------------

    def quantile(self, q: float) -> float:
        """The q-quantile (0 < q <= 1) as the containing bucket's upper
        bound, clamped to the exact max; 0.0 on an empty histogram."""
        if self.count == 0:
            return 0.0
        rank = min(self.count, max(1, math.ceil(q * self.count)))
        cumulative = 0
        for i, c in enumerate(self._counts):
            cumulative += c
            if cumulative >= rank:
                bound = UPPER_BOUNDS_MS[i] if i < NUM_BUCKETS else self.max
                return min(bound, self.max)
        return self.max  # unreachable: cumulative reaches count

    # -- snapshots -----------------------------------------------------

    def summary(self) -> Dict[str, object]:
        """JSON-ready bounded summary: headline quantiles plus the sparse
        bucket counts (``{index: count}``, string keys for JSON round-trip)
        the Prometheus renderer and cross-node mergers consume. Size is
        O(NUM_BUCKETS) no matter how many samples were recorded."""
        return {
            "count": self.count,
            "last": round(self.last, 3),
            "p50": round(self.quantile(0.50), 3),
            "p90": round(self.quantile(0.90), 3),
            "p99": round(self.quantile(0.99), 3),
            "max": round(self.max, 3),
            "sum": round(self.sum, 3),
            "buckets": {str(i): c for i, c in enumerate(self._counts) if c},
        }

    @classmethod
    def from_summary(cls, summary: Dict[str, object]) -> "LogHistogram":
        """Rebuild a mergeable histogram from a ``summary()`` dict (e.g. one
        loaded from a telemetry-snapshot JSON file). Tolerates missing keys:
        a legacy timer dict without buckets rebuilds as count-only."""
        out = cls()
        for key, c in (summary.get("buckets") or {}).items():
            idx = int(key)
            if 0 <= idx <= NUM_BUCKETS:
                out._counts[idx] += int(c)
        out.count = int(summary.get("count", 0))
        out.sum = float(summary.get("sum", 0.0))
        out.max = float(summary.get("max", 0.0))
        out.last = float(summary.get("last", 0.0))
        return out

    def cumulative_buckets(self) -> List[tuple]:
        """(upper_bound_ms, cumulative_count) pairs for Prometheus
        ``_bucket`` rendering: every finite bound up to the highest occupied
        bucket, then ``("+Inf", count)``. Cumulative counts make truncating
        the empty tail spec-valid — all omitted bounds equal the total."""
        out: List[tuple] = []
        highest = max((i for i, c in enumerate(self._counts) if c), default=-1)
        cumulative = 0
        for i in range(min(highest, NUM_BUCKETS - 1) + 1):
            cumulative += self._counts[i]
            out.append((UPPER_BOUNDS_MS[i], cumulative))
        out.append(("+Inf", self.count))
        return out


def cumulative_from_summary(summary: Dict[str, object]) -> Optional[List[tuple]]:
    """``cumulative_buckets()`` for a summary dict, or None when the dict
    carries no bucket data (a legacy snapshot)."""
    if "buckets" not in summary:
        return None
    return LogHistogram.from_summary(summary).cumulative_buckets()
