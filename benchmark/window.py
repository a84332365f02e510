"""What a measured window leaves behind, and the statistics taken over it.

Every call of the window is kept, so a rate is all the work over all the
time, and a tail is the tail of every call.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Call:
    start: float  # host clock, seconds
    end: float
    units: float  # what the call finished: audio seconds, or hardware blocks
    samples: int = 0  # input samples a channel (offline files)
    dispatch: float = 0.0  # host seconds until the program's call returned (enqueue)

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Window:
    start: float
    end: float
    calls: list = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def units(self) -> float:
        return sum(c.units for c in self.calls)


def quantile(values, q: float) -> float:
    """The q-quantile of every value, linear between order statistics
    (NumPy's default method)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    at = q * (len(v) - 1)
    lo = int(at)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (at - lo)


def median(values) -> float:
    return quantile(values, 0.5)


def spread(values) -> float:
    """Distance between the first and third quartiles as a share of the
    median, with the quartiles of `statistics.quantiles(values, n=4)`."""
    import statistics

    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
