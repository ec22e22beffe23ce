"""Device busy time from a trace's intervals.

A profiler trace lists one (start, end) interval for every kernel, copy and
memset the device ran. Adding their durations counts twice any two that ran
at once (kernels on other streams, a copy beside a kernel), so the sum can
exceed the time the trace spans. The time the device was busy is the length
of the union of the intervals: sort them by start, merge those that overlap
or touch, and add the merged lengths.
"""
from __future__ import annotations


def busy_union_ms(intervals) -> float:
    """Length of the union of (start, end) intervals, in the unit they are
    given in (ms for `chip_smoke.py`); 0.0 for no intervals."""
    total = 0.0
    cur_start = cur_end = None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        elif end > cur_end:
            cur_end = end
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def window_ms(intervals) -> float:
    """From the first interval's start to the last one's end; 0.0 for none."""
    intervals = list(intervals)
    if not intervals:
        return 0.0
    return max(e for _, e in intervals) - min(s for s, _ in intervals)
