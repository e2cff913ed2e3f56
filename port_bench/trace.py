"""The device trace of a measured window, reduced in memory.

The profiler records device activity only, so the host runs as it does
untraced.  ``device_events`` gives (name, kind, start_ns, end_ns) rows:
``kind`` is ``kernel``, ``memcpy`` or ``memset`` for work on the device and
``annotation`` for a device-side copy of a host range (a
``record_function`` or ``Optimizer.step`` row, which spans the kernels
under it and is no device work).  ``reduce`` then gives:

- busy: the length of the UNION of the kernel, memcpy and memset
  intervals clipped to the window (overlapping work counts once;
  annotation rows never), and idle = 1 - busy / window;
- the device operations that took the most time, by name;
- the idle time by the length of its gaps (under 0.1 ms: launch gaps;
  0.1-1 ms; 1 ms and over: the host stalled or synchronised), the
  window's edges apart;
- device time by kernel name, for the kernels' roofline shares.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

Event = Tuple[str, str, int, int]
DEVICE_KINDS = ("kernel", "memcpy", "memset")
GAP_CLASSES = ((100_000, "idle gaps under 0.1 ms"),
               (1_000_000, "idle gaps of 0.1-1 ms"),
               (None, "idle gaps of 1 ms and over"))


def union_ns(intervals: Iterable[Tuple[int, int]], lo: int, hi: int
             ) -> Tuple[int, List[Tuple[int, int]]]:
    """Length of the union of ``intervals`` inside [lo, hi], and the
    merged intervals."""
    merged: List[Tuple[int, int]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return sum(e - s for s, e in merged), merged


def gap_class(ns: int) -> str:
    for limit, label in GAP_CLASSES:
        if limit is None or ns < limit:
            return label
    raise AssertionError


def reduce(events: Sequence[Event], lo: int, hi: int, top: int = 10
           ) -> dict:
    device = [(n, s, e) for n, k, s, e in events if k in DEVICE_KINDS]
    busy, merged = union_ns(((s, e) for _, s, e in device), lo, hi)
    by_name: Dict[str, int] = defaultdict(int)
    for n, s, e in device:
        by_name[n] += max(0, min(e, hi) - max(s, lo))
    gaps: Dict[str, int] = defaultdict(int)
    edges = [(lo, lo)] + merged + [(hi, hi)]
    for (_, prev_end), (start, _) in zip(edges, edges[1:]):
        if start > prev_end:
            edge = prev_end == lo or start == hi
            gaps["idle at the window's edges" if edge
                 else gap_class(start - prev_end)] += start - prev_end
    window = hi - lo
    return {
        "window_s": window / 1e9,
        "busy_s": busy / 1e9,
        "idle_share": 1.0 - busy / window if window > 0 else None,
        "device_ops": [[n, t / 1e9] for n, t in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[n, t / 1e9] for n, t in sorted(
            gaps.items(), key=lambda kv: -kv[1])[:top]],
        "kernel_ns": dict(by_name),
    }


def _kind(ev) -> str:
    from torch.autograd import DeviceType

    if ev.device_type() == DeviceType.CPU:
        return "cpu"
    if getattr(ev, "is_user_annotation", lambda: False)():
        return "annotation"
    activity = (str(ev.activity_type()).lower()
                if hasattr(ev, "activity_type") else "")
    name = ev.name().lower()
    if "annotation" in activity:
        return "annotation"
    if "memcpy" in name or "memcpy" in activity:
        return "memcpy"
    if "memset" in name or "memset" in activity:
        return "memset"
    return "kernel"


def device_events(prof) -> List[Event]:
    """The profiler's device events as (name, kind, start_ns, end_ns)."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        kind = _kind(ev)
        if kind == "cpu":
            continue
        start = ev.start_ns()
        out.append((ev.name(), kind, start, start + ev.duration_ns()))
    return out
