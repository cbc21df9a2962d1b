"""The device timeline of a traced window, read from ``torch.profiler``.

The traffic loops mark their window with ``record_function`` spans
(``jpegbench.window``, and ``jpegbench.steady`` from the first completed
work on), so the trace's own clock says where the window lies. Device
events are the card's kernels, copies and sets (the spans' mirrors on the
device's timeline left out); host events are those of the thread that
opened the window.
"""

from __future__ import annotations

import bisect
import contextlib
from typing import Dict, List, Optional, Tuple

WINDOW = "jpegbench.window"
STEADY = "jpegbench.steady"


def span(name: str, on: bool):
    """A ``record_function`` span while tracing, else nothing."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


def short(name: str) -> str:
    """A kernel's name without its argument list."""
    return name.split("(", 1)[0].strip()


def is_kernel(name: str) -> bool:
    """A device event that runs on the SMs (copies and sets run on the
    copy engines)."""
    return not name.startswith(("Memcpy", "Memset"))


def device_events(prof) -> List[Tuple[float, float, str]]:
    """The card's kernels, copies and sets in a profile, in microseconds.
    The loops' spans are mirrored on the device's timeline as
    annotations: they are no device work."""
    from torch.autograd import DeviceType

    return sorted((float(e.time_range.start), float(e.time_range.end), e.name) for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not (getattr(e, "is_user_annotation", False) or e.name.startswith("jpegbench.")))


def union_s(events, kernels_only: bool = False) -> float:
    spans = [(s, e) for s, e, n in events if not kernels_only or is_kernel(n)]
    return sum(e - s for s, e in _union(spans)) * 1e-6


def device_seconds(prof) -> Tuple[float, float]:
    """(kernel seconds, device seconds): the union of the card's kernel
    intervals, and of its kernel, copy and set intervals, in a profile
    whose every device event is the window's."""
    events = device_events(prof)
    return union_s(events, kernels_only=True), union_s(events)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Trace:
    """Device and host events of one profile, in microseconds."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        self.device = device_events(prof)
        host = [(float(e.time_range.start), float(e.time_range.end), e.name, e.thread)
                for e in prof.events() if e.device_type != DeviceType.CUDA]
        marks = {h[2]: h for h in host if h[2] in (WINDOW, STEADY)}
        win = marks.get(WINDOW)
        if win is None:
            raise RuntimeError(f"trace: no {WINDOW} span")
        self.window = (win[0], win[1])
        steady = marks.get(STEADY)
        self.slice = (steady[0], steady[1]) if steady else self.window
        self._main = sorted((h for h in host if h[3] == win[3]), key=lambda h: (h[0], -h[1]))
        self._segments = self._innermost()

    def kernels(self, fragment: str) -> List[float]:
        """Durations (seconds) of the device events whose name holds
        `fragment`, in the order they ran."""
        return [(e - s) * 1e-6 for s, e, n in self.device if fragment in n]

    def kernel_s(self) -> float:
        return union_s(self.device, kernels_only=True)

    def device_s(self) -> float:
        return union_s(self.device)

    def busy(self) -> List[Tuple[float, float]]:
        lo, hi = self.slice
        return [(max(s, lo), min(e, hi)) for s, e in _union([(s, e) for s, e, _n in self.device])
                if e > lo and s < hi]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-6

    def slice_s(self) -> float:
        return (self.slice[1] - self.slice[0]) * 1e-6

    def _innermost(self) -> Tuple[List[float], List[Optional[str]]]:
        """The window thread's innermost host event as a step function of
        time: (times, names), name None where no event is open."""
        times: List[float] = []
        names: List[Optional[str]] = []
        stack: List[Tuple[float, float, str, int]] = []

        def pop_until(t: float) -> None:
            while stack and stack[-1][1] <= t:
                end = stack.pop()[1]
                times.append(end)
                names.append(stack[-1][2] if stack else None)

        for ev in self._main:
            pop_until(ev[0])
            stack.append(ev)
            times.append(ev[0])
            names.append(ev[2])
        pop_until(float("inf"))
        return times, names

    def host_at(self, t: float) -> str:
        times, names = self._segments
        i = bisect.bisect_right(times, t) - 1
        return (names[i] if i >= 0 else None) or "no host event"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time in the slice, and the
        idle gaps in it summed by what the window's thread was doing at
        each gap's midpoint (its innermost open host event)."""
        lo, hi = self.slice
        ops: Dict[str, float] = {}
        for s, e, n in self.device:
            if e > lo and s < hi:
                ops[short(n)] = ops.get(short(n), 0.0) + (min(e, hi) - max(s, lo)) * 1e-6
        gaps: Dict[str, float] = {}
        prev = lo
        for s, e in self.busy() + [(hi, hi)]:
            if s > prev:
                what = self.host_at((prev + s) / 2)
                gaps[what] = gaps.get(what, 0.0) + (s - prev) * 1e-6
            prev = max(prev, e)
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}
