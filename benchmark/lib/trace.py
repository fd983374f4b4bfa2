"""What the device did in a traced window, from torch.profiler's events.

The window is the benchmark's own annotation "bench.window" (a host span
around the traced units).  Device activity is every event the profiler
records on the card (kernels, copies, sets; not the mirrors of the host's
annotations), clipped to the window.  Busy
time is the length of the union of those intervals, so that work that
overlaps on the card counts once; idle is the rest of the window.
"""

from __future__ import annotations

import dataclasses

WINDOW = "bench.window"


@dataclasses.dataclass
class Trace:
    window: tuple  # (start_ns, end_ns)
    device: list  # [(name, start_ns, end_ns)] clipped to the window
    host: list  # [(name, start_ns, end_ns)] host events inside the window

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return union_ns([(a, b) for _, a, b in self.device]) / 1e9

    def kernel_s(self, name_part: str) -> float:
        """summed device time of the events whose name holds `name_part`."""
        return sum(b - a for n, a, b in self.device if name_part in n) / 1e9


def from_profiler(prof) -> Trace:
    events = prof.profiler.kineto_results.events()
    window = None
    device, host = [], []
    for e in events:
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if str(e.device_type()).endswith("CUDA"):
            # the host's annotations are mirrored on the device's timeline
            if not (e.is_user_annotation() or name.startswith("bench.")):
                device.append((name, start, end))
        elif name == WINDOW:
            window = (start, end)
        else:
            host.append((name, start, end))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW} span")
    a, b = window
    device = [(n, max(s, a), min(e, b)) for n, s, e in device if e > a and s < b]
    host = [(n, s, e) for n, s, e in host if e > a and s < b]
    return Trace(window, device, host)


def union_ns(intervals) -> int:
    """the length covered by a set of (start, end) intervals."""
    total, reach = 0, None
    for s, e in sorted(intervals):
        if reach is None or s > reach:
            total += e - s
            reach = e
        elif e > reach:
            total += e - reach
            reach = e
    return total


def gaps(intervals, window) -> list:
    """the idle (start, end) stretches of the window between the intervals."""
    out, at = [], window[0]
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if window[1] > at:
        out.append((at, window[1]))
    return out


def breakdown(trace: Trace, top: int = 10) -> dict:
    """the device operations that took most time, and the longest idle gaps
    named by the innermost host event running at the gap's middle."""
    by_name = {}
    for n, a, b in trace.device:
        by_name[n] = by_name.get(n, 0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps([(a, b) for _, a, b in trace.device], trace.window),
                  key=lambda g: g[0] - g[1])[:top]
    named = []
    for s, e in idle:
        mid = (s + e) // 2
        around = [(b - a, n) for n, a, b in trace.host if a <= mid <= b]
        named.append([min(around)[1] if around else "host", (e - s) / 1e9])
    return dict(device_ops=[[n, t / 1e9] for n, t in ops], idle_gaps=named)
