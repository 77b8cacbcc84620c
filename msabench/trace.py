"""The traced run's device record: kernel and copy intervals from the
profiler, the window they fall in, and the host spans they are set
against.

The window is bounded on the device by two marker kernels
(`torch.cuda._sleep`) launched right after a synchronise at each end, so
the device's clock bounds it and the host clock maps onto it.  Host
spans are the program's own stage timers (`utils/stats.GLOBAL`): each
`add(key, seconds)` is recorded with the host time it was called, as a
span [now - seconds, now] named by its key.
"""
from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

MARKER_CYCLES = 1000
_MARKER = re.compile(r"spin_kernel|_sleep", re.I)


@dataclass
class Trace:
    """Device intervals (name, start s, end s) inside the window, the
    window [start, end] s on the device's clock, and the host spans
    (name, start s, end s) on the same clock."""

    ops: list = field(default_factory=list)
    window: tuple = (0.0, 0.0)
    spans: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> list:
        """The union of the device intervals, merged, in order."""
        merged = []
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def time_of(self, pattern: str) -> float:
        """Device seconds of the operations whose name matches."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.ops if rx.search(n))

    def top_ops(self, n: int = 10) -> list:
        """[[short name, seconds], ...] of the operations that took most
        time, summed by name."""
        acc: dict[str, float] = {}
        for name, s, e in self.ops:
            acc[short_name(name)] = acc.get(short_name(name), 0.0) + e - s
        return [[k, v] for k, v in
                sorted(acc.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_span(self, n: int = 10) -> list:
        """[[span, seconds], ...]: the device's idle time inside the
        window, each gap split at the host spans' edges and its parts
        given to the innermost span that covers them ("no span" where
        none does), summed by name."""
        w0, w1 = self.window
        edges = [w0]
        for s, e in self.busy_intervals():
            edges += [max(s, w0), min(e, w1)]
        edges.append(w1)
        cuts = sorted({t for _, s, e in self.spans for t in (s, e)
                       if w0 < t < w1})
        acc: dict[str, float] = {}
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            inner = [t for t in cuts if a < t < b]
            for x, y in zip([a] + inner, inner + [b]):
                mid = 0.5 * (x + y)
                cover = [(e - s, name) for name, s, e in self.spans
                         if s <= mid <= e]
                name = min(cover)[1] if cover else "no span"
                acc[name] = acc.get(name, 0.0) + y - x
        return [[k, v] for k, v in
                sorted(acc.items(), key=lambda kv: -kv[1])[:n]]


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters ("Memcpy DtoH", "sweep_long_kernel", "cutlass::Kernel2")."""
    base = name.replace("(anonymous namespace)::", "").split("(")[0]
    depth, out = 0, []
    for ch in base:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    base = "".join(out).strip()
    if base.startswith("void "):
        base = base[5:]
    return (base or name)[:100]


class SpanRecorder:
    """Records the program's stage timers as host spans while active."""

    def __init__(self, stats):
        self.stats = stats
        self.spans: list = []
        self._add = None

    def __enter__(self):
        self._add = self.stats.add
        add, spans = self._add, self.spans

        def recording_add(key, value):
            now = time.perf_counter()
            spans.append((key, now - float(value), now))
            return add(key, value)

        self.stats.add = recording_add
        return self

    def __exit__(self, *exc):
        del self.stats.add      # the class's method again
        return False


class Profiled:
    """`torch.profiler` over the measured window, CUDA activity only,
    bounded by marker kernels; `trace()` reads it once it has stopped."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.host = [0.0, 0.0]

    def _marker(self, end: int) -> None:
        self.torch.cuda.synchronize()
        self.host[end] = time.perf_counter()
        self.torch.cuda._sleep(MARKER_CYCLES)
        self.torch.cuda.synchronize()

    def __enter__(self):
        p = self.torch.profiler
        self.prof = p.profile(activities=[p.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._marker(0)
        return self

    def __exit__(self, *exc):
        self._marker(1)
        self.prof.__exit__(*exc)
        return False

    def trace(self, spans=()) -> Trace:
        """The device intervals between the two markers, and `spans`
        (host perf_counter times) moved onto the device's clock."""
        ops = []
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() != self.torch.autograd.DeviceType.CUDA:
                continue
            if hasattr(ev, "start_ns"):
                s, d = ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9
            else:
                s, d = ev.start_us() * 1e-6, ev.duration_us() * 1e-6
            ops.append((ev.name(), s, s + d))
        marks = sorted(s for n, s, _ in ops if _MARKER.search(n))
        if len(marks) >= 2:
            w0, w1 = marks[0], marks[-1]
        else:
            w0 = min(s for _, s, _ in ops)
            w1 = max(e for _, _, e in ops)
        inside = [(n, max(s, w0), min(e, w1)) for n, s, e in ops
                  if not _MARKER.search(n) and e > w0 and s < w1]
        shift = w0 - self.host[0]
        return Trace(ops=inside, window=(w0, w1),
                     spans=[(n, s + shift, e + shift) for n, s, e in spans])
