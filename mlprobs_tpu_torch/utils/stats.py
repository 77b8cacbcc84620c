"""Timing and statistics registry: timers, steps, counters and spans.

Equivalent of the reference's observability stack: the [ELAPSED TIME]
print protocol (MLProbs.py), TIMER_* macros + StatisticsProvider
(QuickProbs Common/Timer.h, StatisticsProvider.h) and baseMSA's phase
timers (MSA.cpp:111-121).

Three kinds of record, all on `time.perf_counter()`:

* A **span** (`span(key)`, `sub(name)`) times one stage boundary.  On
  close it adds its seconds to the timer `key` through `self.add`, once a
  span.  Spans nest: the one opened with none open is a family's root and
  starts its trace; a span keyed without a dot is a *layer*, and `sub`
  keys its child `<layer>.<name>` by the innermost layer open.
* A **step** (`step(name)`) times one call inside a hot loop (a profile
  merge, a refinement pass).  It adds to the timer `<layer>.<step>`
  directly and never calls `add`, so a family at N = 48 makes a few
  dozen `add` calls, not thousands.
* A **counter** (`count(key, n)`) counts work or events.

While a sink is attached (`add_sink`), each span closed hands the sink
a record: key, id, parent id, trace id, start and end (s), and what the
counters and steps gained while it was open (`counts`, `steps` as
{key: [seconds, calls]}).  With no sink no record is made and a span
costs what a timer did.
"""
from __future__ import annotations

import contextlib
import itertools
import time
from collections import defaultdict


class _Step:
    """One timed call of a step; see `Stats.step`."""

    __slots__ = ("stats", "name", "t0")

    def __init__(self, stats: "Stats", name: str):
        self.stats = stats
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        st = self.stats
        key = (f"{st._open[-1][1]}.{self.name}" if st._open
               else self.name)
        st.timers[key] += time.perf_counter() - self.t0
        st.calls[key] += 1
        st.step_keys.add(key)
        return False


class Stats:
    """Process-wide timers (seconds and calls by key), counters and
    spans; see the module's docstring."""

    def __init__(self):
        self.timers: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)
        self.counters: dict[str, int] = defaultdict(int)
        self.step_keys: set[str] = set()
        self._sinks: list = []
        # open spans, outermost first: [key, layer, id, parent id, trace
        # id, start, snapshot of counters and steps or None]
        self._open: list = []
        self._ids = itertools.count(1)

    def add(self, key: str, value: float) -> None:
        self.timers[key] += value
        self.calls[key] += 1

    def count(self, key: str, n: int = 1) -> None:
        self.counters[key] += n

    def add_sink(self, fn) -> None:
        """Hand `fn(record)` every span closed from now on."""
        self._sinks.append(fn)

    def remove_sink(self, fn) -> None:
        self._sinks.remove(fn)

    def _snapshot(self) -> tuple[dict, dict]:
        return (dict(self.counters),
                {k: (self.timers[k], self.calls[k]) for k in self.step_keys})

    @contextlib.contextmanager
    def span(self, key: str):
        """Time the block as the span `key` (usable as a decorator)."""
        outer = self._open[-1] if self._open else None
        sid = next(self._ids)
        layer = key if "." not in key or outer is None else outer[1]
        entry = [key, layer, sid, outer[2] if outer else None,
                 outer[4] if outer else sid, time.perf_counter(),
                 self._snapshot() if self._sinks else None]
        self._open.append(entry)
        try:
            yield
        finally:
            end = time.perf_counter()
            self._open.pop()
            self.add(key, end - entry[5])
            if self._sinks and entry[6] is not None:
                self._emit(entry, end)

    @contextlib.contextmanager
    def sub(self, name: str):
        """A span keyed `<layer>.<name>` by the innermost layer open when
        it opens (`name` alone outside any span)."""
        with self.span(f"{self._open[-1][1]}.{name}" if self._open
                       else name):
            yield

    def step(self, name: str) -> _Step:
        """Time one call of a hot loop's step into the timer
        `<layer>.<name>` (`name` alone outside any span)."""
        return _Step(self, name)

    def _emit(self, entry: list, end: float) -> None:
        c0, s0 = entry[6]
        counts = {k: v - c0.get(k, 0) for k, v in self.counters.items()
                  if v != c0.get(k, 0)}
        steps = {}
        for k in self.step_keys:
            t, n = s0.get(k, (0.0, 0))
            if self.calls[k] != n:
                steps[k] = [self.timers[k] - t, self.calls[k] - n]
        rec = {"key": entry[0], "id": entry[2], "parent": entry[3],
               "trace": entry[4], "start": entry[5], "end": end,
               "counts": counts, "steps": steps}
        for fn in list(self._sinks):
            fn(rec)

    def to_dict(self) -> dict:
        out = {}
        for k, v in self.timers.items():
            out[f"time.{k}"] = v
            out[f"calls.{k}"] = self.calls[k]
        for k, v in self.counters.items():
            out[f"count.{k}"] = v
        return out

    def reset(self) -> None:
        """Clear timers and counters; sinks and open spans stay."""
        self.timers.clear()
        self.calls.clear()
        self.counters.clear()
        self.step_keys.clear()


def summary(records: list) -> dict:
    """{key: {calls, total_s, self_s, counts}} of span records: self
    time is a span's less its child spans'; counts are summed over the
    key's spans."""
    child_s: dict = defaultdict(float)
    for r in records:
        if r["parent"] is not None:
            child_s[r["parent"]] += r["end"] - r["start"]
    out: dict = {}
    for r in records:
        s = out.setdefault(r["key"], {"calls": 0, "total_s": 0.0,
                                      "self_s": 0.0, "counts": {}})
        dur = r["end"] - r["start"]
        s["calls"] += 1
        s["total_s"] += dur
        s["self_s"] += dur - child_s[r["id"]]
        for k, v in r["counts"].items():
            s["counts"][k] = s["counts"].get(k, 0) + v
    return out


GLOBAL = Stats()
