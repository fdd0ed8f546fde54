"""Statistics counters, progress reporting, timers.

Capability parity with the reference statistics layer
(``/root/reference/include/mitsuba/core/statistics.h:85`` ``StatsCounter``,
``:73`` cache-line-padded per-thread slots, ``Statistics::printStats``,
``ProgressReporter``): a global registry of named counters grouped by
category, formatted report at exit or on demand, and a console progress
bar with throughput/ETA.

Wavefront reframe: the reference pads counters to cache lines so threads don't
false-share; here the hot loop is a jit-compiled program, so counters are
*derived* host-side from the statically known wavefront shapes (rays per
pass, lanes per launch) and from device scalars fetched lazily after each
pass — zero cost inside the compiled program.  Integrators that want
device-measured quantities (e.g. live lane fraction) accumulate them in
their carried state and publish via :func:`record`.  Under multi-chip
execution counters publish per-process and merge by simple addition (the
analog of the per-thread slot sum in ``StatsCounter::value()``).
"""
from __future__ import annotations

import sys
import time
import threading
from collections import OrderedDict

# counter types (statistics.h EStatsType)
NUMBER = 0
BYTES = 1
PERCENTAGE = 2
AVERAGE = 3
MINIMUM = 4
MAXIMUM = 5


class StatsCounter:
    """Named counter in a category; thread-safe increments host-side."""

    def __init__(self, category: str, name: str, ctype: int = NUMBER):
        self.category = category
        self.name = name
        self.ctype = ctype
        self._value = 0.0
        self._base = 0.0  # denominator for PERCENTAGE / AVERAGE
        self._lock = threading.Lock()
        if ctype == MINIMUM:
            self._value = float("inf")
        if ctype == MAXIMUM:
            self._value = float("-inf")
        _registry.register(self)

    def incr(self, amount=1.0, base=1.0):
        with self._lock:
            if self.ctype == MINIMUM:
                self._value = min(self._value, amount)
            elif self.ctype == MAXIMUM:
                self._value = max(self._value, amount)
            else:
                self._value += amount
                self._base += base

    __iadd__ = None  # use incr(); explicit beats operator magic under jit

    @property
    def value(self):
        return self._value

    @property
    def base(self):
        return self._base

    def reset(self):
        with self._lock:
            self._value = float("inf") if self.ctype == MINIMUM else (
                float("-inf") if self.ctype == MAXIMUM else 0.0)
            self._base = 0.0


class _Registry:
    def __init__(self):
        self._counters: "OrderedDict[tuple, StatsCounter]" = OrderedDict()
        self._lock = threading.Lock()

    def register(self, c: StatsCounter):
        with self._lock:
            self._counters[(c.category, c.name)] = c

    def get(self, category: str, name: str, ctype: int = NUMBER) -> StatsCounter:
        key = (category, name)
        with self._lock:
            if key in self._counters:
                return self._counters[key]
        return StatsCounter(category, name, ctype)

    def reset_all(self):
        for c in self._counters.values():
            c.reset()

    def counters(self):
        return list(self._counters.values())


_registry = _Registry()


def counter(category: str, name: str, ctype: int = NUMBER) -> StatsCounter:
    """Get-or-create a registered counter (Statistics::getInstance analog)."""
    return _registry.get(category, name, ctype)


def record(category: str, name: str, amount, base=1.0, ctype: int = NUMBER):
    """One-shot publish: fetches device scalars if needed and accumulates."""
    try:
        amount = float(amount)
    except TypeError:
        import numpy as np

        amount = float(np.asarray(amount))
    counter(category, name, ctype).incr(amount, base)


def _format_value(c: StatsCounter) -> str:
    v = c.value
    if c.ctype == BYTES:
        for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
            if abs(v) < 1024.0:
                return f"{v:.2f} {unit}"
            v /= 1024.0
        return f"{v:.2f} PiB"
    if c.ctype == PERCENTAGE:
        pct = 100.0 * c.value / c.base if c.base else 0.0
        return f"{pct:.2f} % ({c.value:.0f} / {c.base:.0f})"
    if c.ctype == AVERAGE:
        avg = c.value / c.base if c.base else 0.0
        return f"{avg:.3f} avg ({c.value:.0f} / {c.base:.0f})"
    if c.ctype in (MINIMUM, MAXIMUM):
        return f"{v:.3f}"
    if abs(v) >= 1e9:
        return f"{v / 1e9:.3f} G"
    if abs(v) >= 1e6:
        return f"{v / 1e6:.3f} M"
    if abs(v) >= 1e4:
        return f"{v / 1e3:.3f} K"
    return f"{v:.0f}"


def print_stats(file=None) -> str:
    """Formatted category report (Statistics::printStats analog)."""
    file = file or sys.stderr
    by_cat: "OrderedDict[str, list]" = OrderedDict()
    for c in _registry.counters():
        by_cat.setdefault(c.category, []).append(c)
    lines = ["  * Statistics:"]
    for cat, cs in by_cat.items():
        lines.append(f"    - {cat}:")
        for c in sorted(cs, key=lambda c: c.name):
            lines.append(f"        {c.name}: {_format_value(c)}")
    text = "\n".join(lines)
    print(text, file=file, flush=True)
    return text


def reset_stats():
    """Per-frame counter reset (the interactive loop's analog of
    ``im-mts/scene.cpp:360``)."""
    _registry.reset_all()


class Timer:
    """Wall-clock timer (core/timer.h)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()

    @property
    def seconds(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def milliseconds(self) -> float:
        return 1e3 * self.seconds


class ProgressReporter:
    """Console progress bar with throughput + ETA
    (core/statistics.h ProgressReporter)."""

    def __init__(self, title: str, total: int, stream=None, width: int = 40,
                 min_interval: float = 0.25):
        self.title = title
        self.total = max(int(total), 1)
        self.stream = stream if stream is not None else sys.stderr
        self.width = width
        self.min_interval = min_interval
        self._start = time.perf_counter()
        self._last = 0.0
        self._done = False

    def update(self, completed: int):
        now = time.perf_counter()
        if completed < self.total and now - self._last < self.min_interval:
            return
        self._last = now
        frac = min(completed / self.total, 1.0)
        filled = int(self.width * frac)
        bar = "+" * filled + "-" * (self.width - filled)
        elapsed = now - self._start
        eta = elapsed * (1 - frac) / frac if frac > 0 else 0.0
        self.stream.write(
            f"\r{self.title}: [{bar}] {100 * frac:5.1f}% "
            f"({elapsed:.1f}s, ETA: {eta:.1f}s)")
        if completed >= self.total and not self._done:
            self._done = True
            self.stream.write("\n")
        self.stream.flush()

    def finish(self):
        self.update(self.total)
