"""Spans around the benchmark's calls into the program, and the reduction
of a ``torch.profiler`` trace of the window to device time.

The profiler records CUDA activity only (kernels, copies and sets on the
card; CUPTI sees the port's ctypes-loaded kernels as well as PyTorch's).
Host spans are the benchmark's own, stamped with ``time.time_ns``, the
epoch clock the profiler's timestamps use, so an idle gap of the device is
put down to the span the host was in at its middle.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass, field

COPY_PREFIXES = ("Memcpy", "Memset")


class Spans:
    """In-memory host spans: ``(name, start_ns, end_ns)``."""

    def __init__(self):
        self.spans: list[tuple[str, int, int]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))

    def at(self, t_ns: int, default: str = "harness") -> str:
        """The span the host was in at ``t_ns`` (spans follow one another)."""
        i = bisect.bisect_right(self.spans, (t_ns, chr(0x10FFFF)),
                                key=lambda s: (s[1], s[0])) - 1
        if i >= 0 and self.spans[i][1] <= t_ns <= self.spans[i][2]:
            return self.spans[i][0]
        return default


def short_name(name: str) -> str:
    """A kernel's name without its return type and parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            name = name[:i]
            break
    name = name.strip()
    # PyTorch's kernels carry long lambda types: keep their template's name.
    return name.split("<")[0] if len(name) > 80 else name


@dataclass
class DeviceTrace:
    """Device time of one traced window."""
    window_ns: int
    busy_ns: int                       # union of device operations
    by_name: dict = field(default_factory=dict)    # short name -> ns
    launches: dict = field(default_factory=dict)   # short name -> count
    gaps: list = field(default_factory=list)       # (ns, host span)
    outside: int = 0                   # device operations outside the window

    def kernel_ns(self, *patterns: str) -> int:
        """Total ns of the operations whose name holds any of ``patterns``."""
        return sum(v for k, v in self.by_name.items()
                   if any(p in k for p in patterns))

    def kernels_ns_except(self, patterns) -> int:
        """Total ns of kernels (not copies or sets) whose name holds none of
        ``patterns``."""
        return sum(v for k, v in self.by_name.items()
                   if not k.startswith(COPY_PREFIXES)
                   and not any(p in k for p in patterns))

    def top_ops(self, n: int = 10) -> list:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]

    def top_gaps(self, n: int = 10) -> list:
        top = sorted(self.gaps, key=lambda g: -g[0])[:n]
        return [[name, ns / 1e9] for ns, name in top]


def profiler():
    """A profiler of the card's activity (nothing of the host's ops)."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def reduce(prof, spans: Spans, t0_ns: int, t1_ns: int) -> DeviceTrace | None:
    """The device time of ``prof``'s trace within ``[t0_ns, t1_ns]``;
    ``None`` when it holds no device operation (no card)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ivs = []
    by_name, launches = {}, {}
    outside = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        a = max(int(e.start_ns()), t0_ns)
        b = min(int(e.start_ns()) + int(e.duration_ns()), t1_ns)
        if b <= a:
            outside += 1
            continue
        name = short_name(e.name())
        by_name[name] = by_name.get(name, 0) + (b - a)
        launches[name] = launches.get(name, 0) + 1
        ivs.append((a, b))
    if not ivs:
        return None
    ivs.sort()
    busy, gaps = 0, []
    cur_a, cur_b = ivs[0]
    prev_end = t0_ns
    merged = []
    for a, b in ivs[1:]:
        if a <= cur_b:
            cur_b = max(cur_b, b)
        else:
            merged.append((cur_a, cur_b))
            cur_a, cur_b = a, b
    merged.append((cur_a, cur_b))
    for a, b in merged:
        busy += b - a
        if a > prev_end:
            gaps.append((a - prev_end, spans.at((a + prev_end) // 2)))
        prev_end = b
    if t1_ns > prev_end:
        gaps.append((t1_ns - prev_end, spans.at((t1_ns + prev_end) // 2)))
    return DeviceTrace(window_ns=t1_ns - t0_ns, busy_ns=busy,
                       by_name=by_name, launches=launches, gaps=gaps,
                       outside=outside)
