"""What a ``torch.profiler`` trace of the profiled jobs says about the
device: its busy time, time by kernel, and the idle gaps with the span the
host was in during each.

The trace is the profiler's Chrome trace.  Device work is its events of
category ``kernel``, ``gpu_memcpy`` and ``gpu_memset``; the profiled
window is the ``bench/window`` range and the spans are the other
``bench/...`` ranges the spans module records.
"""

from __future__ import annotations

import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench/window"


def short(name: str) -> str:
    """A device operation's name without its return type, the anonymous
    namespace and its argument list (the first "(" outside a template's
    brackets)."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0 and i:
            name = name[:i]
            break
    return name.strip()[:120]


def bare(name: str) -> str:
    """A kernel's function name alone: ``min_reduce_kernel`` of
    ``void (anonymous namespace)::min_reduce_kernel<true>(...)``."""
    s = short(name)
    for ch in "<(":
        s = s.split(ch, 1)[0]
    return s


class Trace:
    def __init__(self, path: str):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        xs = [e for e in events if e.get("ph") == "X"]
        wins = [e for e in xs if e.get("name") == WINDOW
                and e.get("cat") == "user_annotation"]
        if not wins:
            raise ValueError("the trace holds no bench/window range")
        self.start = wins[0]["ts"]
        self.end = wins[0]["ts"] + wins[0]["dur"]
        self.device = [e for e in xs if e.get("cat") in DEVICE_CATS
                       and self.start <= e["ts"] < self.end]
        self.spans = [e for e in xs if e.get("cat") == "user_annotation"
                      and e["name"].startswith("bench/")
                      and e["name"] != WINDOW]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_intervals(self) -> list:
        """The union of device intervals in the window, merged, in us."""
        out = []
        for a, b in sorted((e["ts"], min(e["ts"] + e["dur"], self.end))
                           for e in self.device):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernel_seconds(self, names) -> float:
        """Device seconds of the kernels whose function is one of
        ``names``."""
        names = set(names)
        return sum(e["dur"] for e in self.device if e["cat"] == "kernel"
                   and bare(e["name"]) in names) / 1e6

    def top_ops(self, n: int = 10) -> list:
        by = defaultdict(float)
        for e in self.device:
            by[short(e["name"])] += e["dur"] / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_by_span(self, n: int = 10) -> list:
        """Idle device time of the window by the span the host was in
        (the innermost open one; "no span" outside them), the n largest,
        in seconds."""
        edges = sorted({self.start, self.end}
                       | {e["ts"] for e in self.spans}
                       | {e["ts"] + e["dur"] for e in self.spans})
        edges = [t for t in edges if self.start <= t <= self.end]
        busy = self.busy_intervals()
        by = defaultdict(float)
        j = 0
        for a, b in zip(edges[:-1], edges[1:]):
            idle = b - a
            while j < len(busy) and busy[j][1] <= a:
                j += 1
            k = j
            while k < len(busy) and busy[k][0] < b:
                idle -= min(b, busy[k][1]) - max(a, busy[k][0])
                k += 1
            if idle > 0:
                by[self.span_at((a + b) / 2)] += idle / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def span_at(self, t: float) -> str:
        """The innermost span open at time t, or "no span"."""
        best = None
        for e in self.spans:
            if e["ts"] <= t < e["ts"] + e["dur"] and (
                    best is None or e["ts"] >= best["ts"]):
                best = e
        return best["name"].split(":", 1)[-1] if best else "no span"
