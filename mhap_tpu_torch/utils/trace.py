"""The port's tracer: named spans at its layer boundaries and each job's
counters, kept in memory; off unless a caller turns it on.

    from mhap_tpu_torch.utils import trace

    trace.enable()
    main(argv)                     # the CLI's span ``job`` is the root
    job, = trace.jobs()
    job.total("sketch"), job.self_time("sketch.chunk"), job.counters
    trace.disable()
    trace.reset()

The port marks a span with ``with trace.span(name):`` and adds to a
counter of the open job with ``trace.count(name, n)``.  Off, ``span``
returns one shared object whose enter and exit do nothing: no clock read,
no allocation, no record.  On, each span becomes a record ``Span(job, name,
parent, t0, t1)`` on ``time.perf_counter_ns()``.  The outermost open span
begins a job (in the CLI, ``job``); the spans under it share its id.
``jobs()`` returns the finished jobs' records.

With ``annotate(True)`` each span is also a
``torch.profiler.record_function`` range named ``mhap/<name>``: under
``torch.profiler`` it lands in the same trace, on the same clock, as the
kernels and copies, so that an idle gap of the device can be put down to
the span the host was in.

The tracer never waits for the device.  A span that queues device work
ends once the host has queued it.  The host's wait for that work falls in
the next span named ``<layer>.wait``: the port puts one around every call
that blocks the host until the card catches up (a copy between host and
device, a readback of a count or a size).

One thread: the spans of a job open and close on the thread that runs it.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import NamedTuple

_now = time.perf_counter_ns


class Span(NamedTuple):
    job: int     # the job's id
    name: str
    parent: int  # index of the parent in its job's spans; -1 at the root
    t0: int      # ns, time.perf_counter_ns()
    t1: int


class Job:
    """A finished job: its spans in the order they opened (the root
    first) and its counters."""

    def __init__(self, job_id: int):
        self.id = job_id
        self.spans: list = []
        self.counters: dict = {}

    def total(self, name: str) -> int:
        """Nanoseconds of the spans ``name``."""
        return sum(s.t1 - s.t0 for s in self.spans if s.name == name)

    def self_time(self, name: str) -> int:
        """Nanoseconds of the spans ``name`` less the parts of them that
        their child spans cover."""
        under = defaultdict(int)
        for s in self.spans:
            if s.parent >= 0:
                under[s.parent] += s.t1 - s.t0
        return sum(s.t1 - s.t0 - under[i]
                   for i, s in enumerate(self.spans) if s.name == name)


class _Off:
    """What ``span`` returns while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_counters(self, stats) -> None:
        pass


class _Tracer:
    def __init__(self):
        self.on = False
        self.range = None  # torch.profiler.record_function, annotating
        self.done = []     # finished jobs
        self.job = None    # the open job
        self.stack = []    # its open spans, as indexes into job.spans
        self.next_id = 0


_OFF = _Off()
_T = _Tracer()


class _Open:
    """A span of the tracer while it is on."""

    __slots__ = ("name", "i", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        t = _T
        if not t.stack:
            t.job = Job(t.next_id)
            t.next_id += 1
        self.i = len(t.job.spans)
        parent = t.stack[-1] if t.stack else -1
        t.stack.append(self.i)
        self.range = None
        if t.range is not None:
            self.range = t.range("mhap/" + self.name)
            self.range.__enter__()
        # (parent, t0) until the span closes
        t.job.spans.append((parent, _now()))
        return self

    def __exit__(self, *exc):
        t1 = _now()
        if self.range is not None:
            self.range.__exit__(*exc)
        t = _T
        job = t.job
        parent, t0 = job.spans[self.i]
        job.spans[self.i] = Span(job.id, self.name, parent, t0, t1)
        t.stack.pop()
        if not t.stack:
            t.done.append(job)
            t.job = None
        return False

    def set_counters(self, stats) -> None:
        """Copies the integer entries of the mapping ``stats`` into the
        job's counters."""
        _T.job.counters.update(
            (k, v) for k, v in stats.items() if isinstance(v, int))


def span(name: str):
    """A context manager that records the span ``name`` while the tracer
    is on; its ``set_counters(stats)`` copies a mapping's integer entries
    into the job's counters."""
    return _Open(name) if _T.on else _OFF


def count(name: str, n: int) -> None:
    """Adds ``n`` to the open job's counter ``name`` while the tracer is
    on; does nothing outside a job."""
    t = _T
    if t.on and t.job is not None:
        c = t.job.counters
        c[name] = c.get(name, 0) + n


def enable() -> None:
    _T.on = True


def disable() -> None:
    """Stops recording; spans open now still close into their job."""
    _T.on = False


def reset() -> None:
    """Drops the finished jobs."""
    _T.done = []


def jobs() -> list:
    """The finished jobs' records, oldest first."""
    return list(_T.done)


def annotate(flag: bool) -> None:
    """Marks each span recorded from now on as a ``torch.profiler`` range
    ``mhap/<name>`` as well (``flag`` True), or stops marking them."""
    if flag:
        from torch.profiler import record_function

        _T.range = record_function
    else:
        _T.range = None
