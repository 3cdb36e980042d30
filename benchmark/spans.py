"""The benchmark's own spans: wrappers installed by name around functions
of the program, timed on the host clock.

A span name is ``module:attribute.path``, the attribute being looked up
where the program calls it (a class's method, or a module's global that
the calling module reads at call time).  With ``sync`` each span waits
for the device before it ends, so that its time holds the device work it
queued; traced runs only.  With ``annotate`` each span is also a
``torch.profiler.record_function`` range named ``bench/<name>``, so that a
profiler trace can say which span the host was in.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import sys
import time
from collections import defaultdict


def resolve(name: str):
    """(owner, attribute) of a span name; raises if it names nothing."""
    mod, _, path = name.partition(":")
    owner = importlib.import_module(mod)
    *parts, attr = path.split(".")
    for p in parts:
        owner = getattr(owner, p)
    getattr(owner, attr)
    return owner, attr


class Spans:
    def __init__(self, names, sync=None, keep=()):
        self.names = list(dict.fromkeys(names))
        self.sync = sync
        self.keep = set(keep)
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)
        self.kept = defaultdict(list)
        self.annotate = False
        self.keeping = False
        self._saved = []
        self.missing = []

    def _wrap(self, name, fn):
        @functools.wraps(fn)
        def span(*args, **kwargs):
            ctx = contextlib.nullcontext()
            if self.annotate:
                import torch

                ctx = torch.profiler.record_function("bench/" + name)
            t0 = time.perf_counter()
            with ctx:
                try:
                    return fn(*args, **kwargs)
                finally:
                    if self.sync is not None:
                        self.sync()
                    self.seconds[name] += time.perf_counter() - t0
                    self.calls[name] += 1
                    if self.keeping and name in self.keep:
                        self.kept[name].append((args, kwargs))
        return span

    def install(self) -> None:
        """Wraps every span name that resolves.  A name that no longer
        names a function of the program is left out and reported, so
        that the metrics reading it read nothing, not the rest."""
        self.missing = []
        for name in self.names:
            try:
                owner, attr = resolve(name)
            except (ImportError, AttributeError) as e:
                self.missing.append(name)
                print(f"benchmark: span {name} not installed: {e!r}",
                      file=sys.stderr, flush=True)
                continue
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self._wrap(name, fn))

    def uninstall(self) -> None:
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()

    def reset(self) -> None:
        self.seconds.clear()
        self.calls.clear()
        self.kept.clear()
