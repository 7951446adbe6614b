"""Spans: the named steps of one map, timed on the host's clock and, where
the map runs on CUDA, on the device's, with no synchronize of their own.

A map (``pipeline.run``, ``run_streaming``, ``run_resilient``) opens a
:func:`scope` on its device; inside it :func:`span` (or the
:func:`spanned` decorator) opens a step.  A span records

* its dotted path: its name under the innermost span open in the same
  thread (``embed`` → ``embed.knn`` → ``embed.knn.probes``);
* its host start and end (``time.perf_counter_ns``);
* on a CUDA scope, two timing events recorded at entry and at exit on
  the stream that was current when the scope opened (the map's).  They
  are read (``elapsed_time``) only when the scope is resolved, after the
  map's closing synchronize, and then go back to a pool the thread
  reuses;
* while a profiler runs, a ``torch.profiler.record_function`` range
  ``sns:<path>``, which puts the span on the profile's timeline, on the
  device trace's clock (with none running the range is left out: it
  costs more than the rest of the span).

:meth:`Scope.seconds` resolves the scope: ``<path>``, host seconds, and
on CUDA ``<path>@device``, the device's seconds between the span's two
events; a span entered more than once adds up under one key.  Outside a
scope (a direct call of an embedder, a shard job's thread) :func:`span`
does nothing.

A span that ends a stage takes the stage's own synchronize (``sync=``):
its device end is recorded before the synchronize and its host end after
it, so the host seconds end in the device's completion, as the stage's
timer always has, and every event of the map is complete once its last
stage has synchronized.  Outside a scope such a span still synchronizes.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import Dict, List

import torch

_local = threading.local()
_NULL = contextlib.nullcontext()


def _current():
    return getattr(_local, "scope", None)


def _pool(device: torch.device) -> list:
    """This thread's free timing events on ``device``."""
    return _local.__dict__.setdefault("pools", {}).setdefault(device, [])


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Scope:
    """The spans of one map on ``device``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        # looked up once a scope: the stream's lookup costs more than an
        # event's record
        self.stream = torch.cuda.current_stream(self.device) \
            if self.cuda else None
        self.pool = _pool(self.device) if self.cuda else None
        self.stack: List[str] = []      # paths of the open spans
        # [path, start event, end event, host start ns, host ns] a span,
        # in the order they opened
        self.records: List[list] = []

    def _event(self):
        ev = self.pool.pop() if self.pool else \
            torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev

    def seconds(self) -> Dict[str, float]:
        """Each path's host seconds and, on CUDA, ``<path>@device``.  Call
        it after the map's closing synchronize: the events are read, not
        waited for."""
        out: Dict[str, float] = {}
        for path, e0, e1, _, ns in self.records:
            out[path] = out.get(path, 0.0) + ns / 1e9
            if e0 is not None:
                key = path + "@device"
                out[key] = out.get(key, 0.0) + e0.elapsed_time(e1) / 1e3
                self.pool += (e0, e1)
        self.records = []
        return out


class _Span:
    __slots__ = ("scope", "name", "sync", "rec", "rf")

    def __init__(self, scope: Scope, name: str, sync):
        self.scope, self.name, self.sync = scope, name, sync

    def __enter__(self):
        sc = self.scope
        path = f"{sc.stack[-1]}.{self.name}" if sc.stack else self.name
        sc.stack.append(path)
        self.rf = torch.profiler.record_function("sns:" + path) \
            if torch.autograd._profiler_enabled() else None
        if self.rf is not None:
            self.rf.__enter__()
        self.rec = [path, sc._event() if sc.cuda else None, None,
                    time.perf_counter_ns(), 0]
        sc.records.append(self.rec)
        return self

    def __exit__(self, *exc):
        sc, rec = self.scope, self.rec
        if sc.cuda:
            rec[2] = sc._event()
        if self.sync is not None:
            _synchronize(self.sync)
        rec[4] = time.perf_counter_ns() - rec[3]
        sc.stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class _SyncOnly:
    __slots__ = ("device",)

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        _synchronize(self.device)
        return False


def span(name: str, sync=None):
    """The step ``name`` under the innermost open span of this thread's
    scope; ``sync`` (a ``torch.device``) ends it in that device's
    synchronize.  Outside a scope: nothing, or the synchronize alone."""
    sc = _current()
    if sc is None:
        return _NULL if sync is None else _SyncOnly(sync)
    return _Span(sc, name, sync)


def spanned(name: str):
    """Decorator: every call of the function runs under ``span(name)``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


@contextlib.contextmanager
def scope(device):
    """The map's scope on ``device`` for this thread: spans opened inside
    it record into the :class:`Scope` it yields; a scope opened inside
    another stands alone until it closes."""
    prev = _current()
    sc = _local.scope = Scope(device)
    try:
        yield sc
    finally:
        _local.scope = prev
