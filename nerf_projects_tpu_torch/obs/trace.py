"""Spans and counters inside the port, on the clock of the device trace.

``span(name)`` marks a phase of the work as a context manager. A span
opened while no span is open is a root: one frame, view or step. The
spans opened inside it are its children and carry its index as their
unit. ``count`` and ``count_device`` add to named counters.

Recording is off unless ``start()`` turned it on, or a
``torch.profiler`` session records: the recorder follows the profiler,
so a profiled window (the benchmark's traced run, the operator's
``--profile_dir``) holds the program's spans beside the device's
operations. A recording that the profiler started ends at ``stop()``,
or is dropped at the first root span after the profiler stopped. Off,
``span`` reads a module global and the profiler's flag and returns one
shared object that does nothing: no allocation, no clock read, no torch
call.

While recording:

- host times are ``time.time_ns()``, the clock of the profiler's events;
- a span opened with ``device=True`` also records a CUDA event on the
  current stream at entry and at exit (a card only); its device
  milliseconds are resolved in ``stop()``;
- ``gc.callbacks`` records each collection as a ``py.gc`` span;
- ``host.syncs`` counts torch.cuda's sync-debug warnings raised inside
  a root span (the mode is set to "warn" where it was off), and
  ``Recording.sync_sites`` names their Python lines;
- ``alloc.device_mallocs`` is the change of the caching allocator's
  ``num_device_alloc`` from the first root span's entry to the last
  root span's exit.
"""
from __future__ import annotations

import gc
import time
import warnings
from dataclasses import dataclass, field

import torch

SYNC_WARNING = "synchronizing CUDA operation"


class _NoProfiler:
    _is_profiler_enabled = False


# torch.autograd.profiler keeps the profiler's state in a plain module
# flag for fast checks; an older torch without it is never followed
_PROFILER = torch.autograd.profiler if hasattr(torch.autograd.profiler, "_is_profiler_enabled") else _NoProfiler

_REC = None  # the live _Recorder, or None: recording is off


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Span:
    __slots__ = ("rec", "name", "device", "i")

    def __init__(self, rec, name, device):
        self.rec, self.name, self.device = rec, name, device

    def __enter__(self):
        self.i = self.rec.open(self.name, self.device)
        return self

    def __exit__(self, *exc):
        self.rec.close(self.i)
        return False


def span(name: str, device: bool = False):
    """A span named ``name`` around the enclosed block; ``device`` also
    times the block's work on the card's current stream."""
    rec = _REC
    if rec is None:
        if not _PROFILER._is_profiler_enabled:
            return OFF
        rec = _begin(follow=True)
    elif rec.follow and not rec.stack and not _PROFILER._is_profiler_enabled:
        stop()  # the profiler's session has ended, and so has its recording
        return OFF
    return _Span(rec, name, device)


def count(name: str, n=1) -> None:
    """Add the host number ``n`` to the counter ``name``."""
    if _REC is not None:
        _REC.counters[name] = _REC.counters.get(name, 0) + n


def count_device(name: str, t) -> None:
    """Add a 0-d device tensor, or what a callable of no arguments returns
    (called only while recording, so the off path launches nothing), to
    the counter ``name``, without waiting for the device."""
    rec = _REC
    if rec is None:
        return
    t = (t() if callable(t) else t).detach()
    prev = rec.device_counters.get(name)
    rec.device_counters[name] = t if prev is None else prev + t


def recording() -> bool:
    return _REC is not None


def start() -> None:
    """Turn recording on until ``stop()`` (a recording the profiler
    started is kept, and now ends at ``stop()`` alone)."""
    if _REC is None:
        _begin(follow=False)
    else:
        _REC.follow = False


def stop():
    """Turn recording off and return its ``Recording`` (None if it was
    off)."""
    global _REC
    rec, _REC = _REC, None
    return None if rec is None else rec.finish()


def _begin(follow: bool):
    global _REC
    _REC = _Recorder(follow)
    return _REC


class _Recorder:
    """What one recording collects, and the hooks it installs."""

    def __init__(self, follow: bool):
        self.follow = follow
        self.spans = []          # [name, start_ns, end_ns, parent, root]
        self.stack = []          # indices of the open spans
        self.events = {}         # device span index -> [start event, end event]
        self.gc_spans = []       # (start_ns, end_ns, parent)
        self.counters = {}
        self.device_counters = {}
        self.sync_sites = {}
        self.mallocs = None      # [at the first root's entry, at the last root's exit]
        self.cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        self._gc_t0 = None
        gc.callbacks.append(self._gc)
        self.watch_syncs, self._own_mode, self._warnings = False, False, None
        if self.cuda:
            if torch.cuda.get_sync_debug_mode() == 0:
                torch.cuda.set_sync_debug_mode("warn")
                self._own_mode = True
            self.watch_syncs = torch.cuda.get_sync_debug_mode() == 1
        if self.watch_syncs:
            # every sync warning reaches _warned; stop() puts the filters
            # and the handler back as they were
            self._warnings = warnings.catch_warnings()
            self._warnings.__enter__()
            self._show = warnings.showwarning
            warnings.showwarning = self._warned
            warnings.filterwarnings("always", message=".*" + SYNC_WARNING)

    # -- spans ---------------------------------------------------------------

    def open(self, name: str, device: bool) -> int:
        stack = self.stack
        i = len(self.spans)
        if stack:
            parent = stack[-1]
            root = self.spans[parent][4]
        else:
            parent, root = -1, i
            if self.cuda and self.mallocs is None:
                n = _device_allocs()
                self.mallocs = [n, n]
        rec = [name, 0, 0, parent, root]
        self.spans.append(rec)
        stack.append(i)
        if device and self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events[i] = [ev, None]
        rec[1] = time.time_ns()
        return i

    def close(self, i: int) -> None:
        self.spans[i][2] = time.time_ns()
        ev = self.events.get(i)
        if ev is not None:
            ev[1] = torch.cuda.Event(enable_timing=True)
            ev[1].record()
        self.stack.pop()
        if not self.stack and self.mallocs is not None:
            self.mallocs[1] = _device_allocs()

    # -- hooks ---------------------------------------------------------------

    def _gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_t0 = time.time_ns()
        elif self._gc_t0 is not None:
            self.gc_spans.append((self._gc_t0, time.time_ns(), self.stack[-1] if self.stack else -1))
            self._gc_t0 = None

    def _warned(self, message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message):
            if self.stack:
                self.counters["host.syncs"] = self.counters.get("host.syncs", 0) + 1
                site = f"{filename}:{lineno}"
                self.sync_sites[site] = self.sync_sites.get(site, 0) + 1
            if self._own_mode:  # a mode this recorder set: its warnings are counted, not shown
                return
        self._show(message, category, filename, lineno, file, line)

    def _uninstall(self) -> None:
        if self._gc in gc.callbacks:
            gc.callbacks.remove(self._gc)
        if self._warnings is not None:
            self._warnings.__exit__(None, None, None)
        if self._own_mode:
            torch.cuda.set_sync_debug_mode(0)

    # -- the end -------------------------------------------------------------

    def finish(self) -> "Recording":
        self._uninstall()
        if self.cuda:
            torch.cuda.synchronize()
        spans = [tuple(s) for s in self.spans]
        for t0, t1, parent in self.gc_spans:
            spans.append(("py.gc", t0, t1, parent, spans[parent][4] if parent >= 0 else -1))
        device_ms = {i: ev[0].elapsed_time(ev[1]) for i, ev in self.events.items() if ev[1] is not None}
        counters = dict(self.counters)
        for name, t in self.device_counters.items():
            counters[name] = counters.get(name, 0) + t.item()
        if self.mallocs is not None and self.mallocs[0] is not None:
            counters["alloc.device_mallocs"] = self.mallocs[1] - self.mallocs[0]
        return Recording(spans=spans, device_ms=device_ms, counters=counters, sync_sites=dict(self.sync_sites),
                         watched_syncs=self.watch_syncs)


def _device_allocs():
    return torch.cuda.memory_stats_as_nested_dict().get("num_device_alloc")


@dataclass
class Recording:
    """A finished recording. ``spans``: (name, start_ns, end_ns, parent,
    root), parent and root indexing this list (-1: none; a root's root is
    itself; ``py.gc`` spans are never roots). ``device_ms``: span index ->
    device milliseconds of a ``device=True`` span on a card.
    ``counters``: name -> number. ``sync_sites``: "file:line" -> host
    syncs counted there; ``watched_syncs``: whether syncs were watched."""

    spans: list
    device_ms: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    sync_sites: dict = field(default_factory=dict)
    watched_syncs: bool = False

    def __post_init__(self):
        self._children = {}
        for i, s in enumerate(self.spans):
            if s[3] >= 0:
                self._children.setdefault(s[3], []).append(i)

    def roots(self, name: str = None) -> list:
        return [i for i, s in enumerate(self.spans) if s[4] == i and (name is None or s[0] == name)]

    def select(self, name: str, under: str = None) -> list:
        """Indices of the spans named ``name``, with ``under`` only those
        whose root span is named ``under``."""
        sp = self.spans
        return [i for i, s in enumerate(sp)
                if s[0] == name and (under is None or (s[4] >= 0 and sp[s[4]][0] == under))]

    def self_ns(self, i: int) -> int:
        """The span's duration less the union of its children's intervals."""
        _, s, e, _, _ = self.spans[i]
        covered, at = 0, s
        for c0, c1 in sorted((max(self.spans[c][1], s), min(self.spans[c][2], e)) for c in self._children.get(i, ())):
            c0 = max(c0, at)
            if c1 > c0:
                covered += c1 - c0
                at = c1
        return (e - s) - covered

    def host_ms(self, name: str, under: str = None, self_time: bool = False) -> float:
        idx = self.select(name, under)
        if self_time:
            return sum(self.self_ns(i) for i in idx) / 1e6
        return sum(self.spans[i][2] - self.spans[i][1] for i in idx) / 1e6

    def device_total_ms(self, name: str, under: str = None) -> float:
        return sum(self.device_ms.get(i, 0.0) for i in self.select(name, under))

    def summary(self) -> dict:
        """name -> dict(count, host_ms, self_ms, device_ms), in first-seen order."""
        out = {}
        for i, (name, s, e, _, _) in enumerate(self.spans):
            row = out.setdefault(name, {"count": 0, "host_ms": 0.0, "self_ms": 0.0, "device_ms": 0.0})
            row["count"] += 1
            row["host_ms"] += (e - s) / 1e6
            row["self_ms"] += self.self_ns(i) / 1e6
            row["device_ms"] += self.device_ms.get(i, 0.0)
        return out

    def table(self) -> str:
        """The summary and the counters as text (``spans.txt``)."""
        lines = [f"{'span':<24} {'count':>8} {'host ms':>12} {'self ms':>12} {'device ms':>12}"]
        for name, r in self.summary().items():
            lines.append(f"{name:<24} {r['count']:>8} {r['host_ms']:>12.3f} {r['self_ms']:>12.3f} "
                         f"{r['device_ms']:>12.3f}")
        lines.append("")
        lines.append(f"{'counter':<24} {'value':>12}")
        for name, v in sorted(self.counters.items()):
            lines.append(f"{name:<24} {v:>12g}")
        for site, n in sorted(self.sync_sites.items(), key=lambda kv: -kv[1]):
            lines.append(f"host sync at {site}: {n}")
        return "\n".join(lines) + "\n"
