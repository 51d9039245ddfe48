"""Tracing and profiling helpers (counterpart of ``utils/profiling.py``).

- ``span(name)`` and ``count(name, value)``: the program's spans and
  counters, one recorder for the process. Off, a span is one check and a
  shared null context. On while a ``torch.profiler`` records, or inside
  ``tracing()``: a span records its name, its parent span, the root span it
  belongs to (one id a request) and its host times at entry and exit, and
  where CUDA is initialized a pair of timing events on the current stream,
  taken from a pool, that give its stream interval. Inside the traced
  code nothing reads the device, launches a kernel or annotates the
  profiler's timeline. ``spans()`` and ``counters()`` resolve what the
  recorder holds: one ``synchronize``, then one anchor event recorded on
  the idle stream, whose host time puts every event on the host clock;
  ``clear()`` empties it. Times are nanoseconds of ``time.time_ns()``, the
  clock ``torch.profiler`` stamps its host events with;
- ``device_trace``: ``torch.profiler`` over the CPU and, where there is a
  card, CUDA activities, written as a Chrome trace (per-kernel device time)
  with the program's spans beside the profiler's events, and the device's
  longest idle gaps labelled by the program span open on the host;
- ``card``: the card's name and power limit, as ``nvidia-smi`` gives them,
  for the record of every time taken on it.
"""

from __future__ import annotations

import bisect
import contextlib
import itertools
import json
import os
import subprocess
import threading
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["Span", "span", "count", "tracing", "spans", "counters", "clear", "device_trace",
           "card"]

LIMIT = 1 << 16  # spans, and counter records, held at most until ``clear()``
IDLE_GAPS = 20   # the longest device idle gaps ``device_trace`` labels


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]  # the enclosing span's id, None for a root
    root: int              # the id of the root span it belongs to
    host_start: int        # ns, time.time_ns() at entry
    host_end: int          # ns, at exit
    stream_start: int      # ns on the same clock: when the stream reached the entry
    stream_end: int        # ns: when the stream reached the exit (the host's times off CUDA)
    self_ns: int           # stream duration less the part its child spans cover


class _Open:
    """One span being recorded: the context manager ``span`` returns when on."""

    __slots__ = ("name", "id", "parent", "root", "h0", "h1", "ev0", "ev1", "dev")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _REC.enter(self)
        return self

    def __exit__(self, *exc):
        _REC.exit(self)
        return False


class _Recorder:
    def __init__(self):
        self.forced = 0                     # depth of ``tracing()``
        self.ids = itertools.count()
        self.local = threading.local()      # each thread's stack of open spans
        self.pending: List[_Open] = []      # closed, not yet resolved
        self.resolved: List[Span] = []
        self.counts: List[tuple] = []       # (name, value) not yet summed
        self.totals: Dict[str, Any] = defaultdict(int)
        self.held = 0                       # spans recorded since ``clear()``
        self.dropped = 0                    # spans and counts past ``LIMIT``
        self.pool: Dict[int, List[torch.cuda.Event]] = defaultdict(list)

    def stack(self) -> List[_Open]:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def event(self, dev: int) -> torch.cuda.Event:
        pool = self.pool[dev]
        return pool.pop() if pool else torch.cuda.Event(enable_timing=True)

    def enter(self, o: _Open) -> None:
        stack = self.stack()
        o.id = next(self.ids)
        o.parent = stack[-1].id if stack else None
        o.root = stack[0].id if stack else o.id
        stack.append(o)
        o.ev0 = o.ev1 = None
        if torch.cuda.is_initialized():
            o.dev = torch.cuda.current_device()
            o.ev0, o.ev1 = self.event(o.dev), self.event(o.dev)
        o.h0 = time.time_ns()
        if o.ev0 is not None:
            o.ev0.record()

    def exit(self, o: _Open) -> None:
        o.h1 = time.time_ns()
        if o.ev1 is not None:
            o.ev1.record()
        stack = self.stack()
        if stack and stack[-1] is o:
            stack.pop()
        self.pending.append(o)

    def resolve(self) -> None:
        anchors = {}
        for dev in {o.dev for o in self.pending if o.ev0 is not None}:
            torch.cuda.synchronize(dev)
            with torch.cuda.device(dev):
                a = torch.cuda.Event(enable_timing=True)
                h = time.time_ns()
                a.record()
                a.synchronize()
            anchors[dev] = (a, h)
        new = []
        for o in self.pending:
            if o.ev0 is None:
                s0, s1 = o.h0, o.h1
            else:
                a, h = anchors[o.dev]
                s0 = h - round(o.ev0.elapsed_time(a) * 1e6)
                s1 = h - round(o.ev1.elapsed_time(a) * 1e6)
                self.pool[o.dev] += (o.ev0, o.ev1)
            new.append(Span(o.name, o.id, o.parent, o.root, o.h0, o.h1, s0, s1, s1 - s0))
        self.pending.clear()
        if new:
            self.resolved = _self_times(self.resolved + new)

    def sum_counts(self) -> None:
        memo: Dict[int, Any] = {}
        for name, v in self.counts:
            if callable(v):
                if id(v) not in memo:
                    memo[id(v)] = v()
                v = memo[id(v)]
            if isinstance(v, torch.Tensor):
                v = v.sum().item()
            self.totals[name] += v
        self.counts.clear()


def _self_times(spans: List[Span]) -> List[Span]:
    """``spans`` with ``self_ns``: each one's stream duration less the union
    of its children's stream intervals clipped to it."""
    kids: Dict[int, List[tuple]] = defaultdict(list)
    for s in spans:
        if s.parent is not None:
            kids[s.parent].append((s.stream_start, s.stream_end))
    out = []
    for s in spans:
        covered, reach = 0, s.stream_start
        for a, b in sorted(kids.get(s.id, ())):
            a, b = max(a, reach), min(b, s.stream_end)
            if b > a:
                covered += b - a
                reach = b
        out.append(s._replace(self_ns=s.stream_end - s.stream_start - covered))
    return out


_REC = _Recorder()
_NULL = contextlib.nullcontext()


def span(name: str):
    """A context manager around one layer's work; a shared null context
    while tracing is off."""
    if not (_REC.forced or _autograd_profiler._is_profiler_enabled):
        return _NULL
    if _REC.held >= LIMIT:
        _REC.dropped += 1
        return _NULL
    _REC.held += 1
    return _Open(name)


def count(name: str, value) -> None:
    """Add ``value`` to the counter ``name`` while tracing is on: a number,
    a tensor (summed, on its device, only when ``counters()`` reads it) or
    a function of no argument called then, once however often it was
    counted."""
    if not (_REC.forced or _autograd_profiler._is_profiler_enabled):
        return
    if len(_REC.counts) >= LIMIT:
        _REC.dropped += 1
        return
    _REC.counts.append((name, value))


@contextlib.contextmanager
def tracing() -> Iterator[None]:
    """Record spans and counters inside the block, with no profiler."""
    _REC.forced += 1
    try:
        yield
    finally:
        _REC.forced -= 1


def spans() -> List[Span]:
    """Every span closed since ``clear()``, in the order they closed."""
    _REC.resolve()
    return list(_REC.resolved)


def counters() -> Dict[str, Any]:
    """Each counter's total since ``clear()``; ``profiling.dropped``, the
    spans and counts not recorded because the recorder held ``LIMIT``."""
    _REC.sum_counts()
    return {**_REC.totals, "profiling.dropped": _REC.dropped}


def clear() -> None:
    """Forget every span and count recorded; open spans still close."""
    _REC.resolve()
    _REC.resolved, _REC.held, _REC.dropped = [], 0, 0
    _REC.counts.clear()
    _REC.totals.clear()


def card(device) -> str:
    """``"name, power limit"`` of the card of ``device`` (``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader``), or ``"cpu"``
    for the CPU, which has no device metric."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          f"--id={device.index or 0}"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip()


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _idle_gaps(device: List[tuple], host: List[Span], base_ns: int) -> List[dict]:
    """The longest gaps between the union of the ``device`` intervals (µs of
    the trace), each labelled with the innermost span open on the host when
    it began, or ``"none"``."""
    busy: List[List[float]] = []
    for a, b in sorted(device):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    by_start = sorted(host, key=lambda s: s.host_start)
    starts = [s.host_start for s in by_start]
    gaps = []
    for (_, end), (nxt, _) in zip(busy[:-1], busy[1:]):
        t = base_ns + round(end * 1e3)
        open_ = [s for s in by_start[:bisect.bisect_right(starts, t)] if s.host_end > t]
        label = max(open_, key=lambda s: s.host_start).name if open_ else "none"
        gaps.append({"span": label, "start_us": end, "ms": (nxt - end) * 1e-3})
    gaps.sort(key=lambda g: -g["ms"])
    return gaps[:IDLE_GAPS]


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[object]:
    """Profile the block with ``torch.profiler`` (CUDA activities too when a
    card is present) and write ``logdir/trace.json`` (Chrome trace format)
    with the block's program spans on two tracks of their own, ``host``
    and ``stream``, and ``logdir/idle_gaps.json``: the device's longest
    idle gaps, each labelled with the innermost program span open on the
    host when it began. Yields the profiler, whose ``key_averages()`` sum
    the time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    first = next(_REC.ids)  # every span of the block has a larger id
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    mine = [s for s in spans() if s.id > first]
    events = trace["traceEvents"]
    device = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
              if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
    for tid, a, b in (("host", "host_start", "host_end"), ("stream", "stream_start", "stream_end")):
        events.append({"ph": "M", "name": "thread_name", "pid": "program spans", "tid": tid,
                       "args": {"name": tid}})
        for s in mine:
            t0, t1 = getattr(s, a), getattr(s, b)
            events.append({"ph": "X", "cat": "program_span", "name": s.name,
                           "pid": "program spans", "tid": tid, "ts": (t0 - base) * 1e-3,
                           "dur": (t1 - t0) * 1e-3,
                           "args": {"id": s.id, "parent": s.parent, "root": s.root,
                                    "self_us": s.self_ns * 1e-3}})
    with open(path, "w") as f:
        json.dump(trace, f)
    with open(os.path.join(logdir, "idle_gaps.json"), "w") as f:
        json.dump(_idle_gaps(device, mine, base), f, indent=1)
