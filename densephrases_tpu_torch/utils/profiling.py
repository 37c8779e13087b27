"""The port's tracer: spans and counters along the serve path, and the
profiler trace that shows them above the device's lanes.

Off by default. ``enable()`` installs a ``Recorder``; while one is
installed, ``span(name, **attrs)`` records the name, host start and end,
the enclosing span and the request id of each block it wraps, and
``count(name, n)`` keeps ``n`` (a host int, or a 0-d device tensor kept as
it is and summed only when ``Recorder.counters`` reads it, so no counter
waits for the device). While off, ``span`` and ``request`` return one
shared no-op context manager after a single global check and ``count``
returns at once. No span calls ``torch.profiler.record_function``.

The clock is ``time.perf_counter``. A device trace is tied to it by a
marker made at a noted ``perf_counter`` time (``trace`` below, and
``portbench/trace.py``'s marker kernels), so program spans and device
events share one timeline: a kernel falls to the innermost span open when
its launch call ran.

``request()`` opens a request's root span, ``serve.request``, with a new
id; the spans opened inside it carry that id. A request served in two
calls (``FusedServer.submit`` and ``collect``) passes the id from the
first to the second, whose root span then carries it again.

``trace(log_dir)`` is the counterpart of the reference's ``xla_trace``: a
``torch.profiler`` trace of the host and, where there is a card, the
device, written to ``log_dir`` as a Chrome trace with the program's spans
added on the trace's clock.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import socket
import threading
import time
from collections import defaultdict
from typing import NamedTuple, Optional

MARK = "densephrases.clock"  # the annotation that ties a trace's clock
SPAN_PID = 1 << 30  # the spans' process in an exported trace

_NOOP = contextlib.nullcontext()
_recorder: Optional["Recorder"] = None


class Span(NamedTuple):
    id: int
    name: str
    start: float  # perf_counter seconds
    end: float
    parent: Optional[int]  # the enclosing span's id
    request: Optional[int]
    thread: int
    attrs: dict


class _Open:
    """One span while it is open; recorded when it closes."""

    __slots__ = ("rec", "name", "request", "attrs", "id", "parent", "t0")

    def __init__(self, rec: "Recorder", name: str, request, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs
        self.request = request

    def __enter__(self):
        stack = self.rec._stack()
        outer = stack[-1] if stack else None
        self.parent = None if outer is None else outer.id
        if self.request is None and outer is not None:
            self.request = outer.request
        self.id = next(self.rec._ids)
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self.rec._stack().pop()
        self.rec._spans.append(Span(
            self.id, self.name, self.t0, t1, self.parent, self.request,
            threading.get_native_id(), self.attrs))
        return False


class Recorder:
    """The spans and counters recorded while tracing is on. Each thread
    nests its own spans."""

    def __init__(self):
        self._spans = []
        self._counts = []
        self._ids = itertools.count()
        self._requests = itertools.count()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current_request(self) -> Optional[int]:
        """The request id of this thread's innermost open span."""
        stack = self._stack()
        return stack[-1].request if stack else None

    def spans(self) -> list:
        """The closed spans, by start."""
        return sorted(self._spans, key=lambda s: s.start)

    def counters(self) -> dict:
        """Each counter's sum (reading a device count waits for it)."""
        out = defaultdict(int)
        for name, n in list(self._counts):
            out[name] += int(n)
        return dict(out)


def enable() -> Recorder:
    """Turn tracing on with a new, empty recorder, and return it."""
    global _recorder
    _recorder = Recorder()
    return _recorder


def disable() -> Optional[Recorder]:
    """Turn tracing off; → the recorder that was on, or None."""
    global _recorder
    rec, _recorder = _recorder, None
    return rec


@contextlib.contextmanager
def recording():
    """Tracing on for the block; yields the recorder."""
    rec = enable()
    try:
        yield rec
    finally:
        if _recorder is rec:
            disable()


def span(name: str, **attrs):
    """A context manager recording the block as span ``name`` while
    tracing is on; the shared no-op while it is off."""
    rec = _recorder
    if rec is None:
        return _NOOP
    return _Open(rec, name, None, attrs)


def request(rid: Optional[int] = None):
    """The root span of a request, ``serve.request``: opened with ``rid``,
    or a new id, unless this thread's innermost open span already belongs
    to a request (to ``rid``, when it is given)."""
    rec = _recorder
    if rec is None:
        return _NOOP
    cur = rec.current_request()
    if cur is not None and rid in (None, cur):
        return _NOOP
    return _Open(rec, "serve.request",
                 next(rec._requests) if rid is None else rid, {})


def current_request() -> Optional[int]:
    rec = _recorder
    return None if rec is None else rec.current_request()


def active() -> bool:
    """Whether tracing is on: the guard of a count that costs work."""
    return _recorder is not None


def count(name: str, n) -> None:
    """Add ``n`` (a host int or a 0-d device tensor) to counter ``name``
    while tracing is on."""
    rec = _recorder
    if rec is None:
        return
    rec._counts.append((name, n))


def _clock_mark() -> float:
    """Note the host clock and open the ``MARK`` annotation at once: in the
    trace, ``MARK`` starts at the returned ``perf_counter`` time (the
    profiler stamps host annotations, launch calls and device events on
    one clock)."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t = time.perf_counter()
    with torch.profiler.record_function(MARK):
        pass
    return t


def add_spans(path: str, spans, counters: dict, t_mark: float) -> None:
    """Write ``spans`` into the Chrome trace at ``path`` on its clock, as
    one lane a thread of a process named "densephrases spans" sorted
    first, and the counters under the top-level key
    ``densephrasesCounters``. ``t_mark``: the ``perf_counter`` time at
    which the trace's ``MARK`` event starts; a trace without it is left
    as it is."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.setdefault("traceEvents", [])
    marks = [e for e in events if e.get("name") == MARK and e.get("ph") == "X"]
    if not marks:
        return
    offset = float(marks[0]["ts"]) - t_mark * 1e6  # µs
    events.append({"ph": "M", "name": "process_name", "pid": SPAN_PID,
                   "tid": 0, "args": {"name": "densephrases spans"}})
    events.append({"ph": "M", "name": "process_sort_index", "pid": SPAN_PID,
                   "tid": 0, "args": {"sort_index": -1}})
    for s in spans:
        events.append({
            "ph": "X", "cat": "densephrases", "name": s.name,
            "pid": SPAN_PID, "tid": s.thread,
            "ts": s.start * 1e6 + offset, "dur": (s.end - s.start) * 1e6,
            "args": dict(s.attrs, id=s.id, parent=s.parent,
                         request=s.request)})
    doc["densephrasesCounters"] = counters
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` trace of the block, written to ``log_dir`` as a
    Chrome trace (TensorBoard's layout and file name) with the program's
    spans and counters of the block added (tracing is on for the block);
    does nothing when log_dir is None."""
    if log_dir is None:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    own = _recorder is None
    rec = enable() if own else _recorder
    prof = torch.profiler.profile(activities=activities)
    try:
        with prof:
            t_mark = _clock_mark()
            yield
    finally:
        if own:
            disable()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}."
                                 f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    add_spans(path, [s for s in rec.spans() if s.start >= t_mark],
              rec.counters(), t_mark)
