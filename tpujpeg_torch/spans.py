"""Spans and counters inside the port, for ``torch.profiler`` traces.

``span(name)`` marks a stretch of host work at a layer boundary, and
``count(name, n)`` counts work at one (``launch``: one per kernel launch on
the card). Both record only while the calling thread is traced:

- a thread under a ``torch.profiler`` profile that records host events
  (``ProfilerActivity.CPU``): the span is also a profiler event of its
  name (``torch._C._profiler._RecordFunctionFast``), so it lands among the
  profile's host events on the device trace's clock. Unlike
  ``record_function``, whose exit is an operator call that releases the
  interpreter lock, it enters and leaves holding the lock: a thread that
  then waits for the lock (the stream's prep threads hold it while they
  parse) waits inside the span, not in its caller's code;
- a thread that has adopted a traced unit (``adopt``): the stream's prep
  threads, which the profiler does not see, carry the unit and the open
  span of the thread that submitted their work.

Off, ``span`` returns one shared null context and ``count`` returns at
once: no allocation, no clock read, no record. A profile of the card alone
records nothing here.

Each record holds the name, the unit (the stream's chunk index, or
``decode()``'s request number), the span's id and its parent's, the
thread, and the start and end on ``time.time_ns()`` (the profiler's host
timestamps are on the same epoch clock). Records stay in memory, in a
bounded ``deque``, until ``drain()`` returns and clears them.

Span names, from the entries down: ``tpujpeg_torch.decode`` (one per
``decode()``), ``tpujpeg_torch.stream.prep_wait`` / ``.submit`` /
``.sync`` / ``.fallback`` (``decode_stream``'s main thread),
``tpujpeg_torch.ladder``
(``decode_batch_on_device``, ``decode_batch``), ``tpujpeg_torch.parse``,
``tpujpeg_torch.plan`` (the planners), ``tpujpeg_torch.copy_in`` (plans and
masks copied to the device) and ``tpujpeg_torch.card_wait`` (every host
block on the card). Counters: ``launch`` (every kernel launch),
``a_buckets`` (for each kernel-A launch of a stream chunk, the geometry
buckets it decodes), ``prog_tsets`` (for each launch of kernel 7, 8 or 9,
the Huffman table sets it decodes), and for each marker-free plan split
for a card ``norst_lanes`` (its lanes) and ``norst_wave`` (the lanes one
wave of kernel A holds there).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import gc
import itertools
import threading
import time
import weakref
from typing import List, NamedTuple, Optional

from torch._C._autograd import _profiler_type
from torch._C._profiler import ActiveProfilerType, _RecordFunctionFast
from torch.autograd import _profiler_enabled
from torch.autograd import profiler as _autograd_profiler

DECODE = "tpujpeg_torch.decode"
PREP_WAIT = "tpujpeg_torch.stream.prep_wait"
SUBMIT = "tpujpeg_torch.stream.submit"
SYNC = "tpujpeg_torch.stream.sync"
FALLBACK = "tpujpeg_torch.stream.fallback"
LADDER = "tpujpeg_torch.ladder"
PARSE = "tpujpeg_torch.parse"
PLAN = "tpujpeg_torch.plan"
COPY_IN = "tpujpeg_torch.copy_in"
CARD_WAIT = "tpujpeg_torch.card_wait"
LAUNCH = "launch"
A_BUCKETS = "a_buckets"
PROG_TSETS = "prog_tsets"
NORST_LANES = "norst_lanes"
NORST_WAVE = "norst_wave"

MAXLEN = 1 << 18   # records kept: a traced 10 s window writes tens of thousands


class Record(NamedTuple):
    name: str
    unit: Optional[int]      # chunk index or request number; None outside any unit
    id: Optional[int]        # the span's id; None for a counter
    parent: Optional[int]    # the enclosing span's id (on the submitting thread for a prep thread)
    thread: int              # threading.get_ident()
    start_ns: int            # time.time_ns(); a counter's start and end are its time
    end_ns: int
    n: int                   # a counter's increment; 0 for a span
    mirrored: bool           # also an event in the profile


_log: "collections.deque[Record]" = collections.deque(maxlen=MAXLEN)
_ids = itertools.count(1)
_tls = threading.local()     # .unit, .stack (open span ids), .adopted
_NULL = contextlib.nullcontext()
_profile = None              # weakref to the running torch.autograd.profiler.profile


def _running(prof) -> bool:
    return bool(getattr(prof, "entered", False)) and prof.profiling_end_time_ns < prof.profiling_start_time_ns


def _profile_records_host() -> bool:
    """Whether the profiler enabled on this thread records host events.
    torch has no flag for it: ``_profiler_enabled()`` reads true under a
    profile of the card alone too, where ``record_function`` records
    nothing. A Kineto profile is a ``torch.autograd.profiler.profile``
    (``torch.profiler.profile`` wraps one) whose ``use_cpu`` says it; it is
    found once per profile among live objects, and kept while it runs.
    Other profilers (legacy, NVTX, ITT) record every host range."""
    global _profile
    prof = _profile() if _profile is not None else None
    if prof is None or not _running(prof):
        if _profiler_type() != ActiveProfilerType.KINETO:
            return True
        cls = _autograd_profiler.profile
        prof = next((p for p in gc.get_referrers(cls) if isinstance(p, cls) and _running(p)), None)
        if prof is None:
            return True
        _profile = weakref.ref(prof)
    return bool(prof.use_cpu)


def recording() -> bool:
    """Whether the calling thread records spans and counters."""
    return (_profiler_enabled() and _profile_records_host()) or getattr(_tls, "adopted", False)


def current() -> Optional[int]:
    """The id of the calling thread's innermost open span, or None."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


class _Span:
    __slots__ = ("name", "profiled", "id", "parent", "start", "rf")

    def __init__(self, name: str, profiled: bool):
        self.name, self.profiled = name, profiled

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.start = time.time_ns()
        self.rf = None
        if self.profiled:
            self.rf = _RecordFunctionFast(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _tls.stack.pop()
        _log.append(Record(self.name, getattr(_tls, "unit", None), self.id, self.parent,
                           threading.get_ident(), self.start, end, 0, self.rf is not None))
        if self.rf is not None:   # last: the profile's span holds the bookkeeping above
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context that records `name` around its body where the calling
    thread is traced, else the shared null context."""
    profiled = _profiler_enabled() and _profile_records_host()
    if profiled or getattr(_tls, "adopted", False):
        return _Span(name, profiled)
    return _NULL


def spanned(name: str):
    """Decorator: the function's whole call inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Record `n` of `name` in the calling thread's unit, where it is traced."""
    if (_profiler_enabled() and _profile_records_host()) or getattr(_tls, "adopted", False):
        t = time.time_ns()
        _log.append(Record(name, getattr(_tls, "unit", None), None, current(), threading.get_ident(),
                           t, t, n, False))


class _Adopt:
    __slots__ = ("unit", "parent", "saved")

    def __init__(self, unit: int, parent: Optional[int]):
        self.unit, self.parent = unit, parent

    def __enter__(self):
        self.saved = (getattr(_tls, "adopted", False), getattr(_tls, "unit", None), getattr(_tls, "stack", None))
        _tls.adopted, _tls.unit = True, self.unit
        _tls.stack = [self.parent] if self.parent is not None else []
        return self

    def __exit__(self, *exc):
        _tls.adopted, _tls.unit, _tls.stack = self.saved
        return False


def adopt(unit: Optional[int], parent: Optional[int] = None):
    """A context in which the calling thread records as part of `unit`, its
    spans children of span `parent`: how a worker thread carries the traced
    state and ids of the thread that submitted its work, and how an entry
    point opens a unit. `unit` None (not traced): the shared null context."""
    return _NULL if unit is None else _Adopt(unit, parent)


def drain() -> List[Record]:
    """Every record kept since the last drain, oldest first; the log is
    left empty."""
    out = []
    while True:
        try:
            out.append(_log.popleft())
        except IndexError:
            return out
