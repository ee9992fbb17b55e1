"""The port's recorder: host spans and counters at the layer boundaries of
its main paths, on the clock of torch.profiler's device trace.

A span records its name, its start and end in time.time_ns() nanoseconds
(the clock onto which kineto maps the device's timestamps, so spans and
device events lie on one time line), the innermost span open on the same
thread when it began (its parent), the thread, and the outer step it
belongs to (a span opened with ``new_step=True`` begins the next one). A
counter is a named Python integer.

Counters always count, from shapes: none reads a device tensor. Spans
record only inside ``recording()``; outside it ``span`` is one attribute
check that returns a shared no-op context manager. No span synchronises
the device. Spans stay in memory and are handed over when the recording
ends:

    with spans.recording() as rec:
        ...
    rec.spans     # Span records, in the order they began
    rec.counters  # each counter's change over the recording, where it moved

``recording(mirror=True)``, as train.profile_dir's trace opens it, also
enters torch.profiler.record_function under each span's name, so the
profiler's trace shows the phases. Recordings nest; the recorder stays on
until the outermost one ends. It is one per process, like a logger.
"""

import itertools
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import NamedTuple, Optional

import torch


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]  # the id of the innermost span open on the thread at the start
    thread: int
    step: int


class Recording:
    """What one recording() saw; filled when it ends."""

    def __init__(self):
        self.spans, self.counters = [], {}


class _Recorder:
    def __init__(self):
        self.on = False
        self.depth = 0    # open recordings
        self.mirror = 0   # open recordings that mirror into record_function
        self.step = 0
        self.log = []     # finished spans, in the order they ended
        self.ids = itertools.count()
        self.local = threading.local()
        self.lock = threading.Lock()
        self.counters = {}


_R = _Recorder()
_NOOP = nullcontext()


class _Open:
    """A span being recorded."""

    __slots__ = ("name", "new_step", "id", "parent", "step", "stack", "mirrored", "start")

    def __init__(self, name, new_step):
        self.name, self.new_step = name, new_step

    def __enter__(self):
        r = _R
        if self.new_step:
            r.step += 1
        stack = getattr(r.local, "stack", None)
        if stack is None:
            stack = r.local.stack = []
        self.parent = stack[-1] if stack else None
        self.id = next(r.ids)
        stack.append(self.id)
        self.stack, self.step, self.mirrored = stack, r.step, None
        if r.mirror:
            self.mirrored = torch.autograd.profiler.record_function(self.name)
            self.mirrored.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.mirrored is not None:
            self.mirrored.__exit__(*exc)
        self.stack.pop()
        if _R.on:
            _R.log.append(Span(self.name, self.start, end, self.id, self.parent,
                               threading.get_ident(), self.step))
        return False


def span(name: str, new_step: bool = False):
    """A context manager that records the span `name` while a recording
    is open (with `new_step`, as the first span of an outer step)."""
    if not _R.on:
        return _NOOP
    return _Open(name, new_step)


def count(name: str, n: int = 1):
    """Add `n` to the counter `name`."""
    with _R.lock:
        _R.counters[name] = _R.counters.get(name, 0) + n


def counter(name: str) -> int:
    """The counter `name`'s value in this process."""
    return _R.counters.get(name, 0)


@contextmanager
def recording(mirror: bool = False):
    """Turn the recorder on; yields a Recording, filled when the block
    ends. With `mirror`, each span also enters record_function."""
    r = _R
    rec = Recording()
    if not r.depth:
        r.step = 0
    first = next(r.ids)
    with r.lock:
        before = dict(r.counters)
    r.depth += 1
    r.mirror += mirror
    r.on = True
    try:
        yield rec
    finally:
        rec.spans = sorted((s for s in r.log if s.id > first), key=lambda s: s.id)
        with r.lock:
            rec.counters = {k: v - before.get(k, 0) for k, v in r.counters.items()
                            if v != before.get(k, 0)}
        r.depth -= 1
        r.mirror -= mirror
        if not r.depth:
            r.on = False
            r.log = []
