"""The program's spans: where a call into the port spends its host time.

`root(name, **attrs)` opens the span of one call into the program
(`offline.process`, `offline.to_host`, `pool.push`); `span(name,
card=None, **attrs)` opens a span inside it.  Spans record only while a
torch.profiler records: a root asks once
(`torch.autograd._profiler_enabled()`), and the spans inside it follow
its answer through a thread-local, so a call with no profiler pays that
one check, and a read of a module global and a null context a span.  A
span outside any root records nothing.  Nothing here adds a profiler
event: a `record_function` range would also put a row on the device's
timeline, which a reader of the trace would take for device work.

Each record is a `Span`: its name, start and end on
`time.perf_counter_ns()`, its id, its parent's id (None for a root), the
id of its root (every span of one call shares it), the CUDA index of the
card it is for (or None) and its attributes.  A root's attributes hold
`launches`: the program's kernel launches inside it (K1, K2, K3 and
K3s, the change of their counts in `LAUNCHES`); a `pool.push` root also
holds `edge_launches`, those of K3s's edge product among them (0 where
the product does not run).  At most LIMIT records are kept in memory
(one more for each other thread that records at the same moment at the
limit); the spans past it are counted by `dropped()`.  `spans()` reads
the records, `clear()` empties them.  `utils/profiling.py::trace` writes
them into the Chrome trace it exports.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple

import torch

LIMIT = 1 << 20

_records: list = []
_dropped = 0
_recording = 0  # recording roots open, on every thread
_lock = threading.Lock()
_ids = itertools.count(1)

# Kernel launches since the process started, by kernel: "K1" (omnibus),
# "K2" (fused bucket), "K3" (pool, time OLA), "K3s" (pool, spectral
# OLA), "K4" (dot chain), "K5" (overhead probe), "K6" (floor probe), and
# a part of a kernel under "<kernel>.<part>": "K3s.edge", the edge
# product's gather and product; "K4.<variant>".  `ops/_build.py` counts
# every launch here; `launches` reads.
LAUNCHES: dict = {}
PROGRAM = ("K1", "K2", "K3", "K3s")  # the kernels a root counts; the probes are not the program's


class Span(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    id: int
    parent: int | None
    call: int  # the id of the root span
    card: int | None
    attrs: dict


class _Thread(threading.local):
    open = None  # the innermost recording span open on this thread


_thread = _Thread()


class _Null:
    """The context of a span that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_NULL = _Null()


def launches(*kernels: str) -> int:
    """Launches counted so far under `kernels`, each with its parts ("K3s"
    takes "K3s.edge")."""
    counted = tuple(LAUNCHES.items())  # one copy: another thread's first launch of a kernel adds its key
    return sum(n for k, n in counted if k in kernels or k.partition(".")[0] in kernels)


def _counts() -> tuple:
    """(the program's launches, the edge product's) so far."""
    return launches(*PROGRAM), LAUNCHES.get("K3s.edge", 0)


def _card(device: torch.device) -> int | None:
    """The CUDA index of `device`; None for another kind of device."""
    if device.type != "cuda":
        return None
    return torch.cuda.current_device() if device.index is None else device.index


class _Open:
    """A recording span: opened by `with`, recorded when it closes.  Its
    start and end leave the recorder's own bookkeeping out."""

    __slots__ = ("name", "card", "attrs", "outer", "root", "edges", "start", "id", "call", "counts")

    def __init__(self, name: str, card, attrs: dict, outer, root: bool, edges: bool = False):
        self.name, self.attrs, self.outer, self.root = name, attrs, outer, root  # a root counts its launches
        self.edges = edges  # and, for a pool call, the edge product's
        self.card = None if card is None else _card(card)

    def set(self, **attrs):
        """Attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self):
        global _recording
        self.id = next(_ids)
        if self.outer is None:
            with _lock:
                _recording += 1
            self.call = self.id
        else:
            self.call = self.outer.call
        if self.root:
            self.counts = _counts()
        _thread.open = self
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _dropped, _recording
        end = time.perf_counter_ns()
        outer = _thread.open = self.outer
        if self.root:
            program, edges = _counts()
            self.attrs["launches"] = program - self.counts[0]
            if self.edges:
                self.attrs["edge_launches"] = edges - self.counts[1]
        record = tuple.__new__(Span, (self.name, self.start, end, self.id, None if outer is None else outer.id,
                                      self.call, self.card, self.attrs))
        if len(_records) < LIMIT:  # list.append holds the interpreter lock
            _records.append(record)
        else:
            with _lock:
                _dropped += 1
        if outer is None:
            with _lock:
                _recording -= 1
        return False


def root(name: str, edges: bool = False, **attrs):
    """The span of one call into the program: it records while a
    torch.profiler records, and counts the kernels launched inside it
    (with `edges`, also the edge product's, as `edge_launches`).  Inside
    a recording call it is a span of that call."""
    outer = _thread.open if _recording else None
    if outer is None and not torch.autograd._profiler_enabled():
        return _NULL
    return _Open(name, None, attrs, outer, True, edges)


def span(name: str, card=None, **attrs):
    """A span inside the call open on this thread, for the device `card`
    (recorded as its CUDA index).  Records only where that call records."""
    outer = _thread.open if _recording else None
    return _NULL if outer is None else _Open(name, card, attrs, outer, False)


def spans() -> list:
    """Every record kept, in the order the spans closed."""
    with _lock:
        return list(_records)


def dropped() -> int:
    """Spans not kept since the last `clear()`: the store was full."""
    return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0
