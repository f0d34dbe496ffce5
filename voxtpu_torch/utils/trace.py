"""Device-level tracing — the reference's Nsight Systems analog — and
the port's own spans.

Port of `voxtpu/utils/trace.py`. The reference ships a containerized
Nsight Systems setup for kernel traces (`nsight.Dockerfile`,
`nsight.sh`); voxtpu captures `jax.profiler` traces. The port uses
`torch.profiler`: :func:`trace` records host activity and, where a CUDA
card is present, every kernel on it (the hand-written kernels, launched
through ctypes, included) and writes one Chrome trace into a directory.

Usage::

    with trace("trace_dir"):
        grid = voxelize(mesh, spec, backend="cuda", device="cuda")
        torch.cuda.synchronize()

    # or from the CLI:  python -m voxtpu_torch.cli a.obj --trace trace_dir

The file is ``<host>_<pid>.<ns>.pt.trace.json``; open it in
ui.perfetto.dev, chrome://tracing or TensorBoard's profile plugin.
:func:`annotate` names a range in it; the CLI's profiling scopes are
such ranges.

Spans. The port marks the phases where its time goes with :func:`span`:
the grid fit ``grid.fit`` (`grids/voxel_grid.py::GridSpec.fit`), the
serving plan's ``vox.plan.candidates``, ``.windows``, ``.batches``
and ``.upload`` (`ops/vox_slots_banded.py`), the soft plan
``soft.plan`` (`ops/soft_vox.py::make_soft_plan`, at a fit's build and
at each refresh) and the engine's ``soft.engine_plan``
(`models/fit.py`), with the fused and seg plans' phases
``soft.engine_plan.cells``, ``.cut`` and ``.tables`` inside it
(`ops/soft_vox_fused.py`, `ops/soft_vox_seg.py`), and the JFA's
``jfa.unpack``, ``jfa.seed_init`` and ``jfa.flood`` (`ops/jfa.py`,
`ops/jfa_cuda.py`). In a trace each is a range named ``voxtpu.<name>``
beside the kernels it launched. A plan builder moves its host values
through `_upload` and `_read`, which count the bytes and the syncs on
the phase's span.

The gate: a span does anything only while a `torch.profiler` profile
runs in the process. Without one, :func:`span` returns one module-level
null object whose `count` does nothing: no allocation, no range and no
CUDA event, the cost of one check. With one, a span opens its
`record_function` range and, on exit, appends a :class:`SpanRecord` to
a bounded in-memory store (`STORE_SIZE` records, the oldest dropped and
counted): its name, its start and end on `time.perf_counter`, the span
open around it on the same thread, the counts set on it, and, for a
span given a CUDA `device`, the device time between two CUDA events
recorded on that device's current stream at entry and exit.
:func:`annotate` goes through the same gate. An operator reads the
store after a profiled run::

    with torch.profiler.profile():
        pipe = BandedSlotVoxPipeline(mesh, spec, "cuda")
    for r in recorded():      # waits for the spans' end events
        print(r.name, r.seconds * 1e3, r.device_ms, r.counts)
    clear()
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time

import numpy as np
import torch

# Records the store keeps; older ones are dropped and counted.
STORE_SIZE = 65536
SPAN_PREFIX = "voxtpu."

_profiling = torch._C._autograd._profiler_enabled


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the scope into `log_dir` (made if missing) with
    `torch.profiler`; where profiling cannot start, warn through
    `log_warn` and run the scope untraced, as voxtpu does."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir))
    try:
        prof.start()
    except RuntimeError as e:
        from voxtpu_torch.utils.logging import log_warn

        log_warn("torch.profiler unavailable (%s); tracing disabled", e)
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            prof.stop()  # writes the trace (on_trace_ready)


class _NullSpan:
    """What `span` and `annotate` return while no profiler runs."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, key: str, n: int = 1) -> None:
        pass


NULL_SPAN = _NullSpan()


def annotate(name: str):
    """A named range inside a trace (`torch.profiler.record_function`);
    the null span while no profiler runs."""
    return torch.profiler.record_function(name) if _profiling() else NULL_SPAN


@dataclasses.dataclass
class SpanRecord:
    """One closed span: `t0`, `t1` on `time.perf_counter`; `parent` the
    name of the span open around it on its thread (None at the top);
    `device_ms` the CUDA events' interval (None without a CUDA device),
    filled in by :func:`recorded`."""

    name: str
    t0: float
    t1: float
    parent: str | None
    counts: dict
    device_ms: float | None = None
    _events: tuple | None = dataclasses.field(default=None, repr=False)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class _Store:
    """The bounded record store and each thread's stack of open spans."""

    def __init__(self, size: int):
        self.records: collections.deque = collections.deque(maxlen=size)
        self.dropped = 0
        self.lock = threading.Lock()
        self.local = threading.local()

    def stack(self) -> list:
        if not hasattr(self.local, "open"):
            self.local.open = []
        return self.local.open

    def append(self, record: SpanRecord) -> None:
        with self.lock:
            if len(self.records) == self.records.maxlen:
                self.dropped += 1
            self.records.append(record)


_STORE = _Store(STORE_SIZE)


class _Span:
    __slots__ = ("name", "counts", "_range", "_events", "_stream", "_parent", "_t0")

    def __init__(self, name: str, device):
        self.name = name
        self.counts: dict = {}
        self._events = self._stream = None
        if device is not None and torch.device(device).type == "cuda":
            self._stream = torch.cuda.current_stream(device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))

    def count(self, key: str, n: int = 1) -> None:
        """Add `n` to the span's count `key`."""
        self.counts[key] = self.counts.get(key, 0) + n

    def __enter__(self):
        self._range = torch.profiler.record_function(SPAN_PREFIX + self.name)
        self._range.__enter__()
        stack = _STORE.stack()
        self._parent = stack[-1].name if stack else None
        stack.append(self)
        if self._events is not None:
            self._events[0].record(self._stream)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._events is not None:
            self._events[1].record(self._stream)
        _STORE.stack().pop()
        self._range.__exit__(*exc)
        _STORE.append(SpanRecord(self.name, self._t0, t1, self._parent, self.counts,
                                 _events=self._events))
        return False


def span(name: str, device=None):
    """A phase of the port: a context manager whose value takes
    `count(key, n)`. While a `torch.profiler` profile runs it is the
    range ``voxtpu.<name>`` and a record in the store (with the CUDA
    device time where `device` is a CUDA device); otherwise it is
    `NULL_SPAN` and costs one check."""
    if not _profiling():
        return NULL_SPAN
    return _Span(name, device)


def _read(sp, t: torch.Tensor) -> np.ndarray:
    """A host copy of the device values `t`: a sync, counted on the span
    `sp` with its bytes."""
    a = t.cpu().numpy()
    sp.count("syncs")
    sp.count("host_bytes", a.nbytes)
    return a


def _upload(sp, a, device, dtype=None) -> torch.Tensor:
    """Host values on `device` (as `dtype`), their bytes counted on the
    span `sp`. Made while nothing is queued on the device: an upload
    from pageable memory waits for the stream."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)
    sp.count("host_bytes", t.nbytes)
    return t


def recorded() -> list[SpanRecord]:
    """The stored records, oldest first, each `device_ms` read from its
    events (waiting for the end event where it has not completed)."""
    with _STORE.lock:
        records = list(_STORE.records)
    for r in records:
        if r._events is not None:
            start, end = r._events
            end.synchronize()
            r.device_ms = start.elapsed_time(end)
            r._events = None
    return records


def dropped() -> int:
    """Records dropped from the full store since the last `clear`."""
    return _STORE.dropped


def clear() -> None:
    """Empty the store and its drop count."""
    with _STORE.lock:
        _STORE.records.clear()
        _STORE.dropped = 0
