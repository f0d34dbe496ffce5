"""Profiling scopes with the reference's stdout contract.

Port of `voxtpu/utils/profiling.py`: wall-clock scopes printing
``[Label]: X ms`` lines (`vplib/src/profiling.h:8-33`), hierarchical
labels ``Parent::Child``, ``%f`` values. CUDA work is asynchronous, so
a scope fenced on a CUDA tensor (:meth:`ProfilingScope.observe`) calls
`torch.cuda.synchronize()` on that tensor's device before the clock
stops. Each scope is also a named range of a `torch.profiler` trace
(`utils/trace.py::annotate`), opened only while a profile runs (the
CLI's ``--trace DIR``); there the port's own spans (`utils/trace.py::
span`: the serving plan's, the soft plan's and the JFA's phases) nest
inside the scopes, beside the kernels. Scopes always print; voxtpu's
process-wide on/off switch is not carried over (only the CLI opens
scopes).
"""

from __future__ import annotations

import time
from contextlib import ContextDecorator

import torch

from voxtpu_torch.utils.trace import annotate


class ProfilingScope(ContextDecorator):
    """Wall-clock scope printing ``[label]: X ms`` on exit.

    Usage::

        with ProfilingScope("CudaVox::processing") as p:
            out = kernel(x)
            p.observe(out)   # synchronize out's device before the clock stops
    """

    def __init__(self, label: str):
        self.label = label
        self._pending: list = []
        self.elapsed_ms = None

    def observe(self, value):
        """Register tensors to fence on before the scope closes."""
        self._pending.append(value)
        return value

    def __enter__(self):
        self._pending = []
        self._range = annotate(self.label)
        self._range.__enter__()
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        devices = {v.device for v in self._pending
                   if isinstance(v, torch.Tensor) and v.is_cuda}
        for device in devices:
            torch.cuda.synchronize(device)
        self._range.__exit__(*exc)
        self._pending = []
        self.elapsed_ms = (time.perf_counter() - self._start) * 1e3
        print(f"[{self.label}]: {self.elapsed_ms:f} ms", flush=True)
        return False

