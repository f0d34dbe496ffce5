"""Device-level tracing — the reference's Nsight Systems analog.

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
"""

from __future__ import annotations

import contextlib

import torch


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


def annotate(name: str):
    """A named range inside a trace (`torch.profiler.record_function`)."""
    return torch.profiler.record_function(name)
