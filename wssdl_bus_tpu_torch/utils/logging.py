"""Observability: scalar metric logging and device tracing (counterpart of
``wssdl_bus_tpu/utils/logging.py``).

``MetricLogger`` writes stdout-style lines to an append-mode ``log.txt`` in
the output directory and TensorBoard scalars through
``torch.utils.tensorboard`` when it imports (silently skipped otherwise),
never through TensorFlow.  It writes to local paths only: TensorBoard's
TF-free file layer has no remote filesystems (``gs://``, ``hdfs://``), and
once the port's logger has run, that holds for every TensorBoard writer of
the process (:func:`_tensorboard_without_tensorflow`).
``TraceContext`` is the reference's DEBUG_TIMELINE: a ``torch.profiler``
window (CPU and, on a card, CUDA activity) whose Chrome trace lands under
``<output_dir>/torch_trace/``, to view in Perfetto or chrome://tracing.
``span`` names a part of the host's work in such a trace (and in any other
profiler's: ``chip_smoke.py --profile``, the benchmark's traced window).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
import types
import warnings

import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

SPAN_PREFIX = "wssdl::"
_OFF = contextlib.nullcontext()


def _tensorboard_without_tensorflow() -> None:
    """Make TensorBoard write its event files through its own TF-free stub.

    TensorBoard resolves its file I/O (``tensorboard.compat.tf``) by
    importing TensorFlow where it is installed, unless the module
    ``tensorboard.compat.notf`` exists; and TensorFlow's ``tf.lite`` imports
    JAX where that is installed, which the port must never load.  Unless
    TensorFlow is already loaded, the marker module is registered, for the
    whole process: a later TensorBoard writer there (a caller's own too)
    also writes through the stub, which knows local paths only."""
    if "tensorflow" not in sys.modules:
        sys.modules.setdefault("tensorboard.compat.notf",
                               types.ModuleType("tensorboard.compat.notf"))


class MetricLogger:
    """``log.txt`` and TensorBoard scalars in a local ``output_dir``; a
    remote URL (``scheme://``) warns and writes no TensorBoard scalars."""

    def __init__(self, output_dir: str, tensorboard: bool = True):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.log_path = os.path.join(output_dir, "log.txt")
        self._tb = None
        if tensorboard and "://" in output_dir:
            warnings.warn(f"MetricLogger: {output_dir!r} is not a local "
                          "path; TensorBoard scalars are not written (the "
                          "port's TensorBoard writer is TF-free and local "
                          "only)")
        elif tensorboard:
            try:
                _tensorboard_without_tensorflow()
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir=output_dir)
            except Exception:
                self._tb = None

    def text(self, line: str):
        """Append one line to log.txt."""
        with open(self.log_path, "a") as f:
            f.write(line.rstrip("\n") + "\n")

    def scalars(self, step: int, **values: float):
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, float(v), step)

    def flush(self):
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()


class TraceContext:
    """A ``torch.profiler`` trace scope, the DEBUG_TIMELINE analog: each
    enabled window writes ``<output_dir>/torch_trace/trace_<n>.json``."""

    def __init__(self, output_dir: str, enabled: bool = False):
        self.dir = os.path.join(output_dir, "torch_trace")
        self.enabled = enabled
        self._prof = None

    def __enter__(self):
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            import torch

            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.__exit__(*exc)
            os.makedirs(self.dir, exist_ok=True)
            self._prof.export_chrome_trace(os.path.join(
                self.dir, f"trace_{time.time_ns()}.json"))
            self._prof = None
        return False


def span(name: str):
    """A range ``wssdl::<name>`` of the calling thread's work in the trace of
    whatever profiler is on; while none is, one shared null context, at the
    cost of a flag test.

    The range is a function-scope ``RecordFunction``, as an operator's is,
    not ``record_function``'s user scope: the profiler mirrors a user-scope
    range on the device's timeline as an annotation over the kernels it
    launched, which a reading of device time would count as device work.
    A kernel is tied to the range instead through its launch, the runtime
    call made on the range's thread while it was open (the correlation id
    both carry)."""
    if _autograd_profiler._is_profiler_enabled:
        return _RecordFunctionFast(SPAN_PREFIX + name)
    return _OFF
