"""Observability: scalar metric logging and device tracing (counterpart of
``wssdl_bus_tpu/utils/logging.py``).

``MetricLogger`` writes stdout-style lines to an append-mode ``log.txt`` in
the output directory and TensorBoard scalars through
``torch.utils.tensorboard`` when it imports (silently skipped otherwise).
``TraceContext`` is the reference's DEBUG_TIMELINE: a ``torch.profiler``
window (CPU and, on a card, CUDA activity) whose Chrome trace lands under
``<output_dir>/torch_trace/``, to view in Perfetto or chrome://tracing.
"""

from __future__ import annotations

import os
import time


class MetricLogger:
    def __init__(self, output_dir: str, tensorboard: bool = True):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.log_path = os.path.join(output_dir, "log.txt")
        self._tb = None
        if tensorboard:
            try:
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
