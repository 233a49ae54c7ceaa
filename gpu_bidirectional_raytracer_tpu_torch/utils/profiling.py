"""Throughput metering and device traces.

Port of ``gpu_bidirectional_raytracer_tpu/utils/profiling.py``: the
reference's per-pass ``Rendering time ... Sample/sec ...K`` line as an
object (`ThroughputMeter`), and `torch_trace`, a ``torch.profiler``
window written as a Chrome trace, in place of JAX's ``xla_trace``.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch

from gpu_bidirectional_raytracer_tpu_torch.core.types import resolve_device


@dataclass
class ThroughputMeter:
    """Accumulates pass timings: the ``Sample/sec`` meter as an object.
    As a context manager it times its body on the host clock; the caller
    synchronises the card inside the body (as the CLI does before it
    reads the clock) so that the time covers the work queued."""

    pixels_per_pass: int
    total_time: float = 0.0
    passes: int = 0
    _t0: float = field(default=0.0, repr=False)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total_time += time.perf_counter() - self._t0
        self.passes += 1
        return False

    @property
    def samples_per_sec(self) -> float:
        if self.total_time == 0:
            return 0.0
        return self.pixels_per_pass * self.passes / self.total_time

    def report(self) -> str:
        """The reference's line, totals included."""
        return (f"Rendering time {self.total_time / max(self.passes, 1):.3f}"
                f" sec (pass {self.passes}) Total:{self.total_time:.2f} "
                f"Sample/sec {self.samples_per_sec / 1e3:.1f}K")


@contextlib.contextmanager
def torch_trace(path: str, device: str | torch.device = "cuda"):
    """Trace the body with ``torch.profiler`` (the host, and the card when
    ``device`` is a CUDA device) and write a Chrome trace to ``path``
    (open it in ``chrome://tracing`` or Perfetto). Yields the profiler,
    whose ``key_averages()`` sums the time by operation."""
    dev = resolve_device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(str(path))
