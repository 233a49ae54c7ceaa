"""Numerical-health checks.

Port of ``gpu_bidirectional_raytracer_tpu/utils/debug.py``: NaN and Inf
detection on the render state, a salvage clamp, an image summary, and a
debugging context, here around ``torch.autograd.detect_anomaly`` (which
names the backward operation that produced the first NaN) in place of
``jax_debug_nans``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def check_state(state, where: str = "") -> None:
    """Raise FloatingPointError if the accumulated colors hold a
    non-finite value."""
    n_bad = int(torch.sum(~torch.isfinite(state.colors)))
    if n_bad:
        raise FloatingPointError(
            f"render state corrupted{f' at {where}' if where else ''}: "
            f"colors: {n_bad} non-finite")


def finite_or_zero(x):
    """Non-finite entries set to zero (a last-resort salvage for beauty
    renders; correctness paths should raise through `check_state`)."""
    x = torch.as_tensor(x)
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


@contextlib.contextmanager
def nan_debugging():
    """``torch.autograd.detect_anomaly`` for the scope: a backward that
    produces a NaN raises, naming the forward operation it came from."""
    with torch.autograd.detect_anomaly():
        yield


def image_stats(colors) -> dict:
    """Mean, max, non-finite and negative counts, for logging."""
    a = (colors.detach().cpu().numpy() if isinstance(colors, torch.Tensor)
         else np.asarray(colors))
    return {
        "mean": float(a.mean()),
        "max": float(a.max()),
        "nonfinite": int((~np.isfinite(a)).sum()),
        "negative": int((a < 0).sum()),
    }
