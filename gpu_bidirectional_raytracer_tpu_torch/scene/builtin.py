"""Built-in scenes: the Cornell box of giant wall spheres and the small
ground-plane test scene, plus the default camera (port of
``gpu_bidirectional_raytracer_tpu/scene/builtin.py``)."""

from __future__ import annotations

import numpy as np
import torch

from gpu_bidirectional_raytracer_tpu_torch.core.types import (
    DIFF,
    REFR,
    SPEC,
    Scene,
)

WALL_RAD = 1e4

DEFAULT_CAMERA_ORIG = np.array([50.0, 44.0, 176.0], dtype=np.float32)
DEFAULT_CAMERA_TARGET = np.array([50.0, 44.0 - 0.042612, 175.0],
                                 dtype=np.float32)


def cornell_box(device: str | torch.device = "cuda") -> Scene:
    """Six wall spheres, a mirror ball, a glass ball and an emitter near
    the ceiling (marked REFR: emitters are found by nonzero emission)."""
    w = WALL_RAD
    return Scene.from_lists([
        (w, (w + 1.0, 40.8, 81.6), (0, 0, 0), (0.75, 0.25, 0.25), DIFF),
        (w, (-w + 99.0, 40.8, 81.6), (0, 0, 0), (0.25, 0.25, 0.75), DIFF),
        (w, (50.0, 40.8, w), (0, 0, 0), (0.75, 0.75, 0.75), DIFF),
        (w, (50.0, 40.8, -w + 270.0), (0, 0, 0), (0, 0, 0), DIFF),
        (w, (50.0, w, 81.6), (0, 0, 0), (0.75, 0.75, 0.75), DIFF),
        (w, (50.0, -w + 81.6, 81.6), (0, 0, 0), (0.75, 0.75, 0.75), DIFF),
        (16.5, (27.0, 16.5, 47.0), (0, 0, 0), (0.9, 0.9, 0.9), SPEC),
        (16.5, (73.0, 16.5, 78.0), (0, 0, 0), (0.9, 0.9, 0.9), REFR),
        (7.0, (50.0, 81.6 - 15.0, 81.6), (12, 12, 12), (0, 0, 0), REFR),
    ], device=device)


def test_scene(device: str | torch.device = "cuda") -> Scene:
    """The ground-plane test scene."""
    return Scene.from_lists([
        (1000.0, (0, -1000.0, 0), (0, 0, 0), (0.75, 0.75, 0.75), DIFF),
        (15.0, (10.0, 15.0, 0.0), (0, 0, 0), (0.75, 0, 0), DIFF),
        (20.0, (-40.0, 20.0, 0.0), (0, 0, 0), (0, 0, 0.75), DIFF),
        (10.0, (-5.0, 10.0, 20.0), (0, 0, 0), (0, 0.75, 0), DIFF),
        (10.0, (-30.0, 100.0, 20.0), (12, 12, 12), (0, 0, 0), DIFF),
    ], device=device)
