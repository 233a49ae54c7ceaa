"""Carry state across from the JAX package, handed over as numpy arrays.

The two packages share no code, so a comparison starts both from the same
inputs by exporting the JAX objects to numpy (``np.asarray`` of each field,
``jax.random.key_data`` of the key) and building the port's types here.
"""

from __future__ import annotations

import numpy as np
import torch

from gpu_bidirectional_raytracer_tpu_torch import rng
from gpu_bidirectional_raytracer_tpu_torch.core.types import (
    Camera,
    RenderState,
    VplBuffer,
    resolve_device,
)
from gpu_bidirectional_raytracer_tpu_torch.scene.parser import (
    scene_from_arrays as scene_from_numpy,  # the JAX scene's rad/p/e/c/refl
)

__all__ = ["scene_from_numpy", "camera_from_numpy", "vpls_from_numpy",
           "key_from_numpy", "state_from_numpy"]


def _f32(a, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=dev)


def camera_from_numpy(orig, target, x, y, dir,
                      device: str | torch.device = "cuda") -> Camera:
    """A :class:`Camera` with the JAX camera's basis as it is (no
    recomputation)."""
    dev = resolve_device(device)
    return Camera(orig=_f32(orig, dev), target=_f32(target, dev),
                  dir=_f32(dir, dev), x=_f32(x, dev), y=_f32(y, dev))


def vpls_from_numpy(hp, rad, nl, valid, sid,
                    device: str | torch.device = "cuda") -> VplBuffer:
    """A :class:`VplBuffer` from the JAX buffer's ``hp/rad/nl/valid/sid``."""
    dev = resolve_device(device)
    return VplBuffer(hp=_f32(hp, dev), rad=_f32(rad, dev), nl=_f32(nl, dev),
                     valid=torch.tensor(np.asarray(valid, bool), device=dev),
                     sid=torch.tensor(np.asarray(sid, np.int32), device=dev))


def key_from_numpy(key_data, impl: str = "mix32") -> rng.Key:
    """The port's key of tape ``impl`` ("mix32", "threefry" or "rbg")
    from the uint32 words of a JAX key (``jax.random.key_data``)."""
    return rng.make_typed_key(
        np.asarray(key_data, np.uint32).reshape(-1).tolist(), impl)


def state_from_numpy(colors, counter, vpls: VplBuffer, vlp_index, sample,
                     key_data, device: str | torch.device = "cuda",
                     impl: str = "mix32") -> RenderState:
    """A :class:`RenderState` from the JAX state's ``colors/counter/
    vlp_index/sample`` and the uint32 words of its key (tape ``impl``)."""
    dev = resolve_device(device)
    return RenderState(
        colors=_f32(colors, dev),
        counter=torch.tensor(np.asarray(counter, np.int32), device=dev),
        vpls=vpls, vlp_index=int(vlp_index), sample=int(sample),
        key=key_from_numpy(key_data, impl))
