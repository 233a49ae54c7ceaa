"""Shared helpers of the tests that compare the PyTorch port with the JAX
package: export JAX objects to numpy and build the port's from them, and
the radiance protocol of tests/test_pallas.py."""

import os

import numpy as np
import torch

from gpu_bidirectional_raytracer_tpu_torch import convert

SCENES_DIR = os.path.join(os.path.dirname(__file__), "..", "assets", "scenes")

# Radiance protocol (tests/test_pallas.py::_compare): a pixel is bad when
# any channel differs by more than ATOL + RTOL * |ref|; at most
# MAX_BAD_FRAC of the pixels may be bad (knife-edge decisions flip under
# float op-order differences).
ATOL = 2e-3
RTOL = 2e-3
MAX_BAD_FRAC = 0.035


def scn(name):
    return os.path.join(SCENES_DIR, name)


def assert_protocol(got, ref, max_bad_frac=MAX_BAD_FRAC):
    got = np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    err = np.abs(got - ref)
    bad = np.any(err > ATOL + RTOL * np.abs(ref), axis=-1)
    assert bad.mean() <= max_bad_frac, (
        f"{bad.mean():.3%} pixels disagree, max err {err.max():.4g}")
    return bad.mean()


def to_torch_scene(scene):
    return convert.scene_from_numpy(
        *(np.asarray(a) for a in (scene.rad, scene.p, scene.e, scene.c,
                                  scene.refl)), device="cpu")


def to_torch_camera(cam):
    return convert.camera_from_numpy(
        *(np.asarray(a) for a in (cam.orig, cam.target, cam.x, cam.y,
                                  cam.dir)), device="cpu")


def to_torch_vpls(vpls):
    return convert.vpls_from_numpy(
        *(np.asarray(a) for a in (vpls.hp, vpls.rad, vpls.nl, vpls.valid,
                                  vpls.sid)), device="cpu")


def key_words(key):
    import jax

    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)))


def to_torch_config(cfg):
    import dataclasses

    from gpu_bidirectional_raytracer_tpu_torch.core.types import (
        IntegratorConfig,
    )

    return IntegratorConfig(**dataclasses.asdict(cfg))


def torch_rays(rays):
    from gpu_bidirectional_raytracer_tpu_torch.core.types import Rays

    return Rays(o=torch.tensor(np.asarray(rays.o)),
                d=torch.tensor(np.asarray(rays.d)))
