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


def many_sphere_scene(k=80, seed=3):
    """The Cornell box and ``k`` small diffuse spheres placed from a numpy
    seed (JAX's type): past the 64 spheres of the adjoint kernels, as
    tests/test_bounce_grad.py builds one."""
    import jax.numpy as jnp

    from gpu_bidirectional_raytracer_tpu.core.types import Scene
    from gpu_bidirectional_raytracer_tpu.scene import builtin

    base = builtin.cornell_box()
    pos = (np.random.default_rng(seed).uniform(0.0, 1.0, (k, 3))
           * 60.0 + np.array([20.0, 5.0, 20.0])).astype(np.float32)
    return Scene(
        rad=jnp.concatenate([base.rad, jnp.full((k,), 2.0)]),
        p=jnp.concatenate([base.p, jnp.asarray(pos)]),
        e=jnp.concatenate([base.e, jnp.zeros((k, 3))]),
        c=jnp.concatenate([base.c, jnp.full((k, 3), 0.5)]),
        refl=jnp.concatenate([base.refl, jnp.zeros((k,), jnp.int32)]))


def floating_vpl(cfg):
    """One valid VPL floating in the Cornell box (JAX's type), as
    tests/test_pallas.py uses: clear of the walls' knife edges."""
    import jax.numpy as jnp

    from gpu_bidirectional_raytracer_tpu.core.types import VplBuffer

    v = VplBuffer.zeros(cfg.vpl_depth, cfg.light_points)
    return VplBuffer(
        hp=v.hp.at[0, 0].set(jnp.array([60.0, 50.0, 90.0])),
        rad=v.rad.at[0, 0].set(jnp.array([2.0, 1.5, 1.0])),
        nl=v.nl.at[0, 0].set(jnp.array([0.0, -1.0, 0.0])),
        valid=v.valid.at[0, 0].set(True), sid=v.sid)


def max_rel(a, b):
    """tests/test_pallas_grad.py::_max_rel: the largest relative
    difference over the entries above 1e-3 of the largest."""
    big = np.abs(a) > 1e-3 * max(np.abs(a).max(), 1e-9)
    if not big.any():
        return 0.0
    return float((np.abs(a - b) / np.maximum(np.abs(a), 1e-6))[big].max())
