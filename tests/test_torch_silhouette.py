"""The silhouette carrier (``sil_grad_tau``) of the port against the JAX
package on the CPU.

The scenes of tests/test_silhouette_grad.py, at 16x12 (32x24 for the
two mirrors, whose twice-reflected ball covers no pixel at 16x12),
``max_depth`` 3 and one sample per pixel instead of 64x48 and 8-12 (the
comparison is of the same estimator on the same tape, not of the
estimator against finite differences): the floating sphere against the
sky, a sphere seen only in a near-flat mirror, one seen only through two
mirrors (``sil_spec_depth`` 1 and 2), a ball seen through a glass lens,
and a ball seen only mirrored in a glass sphere (the Fresnel-reflected
chain). For each, the gradient
of a weighted image sum (weights from a numpy seed) through
`render_radiance` with the carrier, on the port's plain route and through
``backend="pallas"`` (the carrier outside the tracer; on CPU tensors the
adjoint's plain version), against ``jax.grad`` of JAX's: the JAX suite's
`_max_rel` below 5e-3, and the two routes of the port within tests/
test_silhouette_grad.py's rtol 2e-3, atol 1e-5 of each other. The carrier
must fire: the gradient differs from the one without it; except through
two mirrors at ``sil_spec_depth`` 1, where its legs end on the two
mirrors, which fill the view, so it adds nothing (the premise of
tests/test_silhouette_grad.py::TestTwoMirrorSilhouette).

A band of lanes with both carriers on equals the same lanes of the whole
frame bit for bit (tests/test_gradients.py::TestLaneWindowedCore).

JAX runs jitted, one compile per case.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_bidirectional_raytracer_tpu.core.types import (
    REFR,
    SPEC,
    Camera as JCamera,
    IntegratorConfig as JConfig,
    Scene as JScene,
)
from gpu_bidirectional_raytracer_tpu.diff import gradients as JG
from gpu_bidirectional_raytracer_tpu.integrators.direct import (
    static_light_indices as jlights,
)
from gpu_bidirectional_raytracer_tpu.scene import builtin as jbuiltin
from gpu_bidirectional_raytracer_tpu_torch import rng as trng
from gpu_bidirectional_raytracer_tpu_torch.diff import gradients as TG
from torch_parity import (
    key_words,
    max_rel,
    to_torch_camera,
    to_torch_config,
    to_torch_scene,
)

torch.set_num_threads(2)

PARAMS = ("p", "rad", "e", "c")
BOUND = 5e-3                   # tests/test_pallas_grad.py:88
ROUTE_RTOL, ROUTE_ATOL = 2e-3, 1e-5   # tests/test_silhouette_grad.py:139


def _scene(rad, p, e, c, refl):
    return JScene(rad=jnp.array(rad), p=jnp.array(p), e=jnp.array(e),
                  c=jnp.array(c), refl=jnp.array(refl, jnp.int32))


_TWO_MIRRORS = _scene(
    [1000.0, 1000.0, 28.0, 6.0],
    [[0.0, 0.0, -1000.0], [0.0, 0.0, 1100.0], [0.0, 80.0, 32.0],
     [0.0, 120.0, 90.0]],
    [[0.0] * 3, [0.0] * 3, [0.0] * 3, [40.0] * 3],
    [[0.9] * 3, [0.9] * 3, [0.7, 0.4, 0.2], [0.0] * 3], [SPEC, SPEC, 0, 0])
# name: (scene, camera origin, sil_grad_tau, sil_spec_depth), as the
# fixtures of tests/test_silhouette_grad.py build them.
CASES = {
    "floating": (_scene(
        [10.0, 5.0], [[0.0, 0.0, 0.0], [30.0, 40.0, 80.0]],
        [[0.0, 0.0, 0.0], [20.0, 20.0, 20.0]],
        [[0.6, 0.6, 0.2], [0.0, 0.0, 0.0]], [0, 0]), 60.0, 1.0, 2),
    "mirror": (_scene(
        [1000.0, 20.0, 5.0],
        [[0.0, 0.0, -1000.0], [10.0, 8.0, 100.0], [0.0, 30.0, 80.0]],
        [[0.0] * 3, [0.0] * 3, [30.0] * 3],
        [[0.9] * 3, [0.7, 0.4, 0.2], [0.0] * 3], [SPEC, 0, 0]),
        60.0, 2.0, 1),
    "two_mirrors_depth1": (_TWO_MIRRORS, 60.0, 2.0, 1),
    "two_mirrors_depth2": (_TWO_MIRRORS, 60.0, 2.0, 2),
    "lens": (_scene(
        [10.0, 6.0, 5.0],
        [[0.0, 0.0, 0.0], [0.0, 0.0, -30.0], [0.0, 50.0, -20.0]],
        [[0.0] * 3, [0.0] * 3, [30.0] * 3],
        [[0.95] * 3, [0.7, 0.4, 0.2], [0.0] * 3], [REFR, 0, 0]),
        60.0, 2.0, 2),
    "glass_reflected": (_scene(
        [20.0, 12.0, 40.0, 8.0],
        [[0.0, 0.0, 0.0], [28.0, 0.0, 55.0], [0.0, 0.0, -70.0],
         [0.0, 60.0, 60.0]],
        [[0.0] * 3, [0.0] * 3, [0.0] * 3, [40.0] * 3],
        [[0.95] * 3, [0.9, 0.12, 0.08], [0.45] * 3, [0.0] * 3],
        [REFR, 0, 0, 0]), 70.0, 2.0, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_silhouette_gradient_matches_jax(case):
    scene, cam_z, tau, spec_depth = CASES[case]
    w, h = (32, 24) if case.startswith("two_mirrors") else (16, 12)
    cam = JCamera.make(jnp.array([0.0, 0.0, cam_z]),
                       jnp.array([0.0, 0.0, 0.0]), w, h)
    cfg = dataclasses.replace(JConfig.cpu_golden(), max_depth=3,
                              sil_grad_tau=tau, sil_spec_depth=spec_depth)
    li = jlights(scene)
    key = jax.random.key(0)
    wts = np.random.default_rng(7).uniform(0.0, 1.0, (h, w, 3)).astype(
        np.float32)

    ref = jax.jit(jax.grad(lambda sc: jnp.sum(wts * JG.render_radiance(
        sc, cam, key, cfg, w, h, li, 1)), allow_int=True))(scene)

    ts, tcam = to_torch_scene(scene), to_torch_camera(cam)
    tkey = trng.ThreefryKey(key_words(key))

    def port(config, backend):
        leaves = [getattr(ts, k).clone().requires_grad_() for k in PARAMS]
        sc = ts.replace(**dict(zip(PARAMS, leaves)))
        img = TG.render_radiance(sc, tcam, tkey, to_torch_config(config), w,
                                 h, li, 1, backend)
        return torch.autograd.grad((torch.tensor(wts) * img).sum(), leaves)

    got = {b: port(cfg, b) for b in ("xla", "pallas")}
    for name, gx, gp in zip(PARAMS, got["xla"], got["pallas"]):
        a = np.asarray(getattr(ref, name))
        assert np.isfinite(gx.numpy()).all(), name
        assert max_rel(a, gx.numpy()) < BOUND, (name,
                                                max_rel(a, gx.numpy()))
        np.testing.assert_allclose(gp.numpy(), gx.numpy(), rtol=ROUTE_RTOL,
                                   atol=ROUTE_ATOL, err_msg=name)
    off = port(dataclasses.replace(cfg, sil_grad_tau=0.0), "xla")
    same = all(torch.equal(a, b) for a, b in zip(got["xla"], off))
    assert same == (case == "two_mirrors_depth1")


def test_lane_window_is_the_frame_bit_for_bit():
    """Lanes [40, 104) of a 16x12 Cornell frame, both carriers on, equal
    the whole frame's."""
    scene = to_torch_scene(jbuiltin.cornell_box())
    w, h = 16, 12
    n = w * h
    cam = to_torch_camera(JCamera.make(jbuiltin.DEFAULT_CAMERA_ORIG,
                                       jbuiltin.DEFAULT_CAMERA_TARGET, w, h))
    li = jlights(jbuiltin.cornell_box())
    key = trng.ThreefryKey(key_words(jax.random.key(5)))
    cfg = to_torch_config(dataclasses.replace(
        JConfig(), vis_grad_tau=2.0, sil_grad_tau=1.0, max_depth=3))
    with torch.enable_grad():
        sc = scene.replace(p=scene.p.clone().requires_grad_())
        full = TG.render_radiance(sc, cam, key, cfg, w, h, li, 2).reshape(
            n, 3)
        band = TG.render_radiance_lanes(sc, cam, key, cfg, w, h, li, 2,
                                        "xla", lane_offset=40, lane_count=64,
                                        lane_total=n)
    assert band.requires_grad
    assert torch.equal(band, full[40:104])
