"""The port's many-sphere gradient against the JAX package on the CPU.

The route above the adjoint kernels' 64 spheres: detached facts (hit
spheres, occlusion) from a fact pass, then `path_tracer.trace(aux=...)`,
the re-walk under autograd (`ops.pallas_bounce_grad.trace_bounce_diff`).

- The facts the port collects (`path_tracer.trace(collect_aux=True)`;
  `trace_bounce_aux`, the CUDA fact kernel's plain version, equals it bit
  for bit) against JAX's collector, compared where the re-walk consumes
  them. The port marks a slot blocked wherever its shadow ray was not cast
  or is not used, as the CUDA fact kernel does; JAX's collector keeps the
  raw any-hit answer of every lane. So the light facts are held to JAX's
  census gate (entry 3: reached and used), and a VPL sample that reached
  a used vertex in the port must be unoccluded in JAX.
- The re-walk fed its own facts is the full-scan walk, bit for bit, and so
  are its gradients up to the order of sums.
- `trace_bounce_diff` gradients against ``jax.grad`` of JAX's
  ``trace_bounce_diff(facts="xla")`` on 89 spheres and on complex.scn (783
  spheres), 8x6, ``max_depth`` 3, under the `_max_rel` bounds of
  tests/test_pallas_grad.py (2e-2 with VPLs).
- `render_loss_grad` routes such a scene through the re-walk with the
  kernels' backend and matches its plain backend, with the bounds of
  tests/test_bounce_grad.py::TestRouting.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_bidirectional_raytracer_tpu import camera as jcam
from gpu_bidirectional_raytracer_tpu import rng as jrng
from gpu_bidirectional_raytracer_tpu.core.types import (
    Camera as JCamera,
    IntegratorConfig as JConfig,
)
from gpu_bidirectional_raytracer_tpu.integrators import path_tracer as jpt
from gpu_bidirectional_raytracer_tpu.integrators.direct import (
    static_light_indices as jlights,
)
from gpu_bidirectional_raytracer_tpu.ops.pallas_bounce_grad import (
    trace_bounce_diff as jbounce_diff,
)
from gpu_bidirectional_raytracer_tpu.scene import builtin as jbuiltin
from gpu_bidirectional_raytracer_tpu.scene.parser import load_scene as jload
from gpu_bidirectional_raytracer_tpu_torch.core.types import Rays
from gpu_bidirectional_raytracer_tpu_torch.diff import gradients as TG
from gpu_bidirectional_raytracer_tpu_torch.integrators import path_tracer as tpt
from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_bounce_grad as tpbg
from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace as tops
from torch_parity import (
    floating_vpl,
    key_words,
    many_sphere_scene,
    max_rel,
    scn,
    to_torch_camera,
    to_torch_config,
    to_torch_scene,
    to_torch_vpls,
    torch_rays,
)

torch.set_num_threads(2)

PARAMS = ("p", "rad", "e", "c")
BOUND_BIDIR = 2e-2     # tests/test_pallas_grad.py:108
MAX_FLIP = 0.02        # tests/test_bounce_grad.py::TestKernelFacts


def _rig(scene, w, h, orig=None, target=None, seed=0):
    orig = jbuiltin.DEFAULT_CAMERA_ORIG if orig is None else orig
    target = jbuiltin.DEFAULT_CAMERA_TARGET if target is None else target
    cam = JCamera.make(orig, target, w, h)
    key = jrng.make_key(seed)
    u = jrng.site_uniforms(key, 0, 0, jrng.CAM_JITTER, 2, w * h)
    px, py = jcam.pixel_grid(w, h)
    return (cam, jlights(scene), key,
            jcam.primary_rays(cam, w, h, u[0], u[1], px, py))


def _port(scene, cfg, vpls, rays, key):
    return (to_torch_scene(scene), to_torch_config(cfg),
            None if vpls is None else to_torch_vpls(vpls), torch_rays(rays),
            key_words(key))


def test_collected_facts_match_jax_on_consumed_entries():
    scene = many_sphere_scene()
    cfg = JConfig()
    cam, li, key, rays = _rig(scene, 16, 12)
    vpls = floating_vpl(cfg)
    _, jaux = jpt.trace(scene, cfg, li, rays, key, jnp.int32(0), vpls=vpls,
                        vlp_index=jnp.int32(0), collect_aux=True)
    ts, tcfg, tv, tr, tk = _port(scene, cfg, vpls, rays, key)
    rad, aux = tpt.trace(ts, tcfg, li, tr, tk, 0, vpls=tv, vlp_index=0,
                         collect_aux=True)
    before = dict(tops.LAUNCHES)
    aux2, rad2 = tpbg.trace_bounce_aux(ts, tcfg, li, tr, tk, 0, vpls=tv,
                                       vlp_index=0)
    assert tops.LAUNCHES == before
    assert torch.equal(rad2, rad)
    assert all(torch.equal(a, b) for a, b in zip(aux, aux2))

    hit, occ_l, occ_v = (a.numpy() for a in aux[:3])
    jhit = np.asarray(jaux[0])
    assert hit.shape == jhit.shape == (cfg.max_depth, 16 * 12)
    assert (hit != jhit).mean() <= MAX_FLIP, (hit != jhit).mean()
    assert (hit >= 0).mean() > 0.3
    same = hit == jhit
    reached_l = ~occ_l
    j_reached_l = np.asarray(jaux[3])       # ok & used, JAX's census bits
    assert reached_l.any()
    assert (reached_l != j_reached_l)[same].mean() <= MAX_FLIP
    reached_v = ~occ_v
    j_occ_v = np.asarray(jaux[2])
    assert reached_v.any()
    assert (reached_v & j_occ_v)[same].mean() <= MAX_FLIP


def test_rewalk_from_own_facts_is_the_full_scan_walk():
    scene = many_sphere_scene(seed=5)
    cfg = JConfig(max_depth=4)
    cam, li, key, rays = _rig(scene, 12, 8, seed=1)
    ts, tcfg, tv, tr, tk = _port(scene, cfg, floating_vpl(cfg), rays, key)
    full = tpt.trace(ts, tcfg, li, tr, tk, 0, vpls=tv, vlp_index=0)
    _, aux = tpt.trace(ts, tcfg, li, tr, tk, 0, vpls=tv, vlp_index=0,
                       collect_aux=True)
    walk = tpt.trace(ts, tcfg, li, tr, tk, 0, vpls=tv, vlp_index=0, aux=aux)
    assert torch.equal(walk, full)
    wts = torch.tensor(np.random.default_rng(2).uniform(
        0.0, 1.0, tuple(full.shape)).astype(np.float32))

    def grads(**kw):
        leaves = [getattr(ts, k).clone().requires_grad_() for k in PARAMS]
        sc = ts.replace(**dict(zip(PARAMS, leaves)))
        rad = tpt.trace(sc, tcfg, li, tr, tk, 0, vpls=tv, vlp_index=0, **kw)
        return torch.autograd.grad((wts * rad).sum(), leaves)

    for name, a, b in zip(PARAMS, grads(), grads(aux=aux)):
        scale = float(a.abs().max())
        assert scale > 0.0, name
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-6 * scale, err_msg=name)


@pytest.mark.parametrize("which", ["many", "complex"])
def test_trace_bounce_diff_grads_match_jax(which):
    w, h = 8, 6
    cfg = JConfig(max_depth=3)
    if which == "many":
        scene = many_sphere_scene()
        cam, li, key, rays = _rig(scene, w, h, seed=3)
        vpls = floating_vpl(cfg)
    else:
        orig, target, scene = jload(scn("complex.scn"))
        assert scene.num_spheres == 783
        cam, li, key, rays = _rig(scene, w, h, orig, target, seed=3)
        vpls = None
        cfg = JConfig(max_depth=3, use_vpl=False, combine_half=False)
    wts = np.random.default_rng(7).uniform(0.0, 1.0, (w * h, 3)).astype(
        np.float32)

    @jax.jit
    def jgrad(sc):
        return jax.grad(lambda s: jnp.sum(wts * jbounce_diff(
            s, cfg, li, rays, key, jnp.int32(0), vpls=vpls,
            vlp_index=None if vpls is None else jnp.int32(0),
            facts="xla")), allow_int=True)(sc)

    ref = jgrad(scene)
    ts, tcfg, tv, tr, tk = _port(scene, cfg, vpls, rays, key)
    leaves = [getattr(ts, k).clone().requires_grad_() for k in PARAMS]
    sc = ts.replace(**dict(zip(PARAMS, leaves)))
    rad = tpbg.trace_bounce_diff(sc, tcfg, li, tr, tk, 0, vpls=tv,
                                 vlp_index=None if tv is None else 0)
    got = torch.autograd.grad((torch.tensor(wts) * rad).sum(), leaves)
    for name, g in zip(PARAMS, got):
        a = np.asarray(getattr(ref, name))
        assert np.abs(a).max() > 0.0 and np.isfinite(g.numpy()).all(), name
        assert max_rel(a, g.numpy()) < BOUND_BIDIR, (name,
                                                    max_rel(a, g.numpy()))


def test_render_loss_grad_routes_past_64_spheres():
    """The kernels' backend on a CPU scene of 89 spheres takes the re-walk
    (facts from the plain collector) and equals the plain backend."""
    scene = many_sphere_scene()
    cfg = to_torch_config(JConfig(max_depth=3))
    w, h = 16, 12
    cam = to_torch_camera(JCamera.make(jbuiltin.DEFAULT_CAMERA_ORIG,
                                       jbuiltin.DEFAULT_CAMERA_TARGET, w, h))
    ts = to_torch_scene(scene)
    assert TG.radiance_route("cpu", ts.num_spheres, "pallas") == "bounce"
    li = jlights(scene)
    key = key_words(jrng.make_key(0))
    target = torch.tensor(np.random.default_rng(1).uniform(
        0.0, 0.5, (h, w, 3)).astype(np.float32))
    lp, gp = TG.render_loss_grad(ts, cam, key, target, cfg, w, h, li, 1,
                                 "l2", "pallas")
    lx, gx = TG.render_loss_grad(ts, cam, key, target, cfg, w, h, li, 1,
                                 "l2", "xla")
    assert float(lp) == pytest.approx(float(lx), rel=1e-6)
    for name in ("p", "rad", "c"):
        a, b = getattr(gx, name).numpy(), getattr(gp, name).numpy()
        scale = max(np.abs(a).max(), 1e-12)
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6 * scale,
                                   err_msg=name)


def test_fact_wrapper_refuses_a_device_that_is_not_cuda():
    """A tensor off the CPU never takes the plain collector: the wrapper
    goes to the kernel launch, which refuses a device that is not CUDA."""
    scene = to_torch_scene(many_sphere_scene())
    meta = scene.replace(**{k: getattr(scene, k).to("meta")
                            for k in ("rad", "p", "e", "c", "refl")})
    rays = Rays(o=torch.zeros((4, 3), device="meta"),
                d=torch.zeros((4, 3), device="meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        tpbg.trace_bounce_aux(meta, to_torch_config(JConfig()), (8,), rays,
                              (1, 2), 0)
