"""The port's matmul sphere scans, its per-depth checkpointing and the
census of its facts collector, against the JAX package on the CPU.

- `intersect.sphere_distances(method="mxu")`: roots against JAX's matmul
  form and against the direct form, with tests/test_mxu.py's tolerances
  (the expanded quadratic loses about three digits where Cornell's
  1e4-radius walls make ``|p|^2`` about 1e8);
- `path_tracer.trace(scan_backend="mxu")` against JAX's under the radiance
  protocol of tests/test_pallas.py (16x12);
- `render_loss_grad(backend="mxu")` on tests/test_mxu.py's 80-sphere scene
  at 16x12 against JAX's ``backend="mxu"`` (JAX jitted): the loss to 1e-5
  relative and the gradients under tests/test_torch_grad.py's protocol
  (``_max_rel`` below 5e-3, no VPLs); and against the port's own
  ``backend="xla"`` with tests/test_mxu.py's bounds (loss within 2e-2,
  cosine above 0.98). Measured: loss 3.2e-6 off JAX, ``_max_rel`` at most
  3.5e-3 (c), cosine against "xla" 0.99999;
- ``remat=True`` (each depth under `torch.utils.checkpoint`) gives the
  values and gradients of ``remat=False`` bit for bit;
- entries 3-5 of ``collect_aux`` (the NEE gates, the glass branch bits and
  the root choice) against JAX's on Cornell at 16x12, where 0.2-0.3% of
  the entries sit on knife edges (measured) and at most 2% may differ, the
  bound tests/test_torch_bounce_grad.py holds the hit ids to.
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
    Scene as JScene,
)
from gpu_bidirectional_raytracer_tpu.diff import gradients as JG
from gpu_bidirectional_raytracer_tpu.integrators import intersect as jisect
from gpu_bidirectional_raytracer_tpu.integrators import path_tracer as jpt
from gpu_bidirectional_raytracer_tpu.integrators.direct import (
    static_light_indices as jlights,
)
from gpu_bidirectional_raytracer_tpu.scene import builtin as jbuiltin
from gpu_bidirectional_raytracer_tpu.scene.parser import load_scene as jload
from gpu_bidirectional_raytracer_tpu_torch.diff import gradients as TG
from gpu_bidirectional_raytracer_tpu_torch.integrators import intersect as tisect
from gpu_bidirectional_raytracer_tpu_torch.integrators import path_tracer as tpt
from torch_parity import (
    assert_protocol,
    floating_vpl,
    key_words,
    max_rel,
    scn,
    to_torch_camera,
    to_torch_config,
    to_torch_scene,
    to_torch_vpls,
    torch_rays,
)

torch.set_num_threads(2)

W, H = 16, 12
PARAMS = ("p", "rad", "e", "c")
BOUND_UNI = 5e-3          # tests/test_pallas_grad.py:88
LOSS_RTOL = 1e-5
MAX_FLIP = 0.02           # tests/test_bounce_grad.py::TestKernelFacts


def mxu_scene(n_spheres=80):
    """tests/test_mxu.py::_many_sphere_scene: 80 diffuse spheres, the
    first an emitter."""
    r = np.random.default_rng(42)
    rad = r.uniform(1.0, 6.0, n_spheres).astype(np.float32)
    p = r.uniform(-40, 40, (n_spheres, 3)).astype(np.float32)
    c = r.uniform(0.1, 0.9, (n_spheres, 3)).astype(np.float32)
    e = np.zeros((n_spheres, 3), np.float32)
    e[0] = [15, 15, 15]
    c[0] = 0
    return JScene(rad=jnp.asarray(rad), p=jnp.asarray(p), e=jnp.asarray(e),
                  c=jnp.asarray(c),
                  refl=jnp.zeros(n_spheres, jnp.int32))


def rig(scene, cam, seed=0):
    key = jrng.make_key(seed)
    u = jrng.site_uniforms(key, 0, 0, jrng.CAM_JITTER, 2, W * H)
    px, py = jcam.pixel_grid(W, H)
    return jlights(scene), key, jcam.primary_rays(cam, W, H, u[0], u[1],
                                                  px, py)


def cornell_cam():
    return JCamera.make(jbuiltin.DEFAULT_CAMERA_ORIG,
                        jbuiltin.DEFAULT_CAMERA_TARGET, W, H)


def test_mxu_roots_match_jax_and_the_direct_form():
    """tests/test_mxu.py::test_mxu_roots_match_direct for the port, and
    the port's matmul roots against JAX's."""
    scene = jbuiltin.cornell_box()
    r = np.random.default_rng(7)
    o = r.uniform([5, 5, 5], [95, 75, 165], (256, 3)).astype(np.float32)
    d = r.normal(size=(256, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    ts, to, td = to_torch_scene(scene), torch.tensor(o), torch.tensor(d)
    mxu = tisect.sphere_distances(ts, to, td, method="mxu").numpy()
    direct = tisect.sphere_distances(ts, to, td).numpy()
    jax_mxu = np.asarray(jisect.sphere_distances(
        scene, jnp.asarray(o), jnp.asarray(d), method="mxu"))
    for ref in (direct, jax_mxu):
        both = (ref > 0) & (mxu > 0)
        assert both.mean() > 0.5
        np.testing.assert_allclose(mxu[both], ref[both], rtol=1e-3,
                                   atol=2e-2)
        assert ((ref > 0) != (mxu > 0)).mean() < 0.01
    with pytest.raises(ValueError, match="method"):
        tisect.sphere_distances(ts, to, td, method="bvh")


TRACES = {"cornell_golden": (jbuiltin.cornell_box, cornell_cam,
                             JConfig.cpu_golden()),
          "cornell_no_vpl": (jbuiltin.cornell_box, cornell_cam,
                             JConfig(use_vpl=False)),
          "mxu80": (mxu_scene, lambda: JCamera.make([0, 10, 120], [0, 0, 0],
                                                    W, H),
                    JConfig.cpu_golden())}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_mxu_trace_matches_jax(name):
    make, cam, cfg = TRACES[name]
    scene = make()
    li, key, rays = rig(scene, cam())
    ref = np.asarray(jpt.trace(scene, cfg, li, rays, key, jnp.int32(0),
                               scan_backend="mxu"))
    got = tpt.trace(to_torch_scene(scene), to_torch_config(cfg), li,
                    torch_rays(rays), key_words(key), 0, scan_backend="mxu")
    assert_protocol(got.numpy(), ref)
    assert ref.max() > 0.01


def test_mxu_loss_grad_matches_jax_and_the_direct_form():
    scene = mxu_scene()
    cam = JCamera.make([0, 10, 120], [0, 0, 0], W, H)
    li = jlights(scene)
    cfg = JConfig.cpu_golden()
    key = jrng.make_key(0)
    ref_loss, ref_g = JG.render_loss_grad(scene, cam, key,
                                          jnp.zeros((H, W, 3)), cfg, W, H,
                                          li, 1, "l2", "mxu")
    args = (to_torch_scene(scene), to_torch_camera(cam), key_words(key),
            torch.zeros((H, W, 3)), to_torch_config(cfg), W, H, li, 1, "l2")
    loss_m, g_m = TG.render_loss_grad(*args, "mxu")
    loss_x, g_x = TG.render_loss_grad(*args, "xla")
    assert abs(float(loss_m) - float(ref_loss)) <= LOSS_RTOL * abs(
        float(ref_loss))
    np.testing.assert_allclose(float(loss_m), float(loss_x), rtol=2e-2)
    for name in PARAMS:
        a = np.asarray(getattr(ref_g, name))
        gm = getattr(g_m, name).numpy()
        gx = getattr(g_x, name).numpy()
        assert gm.shape == a.shape and np.isfinite(gm).all(), name
        assert max_rel(a, gm) < BOUND_UNI, (name, max_rel(a, gm))
        cos = float((gm * gx).sum()
                    / (np.linalg.norm(gm) * np.linalg.norm(gx)))
        assert cos > 0.98, (name, cos)
    # The plain route takes the matmul scans: not the direct form's bits.
    assert float(loss_m) != float(loss_x)


def _loss_and_grads(scene, cfg, li, rays, key, vpls, remat):
    leaves = {k: getattr(scene, k).clone().requires_grad_() for k in PARAMS}
    o = rays.o.clone().requires_grad_()
    sc = scene.replace(**leaves)
    wts = torch.tensor(np.random.default_rng(5).uniform(
        0.0, 1.0, (W * H, 3)).astype(np.float32))
    with torch.enable_grad():
        rad = tpt.trace(sc, cfg, li, rays.__class__(o=o, d=rays.d), key, 0,
                        vpls=vpls, vlp_index=0, remat=remat)
        grads = torch.autograd.grad((wts * rad).sum(),
                                    list(leaves.values()) + [o])
    return rad.detach(), grads


@pytest.mark.parametrize("scene_name", ["simple", "cornell"])
def test_remat_gives_the_same_bits(scene_name):
    orig, target, scene = jload(scn(f"{scene_name}.scn"))
    cam = JCamera.make(orig, target, W, H)
    cfg = JConfig(max_depth=4)
    li, key, rays = rig(scene, cam)
    args = (to_torch_scene(scene), to_torch_config(cfg), li,
            torch_rays(rays), key_words(key),
            to_torch_vpls(floating_vpl(cfg)))
    rad0, g0 = _loss_and_grads(*args, remat=False)
    rad1, g1 = _loss_and_grads(*args, remat=True)
    assert rad0.max() > 0.0 and torch.equal(rad0, rad1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(bool(g.abs().max() > 0) for g in g0)
    # with_stats under a checkpointed walk counts each depth once.
    ts, tcfg, _, tr, tk, tv = args
    counts = [tpt.trace(ts, tcfg, li, tr, tk, 0, vpls=tv, vlp_index=0,
                        remat=remat, with_stats=True)[1]
              for remat in (False, True)]
    assert counts[0] == counts[1]


def test_census_entries_match_jax():
    """Entries 3-5 of ``collect_aux`` against JAX's collector; entries 0-2
    stay the re-walk's (tests/test_torch_bounce_grad.py)."""
    scene = jbuiltin.cornell_box()
    cfg = JConfig()
    li, key, rays = rig(scene, cornell_cam())
    vpls = floating_vpl(cfg)
    _, jaux = jpt.trace(scene, cfg, li, rays, key, jnp.int32(0), vpls=vpls,
                        vlp_index=jnp.int32(0), collect_aux=True)
    rad, aux = tpt.trace(to_torch_scene(scene), to_torch_config(cfg), li,
                         torch_rays(rays), key_words(key), 0,
                         vpls=to_torch_vpls(vpls), vlp_index=0,
                         collect_aux=True)
    assert len(aux) == len(jaux) == 6
    walk = tpt.trace(to_torch_scene(scene), to_torch_config(cfg), li,
                     torch_rays(rays), key_words(key), 0,
                     vpls=to_torch_vpls(vpls), vlp_index=0, aux=aux)
    assert torch.equal(walk, rad)
    for i in (3, 4, 5):
        got, want = aux[i].numpy(), np.asarray(jaux[i])
        assert got.shape == want.shape and got.dtype == want.dtype, i
        assert (got != want).mean() <= MAX_FLIP, (i, (got != want).mean())
    bits, near = aux[4].numpy(), aux[5].numpy()
    assert (bits == -1).any() and (bits >= 0).any() and (bits > 0).any()
    assert (near == -1).any() and (near == 0).any() and (near == 1).any()
    np.testing.assert_array_equal(aux[3].numpy(), ~aux[1].numpy())
