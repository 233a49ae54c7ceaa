"""The visibility carrier (``vis_grad_tau``) of the port against the JAX
package on the CPU.

- `intersect.soft_visibility` against JAX's on random segments through a
  scene of ten spheres (two emitters), with the vacuum mask, a sphere
  excluded per segment, segment ends straddling a chord's entry, and rays
  grazing a sphere: values to 1e-6 relative, the gradients of every input
  to a `_max_rel` below 1e-4 (measured: values exact, gradients 1.5e-5).
- Images do not move: with both carriers on, `render_radiance` is the
  same bits as without them, and it meets tests/test_pallas.py's protocol
  against JAX's render.
- Gradients with the carrier against ``jax.grad`` of JAX's XLA tracer,
  on tests/test_pallas_grad.py's own setups (its keys, sizes and loss
  ``sum(rad ** 2)``) and with its bounds (`_max_rel` below 5e-3
  unidirectional, 2e-2 with VPLs; the fused step at rtol 2e-3, atol 2e-3
  of the largest entry, the loss to 1e-5): the occluder scene of
  tests/test_pallas_grad.py:110-160, which is also held to JAX's Pallas
  adjoint in interpret mode; Cornell with VPLs; the fused l2 step at
  vis_tau 0 and 2; the re-walk (`trace_bounce_diff`) past 64 spheres.
  Cornell's walls are spheres that contain the whole box, so every shadow
  segment starts inside six of them, soft visibility is 0 and the carrier
  adds nothing there, in JAX as in the port: the occluder scene with VPLs
  holds the vacuum carrier of the VPL gather, and a 90-sphere scene built
  on it the re-walk's carrier, beside the Cornell-based one of
  tests/test_torch_bounce_grad.py. JAX's threefry keys are used because
  with mix32 keys jitted JAX differs from eager JAX on these frames by a
  `_max_rel` of up to 9e-2 (knife edges; ROADMAP queue 3), where the port
  follows eager JAX to 1e-5.
- The VPL table carries each VPL's host sphere in column 10, as JAX's.
- ``with_stats`` counts the carrier's blocker terms.
- The adjoint launch refuses a positive tau that vanishes in float32,
  where the kernel picks the carrier by the float32 tau's sign.

JAX runs jitted, compiled once per case; measured here, the file takes
about 100 s of one worker, 35 s of it JAX's Pallas adjoint in interpret
mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_bidirectional_raytracer_tpu import rng as jrng
from gpu_bidirectional_raytracer_tpu.core.types import (
    Camera as JCamera,
    IntegratorConfig as JConfig,
    Scene as JScene,
    VplBuffer as JVplBuffer,
)
from gpu_bidirectional_raytracer_tpu.diff import gradients as JG
from gpu_bidirectional_raytracer_tpu.integrators import intersect as jis
from gpu_bidirectional_raytracer_tpu.integrators import light_tracer as jlt
from gpu_bidirectional_raytracer_tpu.integrators import path_tracer as jpt
from gpu_bidirectional_raytracer_tpu.integrators.direct import (
    static_light_indices as jlights,
)
from gpu_bidirectional_raytracer_tpu.ops import pallas_trace as jops
from gpu_bidirectional_raytracer_tpu.ops.pallas_bounce_grad import (
    trace_bounce_diff as jbounce_diff,
)
from gpu_bidirectional_raytracer_tpu.ops.pallas_grad import (
    trace_pallas_diff as jtrace_pallas_diff,
)
from gpu_bidirectional_raytracer_tpu.render.progressive import frame_rays
from gpu_bidirectional_raytracer_tpu.scene import builtin as jbuiltin
from gpu_bidirectional_raytracer_tpu.scene.parser import load_scene as jload
from gpu_bidirectional_raytracer_tpu_torch import rng as trng
from gpu_bidirectional_raytracer_tpu_torch.diff import gradients as TG
from gpu_bidirectional_raytracer_tpu_torch.integrators import intersect as tis
from gpu_bidirectional_raytracer_tpu_torch.integrators import path_tracer as tpt
from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_bounce_grad as tpbg
from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_grad as tpg
from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace as tops
from torch_parity import (
    assert_protocol,
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
BOUND_UNI, BOUND_BIDIR = 5e-3, 2e-2   # tests/test_pallas_grad.py:88,108
LOSS_RTOL = 1e-5
SOFT_RTOL, SOFT_GRAD = 1e-6, 1e-4
TAU = 2.0


def _occluder_scene(extra: int = 0, seed: int = 3):
    """simple.scn with a diffuse sphere of radius 6 at (0, 40, 0) between
    its light and its floor (tests/test_pallas_grad.py:110-160), and
    ``extra`` small diffuse spheres from a numpy seed above the floor."""
    orig, target, base = jload(scn("simple.scn"))
    pos = np.concatenate([
        [[0.0, 40.0, 0.0]],
        np.random.default_rng(seed).uniform(-60.0, 60.0, (extra, 3))
        * np.array([1.0, 0.0, 1.0]) + np.array([0.0, 3.0, 0.0])])
    k = 1 + extra
    return orig, target, JScene(
        rad=jnp.concatenate([base.rad, jnp.array([6.0] + [2.0] * extra)]),
        p=jnp.concatenate([base.p, jnp.asarray(pos, jnp.float32)]),
        e=jnp.concatenate([base.e, jnp.zeros((k, 3))]),
        c=jnp.concatenate([base.c, jnp.full((k, 3), 0.5)]),
        refl=jnp.concatenate([base.refl, jnp.zeros((k,), jnp.int32)]))


def _segments(case: str, scene, n: int = 96, seed: int = 0):
    """Shadow segments ``(o, d, maxt, exclude)`` for `soft_visibility`."""
    rng = np.random.default_rng(seed)
    p, rad = np.asarray(scene.p), np.asarray(scene.rad)
    o = rng.uniform(-5.0, 55.0, (n, 3)).astype(np.float32)
    q = rng.uniform(-5.0, 55.0, (n, 3))
    s = rng.integers(0, len(rad), n)
    if case in ("straddle", "tangent"):
        # Aim at sphere s: straight at its centre, whose chord entry t1
        # the segment end then straddles, or along a tangent line.
        to_c = p[s] - o
        dist = np.linalg.norm(to_c, axis=1, keepdims=True)
        u = to_c / dist
        side = np.cross(u, rng.normal(size=(n, 3)))
        side /= np.linalg.norm(side, axis=1, keepdims=True)
        off = (rad[s] * (1.0 + rng.uniform(-1e-3, 1e-3, n))
               if case == "tangent" else rng.uniform(0.0, 0.5, n) * rad[s])
        q = p[s] + side * off[:, None]
    d = q - o
    length = np.linalg.norm(d, axis=1)
    d = (d / length[:, None]).astype(np.float32)
    if case == "straddle":
        op = p[s] - o
        b = np.sum(op * d, axis=1)
        det = b * b - np.sum(op * op, axis=1) + rad[s] ** 2
        t1 = b - np.sqrt(np.maximum(det, 1e-6))
        maxt = t1 + rng.uniform(-0.5, 0.5, n)
    else:
        maxt = length - 0.01
    return o, d, maxt.astype(np.float32), s.astype(np.int32)


def _ten_spheres():
    rng = np.random.default_rng(5)
    return JScene(
        rad=jnp.asarray(rng.uniform(3.0, 8.0, 10), jnp.float32),
        p=jnp.asarray(rng.uniform(0.0, 50.0, (10, 3)), jnp.float32),
        e=jnp.asarray(np.where(np.arange(10)[:, None] < 2, 5.0, 0.0)
                      * np.ones((1, 3)), jnp.float32),
        c=jnp.full((10, 3), 0.5), refl=jnp.zeros((10,), jnp.int32))


@pytest.mark.parametrize("case", ["plain", "vacuum", "exclude", "straddle",
                                  "tangent"])
def test_soft_visibility_matches_jax(case):
    scene = _ten_spheres()
    o, d, maxt, s = _segments(case, scene)
    vacuum = case == "vacuum"
    exclude = case in ("exclude", "straddle")
    w = np.random.default_rng(1).uniform(0.0, 1.0, o.shape[0]).astype(
        np.float32)

    def jsoft(p, rad, o_, d_, maxt_):
        return jis.soft_visibility(
            scene.replace(p=p, rad=rad), o_, d_, maxt_, TAU, vacuum=vacuum,
            exclude_id=jnp.asarray(s) if exclude else None)

    args = (scene.p, scene.rad, o, d, maxt)
    want = np.asarray(jsoft(*args))
    want_g = jax.grad(lambda *a: jnp.sum(w * jsoft(*a)),
                      argnums=tuple(range(5)))(*args)
    leaves = [torch.tensor(np.asarray(a)).requires_grad_() for a in args]
    got = tis.soft_visibility(
        to_torch_scene(scene).replace(p=leaves[0], rad=leaves[1]),
        *leaves[2:], TAU, vacuum=vacuum,
        exclude_id=torch.tensor(s, dtype=torch.int64) if exclude else None)
    got_g = torch.autograd.grad((torch.tensor(w) * got).sum(), leaves)
    assert 0.0 < want.mean() < 1.0
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=SOFT_RTOL,
                               atol=SOFT_RTOL)
    for name, a, b in zip(("p", "rad", "o", "d", "maxt"), want_g, got_g):
        assert np.abs(np.asarray(a)).max() > 0.0, name
        assert max_rel(np.asarray(a), b.numpy()) < SOFT_GRAD, (
            name, max_rel(np.asarray(a), b.numpy()))


def _port_key(key):
    """The port's key of a JAX threefry key (``jax.random.key``)."""
    return trng.ThreefryKey(key_words(key))


def _rays(scene, orig, target, cfg, w, h, key):
    cam = JCamera.make(orig, target, w, h)
    return cam, frame_rays(cam, cfg, w, h, key, jnp.int32(0))


def _port_grads(tracer, scene, cfg, li, rays, key, vpls):
    """Gradients of ``sum(rad ** 2)`` (tests/test_pallas_grad.py's loss)
    w.r.t. the scene, through the port's ``tracer`` on CPU tensors;
    ``vpls="traced"`` traces the VPLs inside the graph."""
    ts = to_torch_scene(scene)
    leaves = [getattr(ts, k).clone().requires_grad_() for k in PARAMS]
    sc = ts.replace(**dict(zip(PARAMS, leaves)))
    tcfg = to_torch_config(cfg)
    vb = None
    if vpls == "traced":
        from gpu_bidirectional_raytracer_tpu_torch.integrators import (
            light_tracer,
        )

        vb = light_tracer.trace_light_paths(sc, tcfg, li, _port_key(key), 0)
    elif vpls is not None:
        vb = to_torch_vpls(vpls)
    rad = tracer(sc, tcfg, li, torch_rays(rays), _port_key(key), 0,
                 vpls=vb, vlp_index=None if vb is None else 0)
    return torch.autograd.grad((rad ** 2).sum(), leaves, allow_unused=True)


def _jax_grads(tracer, scene, cfg, li, rays, key, vpls):
    def loss(sc):
        vb = vpls
        if vpls == "traced":
            vb = jlt.trace_light_paths(sc, cfg, li, key, jnp.int32(0))
        return jnp.sum(tracer(
            sc, cfg, li, rays, key, jnp.int32(0), vpls=vb,
            vlp_index=None if vb is None else jnp.int32(0)) ** 2)

    return jax.jit(jax.grad(loss, allow_int=True))(scene)


def _assert_grads(ref, got, bound):
    for name, g in zip(PARAMS, got):
        a = np.asarray(getattr(ref, name))
        b = np.zeros_like(a) if g is None else g.numpy()
        assert np.isfinite(b).all(), name
        assert max_rel(a, b) < bound, (name, max_rel(a, b))


@pytest.mark.parametrize("case", ["occluder", "occluder_vpl", "cornell_vpl"])
def test_visibility_gradient_matches_jax(case):
    """tests/test_pallas_grad.py's two visibility cases (the occluder
    scene at 16x12 without VPLs; Cornell at 16x8 with VPLs traced in the
    graph; ``max_depth`` 2, ``jax.random.key(0)``, the loss ``sum(rad **
    2)``), and the occluder scene with VPLs."""
    key = jax.random.key(0)
    if case.startswith("occluder"):
        w, h = 16, 12
        orig, target, scene = _occluder_scene()
    else:
        w, h = 16, 8
        scene = jbuiltin.cornell_box()
        orig, target = (jbuiltin.DEFAULT_CAMERA_ORIG,
                        jbuiltin.DEFAULT_CAMERA_TARGET)
    cfg = (JConfig(max_depth=2, use_vpl=False, combine_half=False,
                   vis_grad_tau=TAU) if case == "occluder"
           else JConfig(max_depth=2, vis_grad_tau=TAU))
    li = jlights(scene)
    _, rays = _rays(scene, orig, target, cfg, w, h, key)
    vpls = None if case == "occluder" else "traced"
    ref = _jax_grads(jpt.trace, scene, cfg, li, rays, key, vpls)
    got = _port_grads(tpg.trace_pallas_diff, scene, cfg, li, rays, key,
                      vpls)
    _assert_grads(ref, got, BOUND_UNI if vpls is None else BOUND_BIDIR)
    off = _port_grads(tpg.trace_pallas_diff, scene,
                      dataclasses.replace(cfg, vis_grad_tau=0.0), li, rays,
                      key, vpls)
    if case.startswith("occluder"):
        # The carrier fires: the occluder's position gradient moves.
        assert not torch.equal(got[0][-1], off[0][-1])
    else:
        # Every shadow segment in Cornell starts inside the six wall
        # spheres, which block it fully: soft visibility is 0 and the
        # carrier adds nothing, in JAX as in the port.
        assert all(torch.equal(a, b) for a, b in zip(got, off)
                   if a is not None)
    if case == "occluder":
        # And against JAX's hand-written adjoint (interpret mode).
        pal = _jax_grads(
            lambda *a, **k: jtrace_pallas_diff(*a, **k, interpret=True,
                                               tile_rows=8),
            scene, cfg, li, rays, key, None)
        _assert_grads(pal, got, BOUND_UNI)


@pytest.mark.parametrize("vis_tau", [0.0, TAU])
def test_fused_step_with_carrier_matches_jax(vis_tau):
    """tests/test_pallas_grad.py::TestFusedStep: the l2 step on Cornell at
    16x16, ``max_depth`` 2, ``jax.random.key(3)``, target 0.2."""
    w, h = 16, 16
    scene = jbuiltin.cornell_box()
    cam = JCamera.make(jbuiltin.DEFAULT_CAMERA_ORIG,
                       jbuiltin.DEFAULT_CAMERA_TARGET, w, h)
    cfg = dataclasses.replace(JConfig(), max_depth=2, vis_grad_tau=vis_tau)
    li = jlights(scene)
    key = jax.random.key(3)
    target = jnp.full((h, w, 3), 0.2)
    lx, gx = JG.render_loss_grad(scene, cam, key, target, cfg, w, h, li, 1,
                                 "l2", "xla")
    # "pallas" on CPU tensors: the fused route through `loss_grad_plain`.
    lf, gf = TG.render_loss_grad(
        to_torch_scene(scene), to_torch_camera(cam), _port_key(key),
        torch.tensor(np.asarray(target)), to_torch_config(cfg), w, h, li, 1,
        "l2", "pallas")
    assert abs(float(lf) - float(lx)) <= LOSS_RTOL * abs(float(lx))
    for name in PARAMS:
        a = np.asarray(getattr(gx, name))
        scale = max(np.abs(a).max(), 1e-12)
        np.testing.assert_allclose(getattr(gf, name).numpy(), a, rtol=2e-3,
                                   atol=2e-3 * scale, err_msg=name)


@pytest.mark.parametrize("which", ["many_cornell", "many_occluder"])
def test_rewalk_with_carrier_matches_jax(which):
    """`trace_bounce_diff` past 64 spheres, the facts from the plain
    collector, against ``jax.grad`` of JAX's re-walk: the 89-sphere
    Cornell scene of tests/test_torch_bounce_grad.py, where the walls hold
    every segment and the carrier adds nothing, and the occluder scene
    with 84 small spheres (90 in all), where it fires."""
    w, h = 8, 6
    if which == "many_cornell":
        scene = many_sphere_scene()
        orig, target = (jbuiltin.DEFAULT_CAMERA_ORIG,
                        jbuiltin.DEFAULT_CAMERA_TARGET)
    else:
        orig, target, scene = _occluder_scene(extra=84)
    assert scene.num_spheres > 64
    cfg = JConfig(max_depth=3, vis_grad_tau=TAU)
    li = jlights(scene)
    key = jax.random.key(3)
    _, rays = _rays(scene, orig, target, cfg, w, h, key)
    vpls = floating_vpl(cfg)
    ref = _jax_grads(lambda *a, **k: jbounce_diff(*a, **k, facts="xla"),
                     scene, cfg, li, rays, key, vpls)
    got = _port_grads(tpbg.trace_bounce_diff, scene, cfg, li, rays, key,
                      vpls)
    _assert_grads(ref, got, BOUND_BIDIR)
    off = _port_grads(tpbg.trace_bounce_diff, scene,
                      dataclasses.replace(cfg, vis_grad_tau=0.0), li, rays,
                      key, vpls)
    assert torch.equal(got[0], off[0]) == (which == "many_cornell")


def test_images_do_not_move():
    """Both carriers on: the same bits as without them (under autograd, so
    the carriers are built), and JAX's render under the protocol."""
    w, h = 16, 12
    orig, target, scene = _occluder_scene()
    cfg = JConfig(max_depth=3)
    cam = JCamera.make(orig, target, w, h)
    li = jlights(scene)
    key = jrng.make_key(1)
    ts, tcam = to_torch_scene(scene), to_torch_camera(cam)
    tcfg = to_torch_config(cfg)
    on = dataclasses.replace(tcfg, vis_grad_tau=TAU, sil_grad_tau=TAU)
    with torch.enable_grad():
        sc = ts.replace(p=ts.p.clone().requires_grad_())
        plain = TG.render_radiance(sc, tcam, key_words(key), tcfg, w, h, li,
                                   2)
        carried = TG.render_radiance(sc, tcam, key_words(key), on, w, h, li,
                                     2)
    assert carried.requires_grad
    assert torch.equal(carried, plain)
    ref = JG.render_radiance(scene, cam, key, cfg, w, h, li, 2)
    assert_protocol(carried.detach().numpy(), np.asarray(ref))


def test_vpl_table_carries_the_host_sphere():
    """Column 10 of the VPL table is each VPL's host sphere (JAX's
    `_vpl_table`), -1 where the buffer records none; the window wraps."""
    cfg = JConfig(vpl_depth=2, max_vlp=4, light_points=8)
    rng = np.random.default_rng(4)
    vpls = JVplBuffer(
        hp=jnp.asarray(rng.normal(size=(2, 8, 3)), jnp.float32),
        rad=jnp.asarray(rng.uniform(size=(2, 8, 3)), jnp.float32),
        nl=jnp.asarray(rng.normal(size=(2, 8, 3)), jnp.float32),
        valid=jnp.asarray(rng.uniform(size=(2, 8)) < 0.7),
        sid=jnp.asarray(rng.integers(0, 9, (2, 8)), jnp.int32))
    want, _, _ = jops._vpl_table(cfg, vpls, jnp.int32(6))
    tv = to_torch_vpls(vpls)
    got = tops._vpl_table(to_torch_config(cfg), tv, 6, "cpu")
    np.testing.assert_array_equal(got[:, :11].numpy(),
                                  np.asarray(want)[:, :11])
    none = tops._vpl_table(to_torch_config(cfg),
                           dataclasses.replace(tv, sid=None), 6, "cpu")
    assert (none[:, 10] == -1.0).all()


def test_stats_count_the_carrier_terms():
    """Without VPLs each cast light sample makes two terms per candidate
    blocker (every sphere but the target light); with the carrier off,
    none."""
    orig, target, scene = _occluder_scene()
    ts = to_torch_scene(scene)
    w, h = 16, 12
    key = jrng.make_key(0)
    cfg = JConfig(max_depth=3, use_vpl=False, combine_half=False,
                  vis_grad_tau=TAU)
    _, rays = _rays(scene, orig, target, cfg, w, h, key)
    li = jlights(scene)
    _, on = tpt.trace(ts, to_torch_config(cfg), li, torch_rays(rays),
                      key_words(key), 0, with_stats=True)
    _, off = tpt.trace(ts, to_torch_config(
        dataclasses.replace(cfg, vis_grad_tau=0.0)), li, torch_rays(rays),
        key_words(key), 0, with_stats=True)
    assert on["shadow_rays"] > 0
    assert on["carrier_terms"] == 2 * (ts.num_spheres - 1) * on[
        "shadow_rays"]
    assert off["carrier_terms"] == 0
    assert {k: v for k, v in on.items() if k != "carrier_terms"} == {
        k: v for k, v in off.items() if k != "carrier_terms"}


@pytest.mark.parametrize("tau,refused", [(1e-40, True), (1e-50, True),
                                         (1e-30, False), (0.0, False)])
def test_launch_refuses_taus_that_vanish_in_float32(tau, refused):
    """The kernels pick the carrier by the float32 tau's sign: a positive
    tau below float32's smallest normal is refused before a launch, since
    the plain tracer would carry it and the kernel might not."""
    cfg = to_torch_config(JConfig(vis_grad_tau=tau))
    if refused:
        with pytest.raises(ValueError, match="smallest normal"):
            tpg._check_launch(cfg, 1, 1)
    else:
        tpg._check_launch(cfg, 1, 1)
