"""The port's differentiable renderer against the JAX package on the CPU.

`render_loss_grad` of the port (plain torch autograd on the CPU, through
both its "xla" route and its "pallas" route, whose CPU wrappers run the
plain versions) against JAX's ``render_loss_grad(backend="xla")`` with the
same mix32 key, at 16x8 and ``max_depth=2`` as tests/test_pallas_grad.py
runs, for l2, log and l2_unbiased with VPLs on and off. Tolerances are the
JAX suite's own (tests/test_pallas_grad.py:88,108): the largest relative
gradient difference ``_max_rel`` below 5e-3 without VPLs and 2e-2 with
them; the loss to 1e-5 relative.

The simple.scn cases run JAX eagerly (``jax.disable_jit``), which skips
its minutes of XLA compiles; measured there: loss within 2e-7 and
``_max_rel`` within 7e-7. The Cornell case runs JAX jitted, as its own
suite does: Cornell's walls are spheres of radius 1e4, whose hit points
keep about 1e-3 of absolute precision, and the eager reference rounds
differently enough (loss 1.9e-5 off) to need the compiled one; jitted,
the loss agreed to 5.8e-6 and ``_max_rel`` read 3.5e-4 for p, 5.2e-4 for
rad, 1.1e-5 for e and 4.7e-5 for c.
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
    Rays as JRays,
)
from gpu_bidirectional_raytracer_tpu.diff import gradients as JG
from gpu_bidirectional_raytracer_tpu.integrators import path_tracer as jpt
from gpu_bidirectional_raytracer_tpu.integrators.direct import (
    static_light_indices as jlights,
)
from gpu_bidirectional_raytracer_tpu.scene import builtin as jbuiltin
from gpu_bidirectional_raytracer_tpu.scene.parser import load_scene as jload
from gpu_bidirectional_raytracer_tpu_torch import rng as trng
from gpu_bidirectional_raytracer_tpu_torch.core.types import Rays
from gpu_bidirectional_raytracer_tpu_torch.diff import gradients as TG
from gpu_bidirectional_raytracer_tpu_torch.integrators import path_tracer as tpt
from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_grad as tpg
from torch_parity import (
    key_words,
    scn,
    to_torch_camera,
    to_torch_config,
    to_torch_scene,
)

torch.set_num_threads(2)

W, H = 16, 8
PARAMS = ("p", "rad", "e", "c")
BOUND_UNI, BOUND_BIDIR = 5e-3, 2e-2   # tests/test_pallas_grad.py:88,108
LOSS_RTOL = 1e-5


def _max_rel(a, b):
    """tests/test_pallas_grad.py::_max_rel: the largest relative
    difference over the entries above 1e-3 of the largest."""
    big = np.abs(a) > 1e-3 * max(np.abs(a).max(), 1e-9)
    if not big.any():
        return 0.0
    return float((np.abs(a - b) / np.maximum(np.abs(a), 1e-6))[big].max())


def _config(vpl):
    return (JConfig(max_depth=2) if vpl else
            JConfig(max_depth=2, use_vpl=False, combine_half=False))


def _setup(scene_name, vpl, seed=0):
    if scene_name == "cornell_builtin":
        scene = jbuiltin.cornell_box()
        orig = jbuiltin.DEFAULT_CAMERA_ORIG
        target = jbuiltin.DEFAULT_CAMERA_TARGET
    else:
        orig, target, scene = jload(scn(f"{scene_name}.scn"))
    cam = JCamera.make(orig, target, W, H)
    img = np.random.default_rng(seed + 1).uniform(
        0.0, 0.5, (H, W, 3)).astype(np.float32)
    return scene, cam, _config(vpl), jlights(scene), jrng.make_key(seed), img


def _eager(fn, *args):
    """A jitted JAX function of the package, run op by op."""
    with jax.disable_jit():
        return fn.__wrapped__(*args)


def _port_loss_grad(scene, cam, cfg, li, key, img, loss, backend):
    return TG.render_loss_grad(
        to_torch_scene(scene), to_torch_camera(cam), key_words(key),
        torch.tensor(img), to_torch_config(cfg), W, H, li, 1, loss, backend)


def _assert_matches(ref_loss, ref_grads, loss, grads, bound):
    ref_loss = float(ref_loss)
    assert abs(float(loss) - ref_loss) <= LOSS_RTOL * abs(ref_loss), (
        float(loss), ref_loss)
    for name in PARAMS:
        a = np.asarray(getattr(ref_grads, name))
        b = getattr(grads, name).numpy()
        assert b.shape == a.shape and np.isfinite(b).all(), name
        assert _max_rel(a, b) < bound, (name, _max_rel(a, b))
    assert not grads.refl.any()


@pytest.mark.parametrize("vpl", [False, True], ids=["novpl", "vpl"])
@pytest.mark.parametrize("loss", ["l2", "log", "l2_unbiased"])
def test_render_loss_grad_matches_jax(loss, vpl):
    scene, cam, cfg, li, key, img = _setup("simple", vpl)
    ref_loss, ref_g = _eager(JG.render_loss_grad, scene, cam, key,
                             jnp.asarray(img), cfg, W, H, li, 1, loss, "xla")
    bound = BOUND_BIDIR if vpl else BOUND_UNI
    # "pallas" on CPU tensors: for l2/log the fused route through
    # `loss_grad_plain` and the pull through the light tracer.
    for backend in ("xla", "pallas"):
        value, grads = _port_loss_grad(scene, cam, cfg, li, key, img, loss,
                                       backend)
        _assert_matches(ref_loss, ref_g, value, grads, bound)


def test_render_loss_grad_matches_jax_cornell_bidirectional():
    scene, cam, cfg, li, key, img = _setup("cornell_builtin", True)
    ref_loss, ref_g = JG.render_loss_grad(scene, cam, key, jnp.asarray(img),
                                          cfg, W, H, li, 1, "l2", "xla")
    for backend in ("xla", "pallas"):
        value, grads = _port_loss_grad(scene, cam, cfg, li, key, img, "l2",
                                       backend)
        _assert_matches(ref_loss, ref_g, value, grads, BOUND_BIDIR)


def test_ray_gradients_match_jax():
    """d radiance / d rays.o, rays.d: the counterpart of
    tests/test_pallas_grad.py::test_primary_ray_gradients_flow, through
    the port's `trace_pallas_diff` (its plain version on the CPU)."""
    scene, cam, cfg, li, key, _ = _setup("cornell_builtin", False)
    g = np.random.default_rng(7)
    n = W * H
    o = np.asarray(cam.orig)[None, :] + g.normal(0.0, 0.5, (n, 3))
    d = np.asarray(cam.dir)[None, :] + g.normal(0.0, 0.15, (n, 3))
    o = o.astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    cot = g.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)

    def jloss(o_, d_):
        rad = jpt.trace(scene, cfg, li, JRays(o=o_, d=d_), key,
                        jnp.int32(0))
        return jnp.sum(rad * cot)

    with jax.disable_jit():
        ref_o, ref_d = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(o),
                                                       jnp.asarray(d))
    to = torch.tensor(o, requires_grad=True)
    td = torch.tensor(d, requires_grad=True)
    rad = tpg.trace_pallas_diff(to_torch_scene(scene), to_torch_config(cfg),
                                li, Rays(o=to, d=td), key_words(key), 0)
    (rad * torch.tensor(cot)).sum().backward()
    for ref, got in ((ref_o, to.grad), (ref_d, td.grad)):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0.0
        assert np.isfinite(got.numpy()).all()
        assert _max_rel(ref, got.numpy()) < BOUND_UNI, _max_rel(
            ref, got.numpy())


def test_unbiased_second_key_is_jax_fold_in():
    for seed in (0, 1, 12345):
        key = jrng.make_key(seed)
        want = key_words(jax.random.fold_in(key, jnp.uint32(0x5EED)))
        assert trng.fold_in(key_words(key), 0x5EED) == want


def test_pixel_grad_fd_matches_jax():
    scene, cam, cfg, li, key, _ = _setup("simple", False)
    tscene, tcam, tcfg = (to_torch_scene(scene), to_torch_camera(cam),
                          to_torch_config(cfg))
    kw = key_words(key)
    for param, index in (("e", (4, 1)), ("c", (0, 0))):
        with jax.disable_jit():
            ref = JG.pixel_grad_fd(
                scene, lambda sc: JG.render_radiance(sc, cam, key, cfg, W, H,
                                                     li, 1),
                param, index, eps=1e-2)
        got = TG.pixel_grad_fd(
            tscene, lambda sc: TG.render_radiance(sc, tcam, kw, tcfg, W, H,
                                                  li, 1),
            param, index, eps=1e-2)
        assert got.shape == ref.shape == (H, W, 3)
        assert np.abs(ref).max() > 0.0
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def test_trace_pallas_diff_on_cpu_is_the_plain_tracer():
    """On CPU tensors the wrapper is `path_tracer.trace`: the same
    radiance, with autograd's gradients, and no kernel launch."""
    scene, cam, cfg, li, key, _ = _setup("simple", False)
    tscene, tcfg = to_torch_scene(scene), to_torch_config(cfg)
    g = np.random.default_rng(3)
    n = W * H
    o = np.repeat(np.asarray(cam.orig)[None, :], n, axis=0)
    d = np.asarray(cam.dir)[None, :] + g.normal(0.0, 0.1, (n, 3))
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays(o=torch.tensor(o, dtype=torch.float32),
                d=torch.tensor(d, dtype=torch.float32))
    before = dict(tpg.LAUNCHES)
    p = tscene.p.clone().requires_grad_()
    got = tpg.trace_pallas_diff(tscene.replace(p=p), tcfg, li, rays,
                                key_words(key), 0)
    ref = tpt.trace(tscene, tcfg, li, rays, key_words(key), 0)
    assert torch.equal(got.detach(), ref)
    got.sum().backward()
    assert torch.isfinite(p.grad).all() and p.grad.abs().max() > 0
    assert tpg.LAUNCHES == before


def test_fused_plain_vpl_cotangent_matches_jax():
    """`loss_grad_plain`'s VPL-buffer cotangent (what the fused step pulls
    through the light tracer) against jax.grad w.r.t. the buffer."""
    from gpu_bidirectional_raytracer_tpu import camera as jcam
    from gpu_bidirectional_raytracer_tpu.integrators import light_tracer as jlt

    from gpu_bidirectional_raytracer_tpu_torch import convert

    scene, cam, cfg, li, key, img = _setup("simple", True)
    s = jnp.int32(0)
    ju = jrng.site_uniforms(key, s, 0, jrng.CAM_JITTER, 2, W * H)
    px, py = jcam.pixel_grid(W, H)
    rays = jcam.primary_rays(cam, W, H, ju[0], ju[1], px, py)
    tgt = jnp.asarray(img).reshape(-1, 3)
    with jax.disable_jit():
        vpls = jlt.trace_light_paths(scene, cfg, li, key, s)

        def jloss(hp, rad, nl):
            v = dataclasses.replace(vpls, hp=hp, rad=rad, nl=nl)
            out = jpt.trace(scene, cfg, li, rays, key, s, vpls=v,
                            vlp_index=jnp.int32(0))
            return jnp.mean((out - tgt) ** 2)

        ref = jax.grad(jloss, argnums=(0, 1, 2))(vpls.hp, vpls.rad, vpls.nl)
    tv = convert.vpls_from_numpy(*(np.asarray(a) for a in (
        vpls.hp, vpls.rad, vpls.nl, vpls.valid, vpls.sid)), device="cpu")
    trays = Rays(o=torch.tensor(np.asarray(rays.o)),
                 d=torch.tensor(np.asarray(rays.d)))
    _, _, dvpl = tpg.loss_grad_plain(
        to_torch_scene(scene), to_torch_config(cfg), li, trays,
        key_words(key), 0, torch.tensor(np.asarray(tgt)), vpls=tv,
        vlp_index=0)
    for a, b in zip(ref, dvpl):
        a = np.asarray(a)
        assert b.shape == a.shape and np.abs(a).max() > 0.0
        assert _max_rel(a, b.numpy()) < BOUND_BIDIR, _max_rel(a, b.numpy())
