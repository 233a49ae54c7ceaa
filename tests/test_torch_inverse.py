"""The port's `InverseRenderer` against the JAX package's.

Both fitters draw their tapes from the threefry key of the seed
(``jax.random.key(seed)``; the port's ``rng.make_key(seed, "threefry")``),
folded with the step when resampling, so the port's fitter runs beside the
JAX class itself (`test_inverse_steps_match_jax_fitter`). With its keys
swapped for mix32 keys (the render tape), the test also replays JAX's
rule: JAX's ``render_loss_grad(backend="xla")`` on the mix32 keys, then
``optax.adam`` and the fitter's projections. Both hold
the port's parameters to JAX's after each of 3 steps (2 beside the JAX
class): to 1e-5 of the parameter's value, plus 1e-4 of the distance Adam
can move it (``lr`` per step). The second term is there because Adam
divides each gradient by its own running scale, so a small gradient's
relative error reaches the step undiminished: sphere 1's z-gradient
(about 1% of the array's largest) differs between the port and JAX by
1.8e-4 relative (float order, within the JAX suite's 5e-3), and after two
steps of lr 0.5 its z differs by 4.1e-5 (measured). simple.scn, 16x8,
``max_depth=2``; JAX runs eagerly (``jax.disable_jit``) to skip its XLA
compiles. The plateau
bookkeeping (``patience``, ``best_scene``) and the projections are
compared with the JAX class itself, on scripted gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gpu_bidirectional_raytracer_tpu import rng as jrng
from gpu_bidirectional_raytracer_tpu.core.types import (
    Camera as JCamera,
    IntegratorConfig as JConfig,
)
from gpu_bidirectional_raytracer_tpu.diff import gradients as JG
from gpu_bidirectional_raytracer_tpu.integrators.direct import (
    static_light_indices as jlights,
)
from gpu_bidirectional_raytracer_tpu.scene.parser import load_scene as jload
from gpu_bidirectional_raytracer_tpu_torch import rng as trng
from gpu_bidirectional_raytracer_tpu_torch.core.types import IntegratorConfig
from gpu_bidirectional_raytracer_tpu_torch.diff import gradients as TG
from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_grad as tpg
from torch_parity import (
    key_words,
    scn,
    to_torch_camera,
    to_torch_config,
    to_torch_scene,
)

torch.set_num_threads(2)

W, H, STEPS = 16, 8, 3
PARAM_RTOL, STEP_RTOL = 1e-5, 1e-4


def _setup(vpl):
    orig, target, scene = jload(scn("simple.scn"))
    cam = JCamera.make(orig, target, W, H)
    cfg = (JConfig(max_depth=2) if vpl else
           JConfig(max_depth=2, use_vpl=False, combine_half=False))
    li = jlights(scene)
    with jax.disable_jit():
        img = JG.render_radiance.__wrapped__(scene, cam, jrng.make_key(0),
                                             cfg, W, H, li, 1, "xla")
    wrong = scene.replace(
        c=scene.c.at[0].set(jnp.array([0.5, 0.6, 0.9])),
        p=scene.p.at[2, 0].add(3.0),
        rad=scene.rad.at[3].add(-2.0))
    return wrong, cam, cfg, li, img


def _jax_replay(scene, cam, cfg, li, target, *, lr, optimize, resample,
                loss, grad_mask=None, seed=0, spp=1, min_radius=0.1):
    """The JAX fitter's step on mix32 keys: loss, grads, optax.adam, the
    projections. Returns the parameters after each step."""
    tx = optax.adam(lr)
    params = {k: getattr(scene, k) for k in optimize}
    state = tx.init(params)
    out = []
    for step in range(STEPS):
        key = jrng.make_key(seed)
        if resample:
            key = jax.random.fold_in(key, step)
        with jax.disable_jit():
            _, grads = JG.render_loss_grad.__wrapped__(
                scene, cam, key, target, cfg, W, H, li, spp, loss, "xla")
        g = {k: getattr(grads, k) for k in optimize}
        if grad_mask:
            g = {k: (v * jnp.reshape(jnp.asarray(grad_mask[k], v.dtype),
                                     (-1,) + (1,) * (v.ndim - 1))
                     if k in grad_mask else v) for k, v in g.items()}
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        if "rad" in params:
            params["rad"] = jnp.maximum(params["rad"], min_radius)
        if "c" in params:
            params["c"] = jnp.clip(params["c"], 0.0, 1.0)
        if "e" in params:
            params["e"] = jnp.maximum(params["e"], 0.0)
        scene = scene.replace(**params)
        out.append({k: np.asarray(v) for k, v in params.items()})
    return out


CASES = {
    # fixed tape, l2 (the default loss off resampling), albedo
    "albedo_fixed_l2": dict(vpl=False, lr=0.08, optimize=("c",),
                            resample=False, loss=None),
    # resampled tape, l2_unbiased (the default), geometry
    "geometry_resampled_unbiased": dict(vpl=False, lr=0.5,
                                        optimize=("p", "rad"),
                                        resample=True, loss=None),
    # grad_mask freezes sphere 1's albedo and the ground's emission
    "masked_albedo_emission": dict(
        vpl=False, lr=0.08, optimize=("c", "e"), resample=False, loss="l2",
        grad_mask={"c": [1.0, 0.0, 1.0, 1.0, 1.0],
                   "e": [0.0, 1.0, 1.0, 1.0, 1.0]}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_inverse_steps_match_jax_update_rule(case, monkeypatch):
    kw = dict(CASES[case])
    vpl = kw.pop("vpl")
    scene, cam, cfg, li, img = _setup(vpl)
    loss = kw["loss"] or ("l2_unbiased" if kw["resample"] else "l2")
    want = _jax_replay(scene, cam, cfg, li, img, lr=kw["lr"],
                       optimize=kw["optimize"], resample=kw["resample"],
                       loss=loss, grad_mask=kw.get("grad_mask"))
    # The fitter's threefry keys swapped for mix32 keys of the same seed.
    mix32_key = trng.make_key
    monkeypatch.setattr(TG.rng, "make_key",
                        lambda seed, impl=None: mix32_key(seed))
    inv = TG.InverseRenderer(
        scene=to_torch_scene(scene), cam=to_torch_camera(cam),
        target=torch.tensor(np.asarray(img)), cfg=to_torch_config(cfg),
        width=W, height=H, spp=1, **kw)
    assert inv.loss == loss and inv.backend == "xla"
    assert inv.light_idx == li
    start = {k: getattr(inv.scene, k).clone() for k in kw["optimize"]}
    for step in range(STEPS):
        assert np.isfinite(inv.step())
        for k, v in want[step].items():
            np.testing.assert_allclose(
                getattr(inv.scene, k).numpy(), v, rtol=PARAM_RTOL,
                atol=STEP_RTOL * kw["lr"] * (step + 1),
                err_msg=f"{case} step {step} {k}")
    for k in kw["optimize"]:
        assert not torch.equal(getattr(inv.scene, k), start[k]), k
    mask = kw.get("grad_mask") or {}
    for k, m in mask.items():
        frozen = torch.tensor(m) == 0.0
        assert torch.equal(getattr(inv.scene, k)[frozen], start[k][frozen])


def test_adam_matches_optax():
    g = np.random.default_rng(11)
    params = {"a": g.normal(size=(5, 3)).astype(np.float32),
              "b": g.normal(size=(5,)).astype(np.float32)}
    tx = optax.adam(0.05)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    adam = TG._Adam(0.05, tp)
    for _ in range(6):
        grads = {k: g.normal(size=v.shape).astype(np.float32)
                 for k, v in params.items()}
        updates, state = tx.update({k: jnp.asarray(v)
                                    for k, v in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        tp = adam.step({k: torch.tensor(v) for k, v in grads.items()}, tp)
        # Moments equal bit for bit; the update's last bit may differ
        # (XLA's and torch's division and sqrt kernels), a few ulp of p.
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-6)


def _scripted(losses, grads_of):
    """A stand-in for ``module.render_loss_grad`` returning the scripted
    losses in turn, with unit albedo gradients."""
    it = iter(losses)

    def fake(scene, *args, **kw):
        return next(it), grads_of(scene)
    return fake


def test_patience_and_best_scene_match_jax(monkeypatch):
    """The plateau detector and the best-loss scene, against the JAX class
    fed the same loss sequence (a stand-in for the renderer)."""
    scene, cam, cfg, li, img = _setup(False)
    losses = [1.0, 0.5, 0.4999, 0.6, 0.3, 0.3, 0.2999, 0.31]
    monkeypatch.setattr(JG, "render_loss_grad", _scripted(
        [jnp.float32(x) for x in losses],
        lambda sc: sc.replace(c=jnp.ones_like(sc.c))))
    monkeypatch.setattr(TG, "render_loss_grad", _scripted(
        [torch.tensor(x) for x in losses],
        lambda sc: sc.replace(c=torch.ones_like(sc.c))))
    kw = dict(width=W, height=H, spp=1, optimize=("c",), resample=False,
              patience=2, min_improve=1e-3)
    jinv = JG.InverseRenderer(scene=scene, cam=cam, target=img, cfg=cfg, **kw)
    tinv = TG.InverseRenderer(
        scene=to_torch_scene(scene), cam=to_torch_camera(cam),
        target=torch.tensor(np.asarray(img)), cfg=to_torch_config(cfg), **kw)
    stops = []
    for _ in losses:
        assert tinv.step() == pytest.approx(jinv.step(), rel=1e-7)
        assert tinv._stall == jinv._stall
        assert tinv.should_stop == jinv.should_stop
        assert tinv.best_loss == pytest.approx(jinv.best_loss, rel=1e-7)
        np.testing.assert_allclose(tinv.best_scene.c.numpy(),
                                   np.asarray(jinv.best_scene.c),
                                   rtol=1e-5, atol=1e-6)
        stops.append(tinv.should_stop)
    assert any(stops) and not all(stops)


def test_projections_match_jax(monkeypatch):
    """Adam and the projections (radius at or above ``min_radius``, albedo
    in [0, 1], emission at or above 0) against the JAX class, both fed the
    same scripted gradients, large enough that every bound is hit."""
    scene, cam, cfg, li, img = _setup(False)
    g = np.random.default_rng(5)
    grads = [{k: g.normal(size=np.shape(getattr(scene, k))).astype(
        np.float32) for k in ("p", "rad", "c", "e")} for _ in range(3)]

    def scripted(to):
        it = iter(grads)

        def fake(sc, *args, **kw):
            gr = next(it)
            return to(1.0), sc.replace(**{k: to(v) for k, v in gr.items()})
        return fake

    monkeypatch.setattr(JG, "render_loss_grad", scripted(jnp.asarray))
    monkeypatch.setattr(TG, "render_loss_grad", scripted(torch.tensor))
    kw = dict(width=W, height=H, spp=1, lr=2.0, resample=False,
              optimize=("p", "rad", "c", "e"), min_radius=12.0)
    jinv = JG.InverseRenderer(scene=scene, cam=cam, target=img, cfg=cfg, **kw)
    tinv = TG.InverseRenderer(
        scene=to_torch_scene(scene), cam=to_torch_camera(cam),
        target=torch.tensor(np.asarray(img)), cfg=to_torch_config(cfg), **kw)
    # The file's bound: Adam's update may differ in its last bits (see
    # test_adam_matches_optax), up to STEP_RTOL of its reach per step.
    for step in range(len(grads)):
        jinv.step()
        tinv.step()
        for k in kw["optimize"]:
            np.testing.assert_allclose(
                getattr(tinv.scene, k).numpy(),
                np.asarray(getattr(jinv.scene, k)), rtol=PARAM_RTOL,
                atol=STEP_RTOL * kw["lr"] * (step + 1), err_msg=k)
    rad, c, e = (getattr(tinv.scene, k).numpy() for k in ("rad", "c", "e"))
    assert (rad == 12.0).any() and (rad >= 12.0).all()
    assert (c == 0.0).any() and (c == 1.0).any()
    assert (e == 0.0).any() and (e >= 0.0).all()


def test_carriers_run_through_every_backend_on_cpu():
    """The gradient carriers of vis_grad_tau and sil_grad_tau run on the
    CPU through every backend, the matmul scans ('mxu') included: finite
    losses and gradients, the image of `render_radiance` unchanged, and a
    fitter step. The fused step still refuses the product loss."""
    scene, cam, cfg, li, img = _setup(False)
    tscene, tcam = to_torch_scene(scene), to_torch_camera(cam)
    target = torch.tensor(np.asarray(img))
    key = key_words(jrng.make_key(0))
    plain_cfg = to_torch_config(cfg)
    image = TG.render_radiance(tscene, tcam, key, plain_cfg, W, H, li, 1)
    for field in ("vis_grad_tau", "sil_grad_tau"):
        tcfg = dataclasses.replace(plain_cfg, **{field: 0.5})
        for backend in ("auto", "pallas", "xla", "mxu"):
            loss, grads = TG.render_loss_grad(tscene, tcam, key, target,
                                              tcfg, W, H, li, 1, "l2",
                                              backend)
            assert np.isfinite(float(loss)), (field, backend)
            assert all(torch.isfinite(getattr(grads, k)).all()
                       for k in ("p", "rad", "e", "c")), (field, backend)
        assert torch.equal(
            TG.render_radiance(tscene, tcam, key, tcfg, W, H, li, 1), image)
        inv = TG.InverseRenderer(scene=tscene, cam=tcam, target=target,
                                 cfg=tcfg, width=W, height=H, spp=1)
        assert np.isfinite(inv.step())
    with pytest.raises(ValueError):
        tpg.trace_pallas_loss_grad(tscene, plain_cfg, li, None,
                                   key, 0, target, loss="l2_unbiased")


@pytest.mark.parametrize("tau_anneal,anneal_steps,anneal_stages", [
    (0.25, 8, 4), (0.5, 5, 3), (0.1, 3, 1), (1.0, 8, 4), (0.25, 0, 4)])
def test_step_cfg_stages_match_jax(tau_anneal, anneal_steps, anneal_stages):
    """The staged tau annealing of `_step_cfg` against the JAX class's,
    over steps 0 to ``anneal_steps + 2`` (the last two past the end)."""
    scene, cam, cfg, li, img = _setup(False)
    cfg = dataclasses.replace(cfg, vis_grad_tau=2.0, sil_grad_tau=1.5)
    kw = dict(tau_anneal=tau_anneal, anneal_steps=anneal_steps,
              anneal_stages=anneal_stages, width=W, height=H)
    jinv = JG.InverseRenderer(scene=scene, cam=cam, target=img, cfg=cfg,
                              **kw)
    tinv = TG.InverseRenderer(
        scene=to_torch_scene(scene), cam=to_torch_camera(cam),
        target=torch.tensor(np.asarray(img)), cfg=to_torch_config(cfg),
        **kw)
    for step in range(anneal_steps + 3):
        jinv._step = tinv._step = step
        want, got = jinv._step_cfg(), tinv._step_cfg()
        assert (got.vis_grad_tau, got.sil_grad_tau) == (
            want.vis_grad_tau, want.sil_grad_tau), step
        assert got == to_torch_config(want)


def test_inverse_steps_with_carriers_match_jax_fitter(monkeypatch):
    """Two steps of the port's fitter with both carriers on and annealed
    (the taus halve at the second step) beside the JAX class, seed 0,
    under the tolerances of `test_inverse_steps_match_jax_fitter`, whose
    eager JAX it shares."""
    kw = dict(lr=0.5, optimize=("p", "rad"), resample=True,
              tau_anneal=0.5, anneal_steps=1, anneal_stages=2)
    jitted = JG.render_loss_grad

    def eager(*args):
        with jax.disable_jit():
            return jitted.__wrapped__(*args)

    monkeypatch.setattr(JG, "render_loss_grad", eager)
    scene, cam, cfg, li, img = _setup(False)
    cfg = dataclasses.replace(cfg, vis_grad_tau=2.0, sil_grad_tau=1.0)
    jinv = JG.InverseRenderer(scene=scene, cam=cam, target=img, cfg=cfg,
                              width=W, height=H, spp=1, **kw)
    tinv = TG.InverseRenderer(
        scene=to_torch_scene(scene), cam=to_torch_camera(cam),
        target=torch.tensor(np.asarray(img)), cfg=to_torch_config(cfg),
        width=W, height=H, spp=1, **kw)
    assert (tinv.loss, tinv.backend) == (jinv.loss, jinv.backend)
    for step in range(2):
        assert tinv._step_cfg() == to_torch_config(jinv._step_cfg())
        want = jinv.step()
        got = tinv.step()
        assert got == pytest.approx(want, rel=1e-5)
        for k in kw["optimize"]:
            np.testing.assert_allclose(
                getattr(tinv.scene, k).numpy(),
                np.asarray(getattr(jinv.scene, k)), rtol=PARAM_RTOL,
                atol=STEP_RTOL * kw["lr"] * (step + 1),
                err_msg=f"step {step} {k}")


def test_fitter_keys_are_mix32_make_key_and_fold_in():
    """The port's fitter draws ``make_key(seed)``, folded with the step
    when resampling: JAX's mix32 keys, word for word."""
    for seed, step in ((0, 0), (0, 5), (7, 3)):
        want = key_words(jax.random.fold_in(jrng.make_key(seed), step))
        assert trng.fold_in(trng.make_key(seed), step) == want


def test_default_config_routes_on_cpu():
    """``backend="auto"`` on CPU tensors is the plain torch path: the
    default fitter (l2_unbiased, resampled) takes a finite step."""
    scene, cam, cfg, li, img = _setup(False)
    inv = TG.InverseRenderer(
        scene=to_torch_scene(scene), cam=to_torch_camera(cam),
        target=torch.tensor(np.asarray(img)), cfg=IntegratorConfig(
            max_depth=2, use_vpl=False, combine_half=False),
        width=W, height=H, spp=1)
    assert (inv.loss, inv.backend, inv.optimize) == (
        "l2_unbiased", "xla", ("p", "rad"))
    assert np.isfinite(inv.step())
    assert inv._step == 1


@pytest.mark.parametrize("case", ["albedo_fixed_l2",
                                  "geometry_resampled_unbiased"])
def test_inverse_steps_match_jax_fitter(case, monkeypatch):
    """The port's fitter with its defaults against the JAX
    `InverseRenderer` itself, seed 0, two steps: both draw threefry keys,
    so they take the same steps. JAX's `render_loss_grad` runs op by op
    (its jitted form costs minutes of compiles here)."""
    kw = dict(CASES[case])
    vpl = kw.pop("vpl")
    scene, cam, cfg, li, img = _setup(vpl)
    jitted = JG.render_loss_grad

    def eager(*args):
        with jax.disable_jit():
            return jitted.__wrapped__(*args)

    monkeypatch.setattr(JG, "render_loss_grad", eager)
    jinv = JG.InverseRenderer(scene=scene, cam=cam, target=img, cfg=cfg,
                              width=W, height=H, spp=1, **kw)
    tinv = TG.InverseRenderer(
        scene=to_torch_scene(scene), cam=to_torch_camera(cam),
        target=torch.tensor(np.asarray(img)), cfg=to_torch_config(cfg),
        width=W, height=H, spp=1, **kw)
    assert (tinv.loss, tinv.backend) == (jinv.loss, jinv.backend)
    for step in range(2):
        want = jinv.step()
        got = tinv.step()
        assert got == pytest.approx(want, rel=1e-5)
        for k in kw["optimize"]:
            np.testing.assert_allclose(
                getattr(tinv.scene, k).numpy(),
                np.asarray(getattr(jinv.scene, k)), rtol=PARAM_RTOL,
                atol=STEP_RTOL * kw["lr"] * (step + 1),
                err_msg=f"{case} step {step} {k}")


def test_fitter_keys_are_jax_threefry_keys():
    """The fitter's default keys are ``jax.random.key(seed)``, folded
    with the step when resampling, word for word."""
    for seed, step in ((0, 0), (0, 5), (7, 3)):
        want = key_words(jax.random.fold_in(jax.random.key(seed), step))
        got = trng.fold_in(trng.make_key(seed, "threefry"), step)
        assert got == want and trng.key_impl(got) == "threefry"


def test_fitter_auto_backend_is_jax_rule():
    """``"auto"``: the kernels on the card up to 64 spheres, the plain
    tracer above that and on the CPU (JAX's `InverseRenderer`)."""
    rule = TG.fitter_backend
    assert rule("cuda", 9) == "pallas"
    assert rule("cuda", 64) == "pallas"
    assert rule("cuda", 65) == "xla"
    assert rule("cuda", 783) == "xla"
    assert rule("cpu", 9) == "xla"
    assert rule("cuda", 783, "pallas") == "pallas"
    assert rule("cpu", 9, "pallas") == "pallas"
    assert rule("cuda", 9, "mxu") == "mxu"
    with pytest.raises(ValueError):
        rule("cuda", 9, "bvh")


def test_radiance_route_takes_any_sphere_count_on_the_plain_backend():
    """`render_radiance_lanes`' tracer: "xla" is the plain tracer at any
    sphere count on any device (it no longer raises above 64 spheres on
    the card); the kernels take the adjoint up to 64 spheres and the fact
    kernel with the re-walk above."""
    route = TG.radiance_route
    for dev in ("cuda", "cpu"):
        for s in (9, 64, 65, 783, 5000):
            assert route(dev, s, "xla") == "plain"
    assert route("cuda", 783, "auto") == "bounce"
    assert route("cuda", 65, "pallas") == "bounce"
    assert route("cuda", 64, "auto") == "adjoint"
    assert route("cpu", 783, "auto") == "plain"
    assert route("cpu", 783, "pallas") == "bounce"
