"""The port's plain integrators against the JAX package's scalar golden
model (`integrators/golden.py`, float64, one ray or lane at a time) on
the same random tape: `golden.make_tape` / `make_light_tape` draw it
through JAX's `rng.site_uniforms`, which the port's tape equals bit for
bit, so a difference is an algorithmic one.

Tolerances are tests/test_golden_parity.py's (per pixel 2e-3 + 2e-3 |ref|,
at most 1% of pixels off, 2% on Cornell; the mean error of the agreeing
pixels under 2e-3) and tests/test_light_tracer.py's for the light
subpaths (each slot's hp within 1e-2 + 1e-3 |ref|, rad and nl within
1e-3 + 1e-3 |ref|, at most 2% of slots off): float32 against float64
flips a few knife-edge decisions. The light subpaths are also held
against the port's own golden model (`integrators.golden` of the port) on
its own tape and key, without JAX."""

import jax
import numpy as np
import pytest
import torch

from gpu_bidirectional_raytracer_tpu.core.types import IntegratorConfig as JConfig
from gpu_bidirectional_raytracer_tpu.integrators import golden
from gpu_bidirectional_raytracer_tpu.integrators.direct import (
    static_light_indices,
)
from gpu_bidirectional_raytracer_tpu.scene import parser as jparser
from gpu_bidirectional_raytracer_tpu_torch import camera as cam_mod
from gpu_bidirectional_raytracer_tpu_torch import convert, rng
from gpu_bidirectional_raytracer_tpu_torch.core.types import (
    Camera,
    IntegratorConfig,
)
from gpu_bidirectional_raytracer_tpu_torch.integrators import (
    golden as tgolden,
)
from gpu_bidirectional_raytracer_tpu_torch.integrators import (
    direct as tdirect,
)
from gpu_bidirectional_raytracer_tpu_torch.integrators import (
    light_tracer,
    path_tracer,
)
from gpu_bidirectional_raytracer_tpu_torch.scene import parser as tparser
from torch_parity import (
    floating_vpl,
    scn,
    to_torch_config,
    to_torch_scene,
    to_torch_vpls,
)

torch.set_num_threads(2)


def _port_key(jkey):
    """The port's key of a JAX key (threefry ``key<fry>`` or mix32)."""
    impl = "threefry" if "fry" in str(jkey.dtype) else "mix32"
    return convert.key_from_numpy(jax.random.key_data(jkey), impl)


def _assert_mostly_close(ours, ref, atol=2e-3, rtol=2e-3, max_bad_frac=0.01):
    err = np.abs(np.asarray(ours, np.float64) - ref)
    bad = np.any(err > atol + rtol * np.abs(ref), axis=-1)
    assert bad.mean() <= max_bad_frac, (
        f"{bad.mean():.3%} of pixels disagree; max err {err.max():.4g}")
    assert np.mean(err[~bad]) < atol


def _path_parity(scene_file, cfg, w, h, jkey, vpls=None,
                 direct_only=False, **tol):
    orig, target, js = jparser.load_scene(scn(scene_file))
    li = static_light_indices(js)
    n = w * h
    tape = golden.make_tape(jkey, 0, n, len(li), cfg)
    ts, tcfg = to_torch_scene(js), to_torch_config(cfg)
    cam = Camera.make(orig, target, w, h, device="cpu")
    px, py = cam_mod.pixel_grid(w, h, device="cpu")
    key = _port_key(jkey)
    ju = rng.site_uniforms(key, 0, 0, rng.CAM_JITTER, 2, n, device="cpu")
    assert np.array_equal(ju.numpy(), tape["cam"])
    rays = cam_mod.primary_rays(cam, w, h, ju[0], ju[1], px, py)
    ours = path_tracer.trace(
        ts, tcfg, li, rays, key, 0,
        vpls=None if vpls is None else to_torch_vpls(vpls), vlp_index=0,
        direct_only=direct_only).numpy()
    scene_np = golden.scene_to_np(js)
    o, d = rays.o.double().numpy(), rays.d.double().numpy()
    vpls_np = None if vpls is None else golden.vpls_to_np(vpls)
    ref = np.stack([golden.radiance_path_tracing(
        scene_np, cfg, o[i], d[i], tape, i, vpls=vpls_np, vlp_index=0,
        direct_only=direct_only) for i in range(n)])
    _assert_mostly_close(ours, ref, **tol)
    assert ours.max() > 0.01
    return ours


@pytest.mark.parametrize("case", ["simple_cpu", "cornell_cpu",
                                  "cornell_direct", "cornell_mix32"])
def test_path_tracer_matches_golden(case):
    golden_cfg = JConfig.cpu_golden()
    if case == "simple_cpu":
        _path_parity("simple.scn", golden_cfg, 24, 18, jax.random.key(1))
    elif case == "cornell_cpu":
        _path_parity("cornell.scn", golden_cfg, 20, 16, jax.random.key(2),
                     max_bad_frac=0.02)
    elif case == "cornell_direct":
        _path_parity("cornell.scn", golden_cfg, 16, 12, jax.random.key(3),
                     direct_only=True, max_bad_frac=0.02)
    else:
        from gpu_bidirectional_raytracer_tpu import rng as jrng

        _path_parity("cornell.scn", golden_cfg, 16, 12, jrng.make_key(4),
                     max_bad_frac=0.02)


def test_path_tracer_with_a_floating_vpl_matches_golden():
    """The default config's VPL gather, on a VPL floating mid-box (no
    knife-edge occlusion), as tests/test_golden_parity.py does."""
    cfg = JConfig.gpu()
    _path_parity("cornell.scn", cfg, 16, 12, jax.random.key(5),
                 vpls=floating_vpl(cfg), max_bad_frac=0.02)


def _assert_light_slots(v, vpl_depth, lanes, slots_of):
    """The port's light subpaths ``v`` against a golden model's slots
    (``slots_of(lane)``) lane by lane, under tests/test_light_tracer.py's
    tolerances."""
    hp, rad, nl = v.hp.numpy(), v.rad.numpy(), v.nl.numpy()
    valid = v.valid.numpy()
    mismatch, deposits = 0, 0
    for lane in range(lanes):
        slots = slots_of(lane)
        for d in range(vpl_depth):
            if slots[d] is None or not valid[d, lane]:
                mismatch += int((slots[d] is None) != (not valid[d, lane]))
                continue
            deposits += 1
            ok = (np.allclose(hp[d, lane], slots[d]["hp"], rtol=1e-3,
                              atol=1e-2)
                  and np.allclose(rad[d, lane], slots[d]["rad"], rtol=1e-3,
                                  atol=1e-3)
                  and np.allclose(nl[d, lane], slots[d]["nl"], rtol=1e-3,
                                  atol=1e-3))
            mismatch += int(not ok)
    assert deposits > 0.5 * lanes
    frac = mismatch / (lanes * vpl_depth)
    assert frac <= 0.02, f"{frac:.3%} VPL slots disagree"


@pytest.mark.parametrize("vpl_depth", [1, 3])
def test_light_subpaths_match_golden_lane_by_lane(vpl_depth):
    _, _, js = jparser.load_scene(scn("cornell.scn"))
    cfg = JConfig(vpl_depth=vpl_depth, light_points=256)
    jkey = jax.random.key(5)
    li = static_light_indices(js)
    v = light_tracer.trace_light_paths(to_torch_scene(js),
                                       to_torch_config(cfg), li,
                                       _port_key(jkey), 0)
    scene_np = golden.scene_to_np(js)
    tape = golden.make_light_tape(jkey, 0, cfg, cfg.light_points)
    _assert_light_slots(v, vpl_depth, cfg.light_points,
                        lambda lane: golden.radiance_light_tracing(
                            scene_np, cfg, li, tape, lane))


@pytest.mark.parametrize("vpl_depth", [1, 3])
def test_light_subpaths_match_port_golden_lane_by_lane(vpl_depth):
    """The same against the port's own golden model, on its tape, scene,
    config and mix32 key: the port alone, no JAX object in the loop."""
    _, _, ts = tparser.load_scene(scn("cornell.scn"), device="cpu")
    cfg = IntegratorConfig(vpl_depth=vpl_depth, light_points=256)
    key = rng.make_key(7)
    li = tdirect.static_light_indices(ts)
    v = light_tracer.trace_light_paths(ts, cfg, li, key, 0)
    scene_np = tgolden.scene_to_np(ts)
    tape = tgolden.make_light_tape(key, 0, cfg, cfg.light_points)
    _assert_light_slots(v, vpl_depth, cfg.light_points,
                        lambda lane: tgolden.radiance_light_tracing(
                            scene_np, cfg, li, tape, lane))


@pytest.mark.parametrize("impl", ["threefry", "mix32"])
def test_port_golden_tapes_are_jax_bits(impl):
    """The port's `make_tape` and `make_light_tape` (drawn through the
    port's `rng.site_uniforms`) equal JAX's, bit for bit."""
    from gpu_bidirectional_raytracer_tpu import rng as jrng

    jkey = jax.random.key(1) if impl == "threefry" else jrng.make_key(6)
    cfg = JConfig(vpl_depth=2, light_points=64)
    key = _port_key(jkey)
    for sample in (0, 3):
        ours = tgolden.make_tape(key, sample, 40, 2, cfg)
        ref = golden.make_tape(jkey, sample, 40, 2, cfg)
        assert ours.keys() == ref.keys()
        for k in ref:
            assert ours[k].dtype == np.float32
            assert np.array_equal(ours[k], ref[k]), k
        ours = tgolden.make_light_tape(key, sample, cfg, 64)
        ref = golden.make_light_tape(jkey, sample, cfg, 64)
        assert ours.keys() == ref.keys()
        for k in ref:
            assert np.array_equal(ours[k], ref[k]), k


def test_port_golden_radiance_is_jax_golden():
    """The port's golden model against JAX's on the same tape, scene and
    rays (float64 both): eye paths (with and without VPLs, direct-only)
    and light subpaths to 1e-12 relative."""
    _, _, js = jparser.load_scene(scn("cornell.scn"))
    li = static_light_indices(js)
    jkey = jax.random.key(4)
    n = 48
    for cfg, vpls in ((JConfig.cpu_golden(), None),
                      (JConfig.gpu(), floating_vpl(JConfig.gpu()))):
        tape = golden.make_tape(jkey, 0, n, len(li), cfg)
        ts, tcfg = to_torch_scene(js), to_torch_config(cfg)
        scene_j, scene_t = golden.scene_to_np(js), tgolden.scene_to_np(ts)
        for f in scene_j:
            assert np.array_equal(scene_j[f], scene_t[f]), f
        vj = None if vpls is None else golden.vpls_to_np(vpls)
        vt = None if vpls is None else tgolden.vpls_to_np(to_torch_vpls(vpls))
        r = np.random.default_rng(5)
        o = np.array([50.0, 52.0, 295.6]) + r.uniform(-5, 5, (n, 3))
        d = r.normal(size=(n, 3)) * [0.3, 0.3, 1.0] - [0.0, 0.0, 1.0]
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        for direct_only in (False, True):
            for i in range(n):
                want = golden.radiance_path_tracing(
                    scene_j, cfg, o[i], d[i], tape, i, vpls=vj,
                    direct_only=direct_only)
                got = tgolden.radiance_path_tracing(
                    scene_t, tcfg, o[i], d[i], tape, i, vpls=vt,
                    direct_only=direct_only)
                np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    cfg = JConfig(vpl_depth=3, light_points=64)
    tape = golden.make_light_tape(jkey, 0, cfg, cfg.light_points)
    scene_j = golden.scene_to_np(js)
    deposits = 0
    for lane in range(cfg.light_points):
        want = golden.radiance_light_tracing(scene_j, cfg, li, tape, lane)
        got = tgolden.radiance_light_tracing(
            tgolden.scene_to_np(to_torch_scene(js)), to_torch_config(cfg),
            li, tape, lane)
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if b is not None:
                deposits += 1
                for f in b:
                    np.testing.assert_allclose(a[f], b[f], rtol=1e-12,
                                               atol=0)
    assert deposits > cfg.light_points // 2
