"""The port's light splatting against the JAX package: `splat_to_film` on
the same VPLs (JAX's, carried across), `light_splat_pass` over passes on
the same mix32 key, and the port's own guarantees (a chunk of light
passes gives the bits of as many single passes; the scatter is a fixed
order sum).

Tolerances: ``count`` equal; ``color_sum`` per pixel within
``1e-5 |ref| + 1e-6 max|ref|`` (the port sums a pixel's splats in a
fixed tree order, JAX in lane order: float32 rounding apart). Passes
under the radiance protocol of tests/test_pallas.py (2e-3 + 2e-3 |ref|,
at most 3.5% of pixels), because the port's light pass differs from
JAX's on a few wall hits (tests/test_torch_light_tracer.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_bidirectional_raytracer_tpu.core.types import Camera as JCamera
from gpu_bidirectional_raytracer_tpu.core.types import IntegratorConfig as JConfig
from gpu_bidirectional_raytracer_tpu.core.types import VplBuffer as JVpls
from gpu_bidirectional_raytracer_tpu.integrators import light_tracer as jlt
from gpu_bidirectional_raytracer_tpu.integrators.direct import (
    static_light_indices,
)
from gpu_bidirectional_raytracer_tpu.render import progressive as jprog
from gpu_bidirectional_raytracer_tpu.scene import parser as jparser
from gpu_bidirectional_raytracer_tpu_torch.integrators import light_tracer as tlt
from gpu_bidirectional_raytracer_tpu_torch.render import progressive as tprog
from gpu_bidirectional_raytracer_tpu_torch.scene import parser as tparser
from torch_parity import (
    assert_protocol,
    key_words,
    scn,
    to_torch_camera,
    to_torch_config,
    to_torch_scene,
    to_torch_vpls,
)

torch.set_num_threads(2)

W, H = 16, 12


@pytest.fixture(scope="module")
def cornell():
    o, t, js = jparser.load_scene(scn("cornell.scn"))
    cam = JCamera.make(o, t, W, H)
    return o, t, js, cam, static_light_indices(js)


def _assert_splat_close(got, ref):
    (tc, tn), (jc, jn) = got, ref
    assert tc.dtype == torch.float32 and tn.dtype == torch.int32
    assert np.array_equal(tn.numpy(), np.asarray(jn))
    jc = np.asarray(jc)
    err = np.abs(tc.numpy() - jc)
    tol = 1e-5 * np.abs(jc) + 1e-6 * np.abs(jc).max()
    assert (err <= tol).all(), f"max err {err.max():.3g}"


def _both(scene, cam, cfg, vpls, light_idx, **kw):
    ref = jlt.splat_to_film(scene, cam, cfg, vpls, W, H, light_idx, **kw)
    got = tlt.splat_to_film(to_torch_scene(scene), to_torch_camera(cam),
                            to_torch_config(cfg), to_torch_vpls(vpls), W, H,
                            light_idx, **kw)
    return got, ref


@pytest.mark.parametrize("seed", [0, 3])
def test_splat_matches_jax_on_the_same_vpls(cornell, seed):
    _, _, js, cam, li = cornell
    cfg = JConfig()
    vpls = jlt.trace_light_paths(js, cfg, li, jax.random.key(seed),
                                 jnp.int32(0))
    got, ref = _both(js, cam, cfg, vpls, li)
    _assert_splat_close(got, ref)
    assert int(got[1].sum()) > 1000


def test_splat_lane_offset_picks_the_global_lights_radius(cornell):
    """Two lights (the emitter and the mirror ball, radii 5 and 16.5) so
    the round-robin by global lane id decides each splat's weight."""
    _, _, js, cam, li = cornell
    cfg = JConfig()
    vpls = jlt.trace_light_paths(js, cfg, li, jax.random.key(1),
                                 jnp.int32(0))
    two = (li[0], 6)
    for off in (None, 3):
        got, ref = _both(js, cam, cfg, vpls, two, lane_offset=off)
        _assert_splat_close(got, ref)
    shifted = _both(js, cam, cfg, vpls, two, lane_offset=3)[0][0]
    plain = _both(js, cam, cfg, vpls, two)[0][0]
    assert not torch.equal(shifted, plain)


def test_env_vpls_splat_only_from_depth_zero():
    """Depth-2 light paths on simple.scn (open, so lanes escape): env
    deposits (host sphere an emitter) at depth 1 are gather-only; against
    JAX, and against the same buffer with those deposits invalidated."""
    o, t, js = jparser.load_scene(scn("simple.scn"))
    cam = JCamera.make(o, t, W, H)
    li = static_light_indices(js)
    cfg = JConfig(vpl_depth=2)
    vpls = jlt.trace_light_paths(js, cfg, li, jax.random.key(2),
                                 jnp.int32(0))
    emitter = np.asarray(jnp.any(js.e[vpls.sid] != 0.0, axis=-1))
    deep_env = emitter[1] & np.asarray(vpls.valid[1])
    assert deep_env.any(), "no env deposit at depth 1 to exclude"
    got, ref = _both(js, cam, cfg, vpls, li)
    _assert_splat_close(got, ref)
    cut = dataclasses.replace(vpls, valid=vpls.valid.at[1].set(
        np.asarray(vpls.valid[1]) & ~deep_env))
    got_cut, _ = _both(js, cam, cfg, cut, li)
    assert torch.equal(got[0], got_cut[0])
    assert torch.equal(got[1], got_cut[1])
    # Hosted on a non-emitter (sphere 0, the ground), the same deposits
    # would splat: the rule, not the projection, keeps them off the film.
    rehosted = dataclasses.replace(vpls, sid=vpls.sid.at[1].set(
        np.where(deep_env, 0, np.asarray(vpls.sid[1]))))
    got_re, ref_re = _both(js, cam, cfg, rehosted, li)
    _assert_splat_close(got_re, ref_re)
    assert int(got_re[1].sum()) > int(got[1].sum())


def _single_vpl(cfg, point):
    v = JVpls.zeros(cfg.vpl_depth, cfg.light_points)
    return JVpls(hp=v.hp.at[0, 0].set(jnp.asarray(point, jnp.float32)),
                 rad=v.rad.at[0, 0].set(1.0), nl=v.nl,
                 valid=v.valid.at[0, 0].set(True), sid=v.sid)


@pytest.mark.parametrize("where,splats", [
    ("visible", 1),     # the open floor mid-box
    ("occluded", 0),    # behind the mirror ball along the eye ray
    ("behind", 0),      # behind the camera
])
def test_visibility_and_projection(cornell, where, splats):
    """tests/test_splat.py's vertices: one visible, one behind the
    mirror sphere, one behind the camera."""
    _, _, js, cam, li = cornell
    cfg = JConfig()
    point = {"visible": [50.0, 0.5, 100.0], "occluded": [23.3, 12.1, 26.3],
             "behind": list(np.asarray(cam.orig)
                            - 50.0 * np.asarray(cam.dir))}[where]
    got, ref = _both(js, cam, cfg, _single_vpl(cfg, point), li)
    _assert_splat_close(got, ref)
    assert int(got[1].sum()) == splats


def test_light_splat_passes_match_jax(cornell):
    o, t, js, cam, li = cornell
    cfg = JConfig()
    jstate = jprog.init_state(W, H, cfg, seed=5)
    tstate = tprog.init_state(W, H, to_torch_config(cfg), 5, device="cpu")
    assert tstate.key == key_words(jstate.key)
    ts, tcam = to_torch_scene(js), to_torch_camera(cam)
    for _ in range(4):
        jstate = jprog.light_splat_pass(js, cam, jstate, cfg, W, H, li)
        tstate = tprog.light_splat_pass(ts, tcam, tstate,
                                        to_torch_config(cfg), W, H, li)
    assert (tstate.counter.numpy() == 4).all()
    assert np.array_equal(tstate.counter.numpy(), np.asarray(jstate.counter))
    assert tstate.sample == int(jstate.sample) == 4
    assert tstate.vlp_index == int(jstate.vlp_index) == 0
    assert_protocol(tstate.colors.numpy().reshape(-1, 3),
                    np.asarray(jstate.colors).reshape(-1, 3))
    assert float(tstate.colors.max()) > 0
    assert torch.equal(tstate.vpls.valid,
                       torch.as_tensor(np.array(jstate.vpls.valid)))


def test_step_light_chunk_is_single_passes_bit_for_bit(cornell):
    o, t, _, _, _ = cornell
    _, _, ts = tparser.load_scene(scn("cornell.scn"), device="cpu")
    a = tprog.Renderer(ts, o, t, W, H, seed=7, device="cpu")
    b = tprog.Renderer(ts, o, t, W, H, seed=7, device="cpu")
    a.step_light(3)
    for _ in range(3):
        b.step_light()
    for f in ("colors", "counter"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f))
    assert a.state.sample == b.state.sample == 3
    assert torch.equal(a.state.vpls.hp, b.state.vpls.hp)
    # A second run of the same passes: the same bits.
    c = tprog.Renderer(ts, o, t, W, H, seed=7, device="cpu")
    c.step_light(3)
    assert torch.equal(c.state.colors, a.state.colors)


def test_segment_sums_fixed_order():
    """The segment sum against a float64 reference; an empty bin is 0, and
    two calls give the same bits."""
    g = torch.Generator().manual_seed(0)
    keys = torch.randint(0, 9, (1000,), generator=g)
    vals = torch.rand((1000, 3), generator=g)
    got = tlt._segment_sums(keys, vals, 10)
    ref = torch.zeros((10, 3), dtype=torch.float64).index_add_(
        0, keys, vals.double())
    torch.testing.assert_close(got.double(), ref, rtol=1e-6, atol=1e-5)
    assert torch.equal(got[9], torch.zeros(3))
    assert torch.equal(tlt._segment_sums(keys, vals, 10), got)
