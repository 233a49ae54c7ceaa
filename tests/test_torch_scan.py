"""The port's per-bounce scan route against the JAX package on the CPU.

`ops.pallas_scan.nearest_tiles` and `anyhit_tiles` (on CPU tensors they
run `nearest_plain` and `anyhit_plain`, the plain versions of the CUDA
scan kernels) against JAX's Pallas kernels in interpret mode, on Cornell
and on the 96-sphere synthetic scene of tests/test_pallas_scan.py; and
`path_tracer.trace(scan_backend="pallas")` against JAX's, under the
radiance protocol of tests/test_pallas.py at 16x12, with the bounds of
tests/test_pallas_scan.py. The VPL case uses a VPL floating in the box, as
tests/test_pallas.py does (VPLs on the walls sit on a shadow-ray knife
edge where JAX's own paths disagree). Then the port's own invariants:
compaction and lane windows change no bit, and the route is forward only.

The plain versions take the kernels' skip unit, a warp of 32 lanes, and
JAX's 1024-lane tile with ``tile=1024``; with JAX's tile they equal JAX's
kernels on every lane (hit, id, attributes, refl and occlusion exactly).
``t`` differs in its last bits: JAX's interpret mode rounds the quadratic
otherwise, and the cancellation in ``b * b - |op|^2 + r^2`` leaves a few
ulps of the scene's coordinate scale, more near grazing (measured up to
2.4e-3 on Cornell, whose walls are spheres of radius 1e4, and 5.7e-4, or
8.7e-6 relative, on the 96-sphere scene with its ground sphere of radius
1000), so ``t`` is held to 4 ulps of that scale plus 2e-5 of ``t``.
JAX's interpret-mode compiles at 96 spheres cost about 10 s per kernel:
each JAX result is computed once per module.
"""

import dataclasses

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
from gpu_bidirectional_raytracer_tpu.integrators import path_tracer as jpt
from gpu_bidirectional_raytracer_tpu.integrators.direct import (
    static_light_indices as jlights,
)
from gpu_bidirectional_raytracer_tpu.ops import pallas_scan as jscan
from gpu_bidirectional_raytracer_tpu.scene import builtin as jbuiltin
from gpu_bidirectional_raytracer_tpu_torch import rng as trng
from gpu_bidirectional_raytracer_tpu_torch.core.types import (
    IntegratorConfig,
    Rays,
)
from gpu_bidirectional_raytracer_tpu_torch.integrators import path_tracer as tpt
from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_scan as tscan
from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace as tops
from torch_parity import (
    assert_protocol,
    floating_vpl,
    key_words,
    to_torch_config,
    to_torch_scene,
    to_torch_vpls,
    torch_rays,
)

torch.set_num_threads(2)

W, H = 16, 12
N_LANES = 2 * 1024 + 100     # two JAX tiles and a ragged third


def many_sphere_scene(s=96, seed=3):
    """tests/test_pallas_scan.py::_many_sphere_scene: a random diffuse
    cloud, a ground sphere of radius 1000 and one emitter."""
    r = np.random.RandomState(seed)
    rad = np.concatenate([[1000.0], 2.0 + 3.0 * r.rand(s - 2), [8.0]])
    p = np.concatenate([
        [[0.0, -1000.0, 0.0]],
        np.stack([80 * r.rand(s - 2) - 40, 40 * r.rand(s - 2),
                  80 * r.rand(s - 2) - 40], axis=1),
        [[0.0, 60.0, 0.0]]])
    e = np.zeros((s, 3))
    e[-1] = (12.0, 12.0, 12.0)
    c = 0.2 + 0.6 * r.rand(s, 3)
    c[-1] = 0.0
    return JScene(rad=jnp.asarray(rad, jnp.float32),
                  p=jnp.asarray(p, jnp.float32),
                  e=jnp.asarray(e, jnp.float32),
                  c=jnp.asarray(c, jnp.float32),
                  refl=jnp.zeros((s,), jnp.int32))


# Each scene with the box its random rays start in.
SCENES = {"cornell": (jbuiltin.cornell_box, ([5, 5, 5], [95, 75, 165])),
          "many96": (many_sphere_scene, ([-40, 0, -40], [40, 40, 40]))}


def _segments(name):
    """Random rays of ``N_LANES`` lanes in the scene's box, shadow lengths,
    and a mask with the first JAX tile all dead and 30% of the rest
    live."""
    lo, hi = SCENES[name][1]
    r = np.random.default_rng(11)
    o = r.uniform(lo, hi, (N_LANES, 3)).astype(np.float32)
    d = r.normal(size=(N_LANES, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    maxt = r.uniform(1.0, 100.0, N_LANES).astype(np.float32)
    live = r.random(N_LANES) < 0.3
    live[:1024] = False
    return o, d, maxt, live


@pytest.fixture(scope="module", params=sorted(SCENES))
def scan_case(request):
    """JAX's three kernels on one scene's segments, run once."""
    name = request.param
    scene = SCENES[name][0]()
    o, d, maxt, live = _segments(name)
    args = [jnp.asarray(x) for x in (o, d)]
    near = jscan.nearest_tiles(scene, *args, jnp.asarray(live),
                               interpret=True)
    occ = {vac: np.asarray(jscan.anyhit_tiles(
        scene, *args, jnp.asarray(maxt), jnp.asarray(live), vacuum=vac,
        interpret=True)) for vac in (False, True)}
    scale = float(np.abs(np.asarray(scene.p)).max()
                  + np.asarray(scene.rad).max())
    return (to_torch_scene(scene), [torch.tensor(x) for x in (o, d, maxt,
                                                               live)],
            [np.asarray(x) for x in near], occ, scale)


@pytest.mark.parametrize("tile", [1024, tscan.TILE])
def test_nearest_matches_jax_kernel(scan_case, tile):
    scene, (o, d, _, live), want, _, scale = scan_case
    if tile == tscan.TILE:
        before = dict(tops.LAUNCHES)
        got = tscan.nearest_tiles(scene, o, d, live)
        assert tops.LAUNCHES == before      # CPU: the plain version
    else:
        got = tscan.nearest_plain(scene, o, d, live, tile=tile)
    got = [x.numpy() for x in got]
    # JAX's tile: every lane; the warp: the live lanes (the rest of a
    # dead warp reports a miss).
    lanes = np.ones(N_LANES, bool) if tile == 1024 else live.numpy()
    hit, t, hit_id, p, e, c, refl = got
    assert hit_id.dtype == refl.dtype == np.int32
    for k, (g, w) in enumerate(zip(got, want)):
        if k == 1:
            np.testing.assert_allclose(
                g[lanes], w[lanes], rtol=2e-5,
                atol=4 * float(np.spacing(np.float32(scale))))
        else:
            np.testing.assert_array_equal(g[lanes], w[lanes], err_msg=str(k))
    assert hit[live].mean() > 0.3
    # Lanes of a dead tile report a miss: t 1e20, id 0, no attributes.
    dead = ~tscan.tile_live(live, tile).numpy()
    assert dead[:1024].all() and not hit[dead].any()
    assert (t[dead] == 1e20).all() and not hit_id[dead].any()
    assert not (p[dead].any() or e[dead].any() or c[dead].any())


@pytest.mark.parametrize("tile", [1024, tscan.TILE])
@pytest.mark.parametrize("vacuum", [False, True], ids=["shadow", "vacuum"])
def test_anyhit_matches_jax_kernel(scan_case, vacuum, tile):
    scene, (o, d, maxt, live), _, occ, _ = scan_case
    if tile == tscan.TILE:
        got = tscan.anyhit_tiles(scene, o, d, maxt, live, vacuum=vacuum)
    else:
        got = tscan.anyhit_plain(scene, o, d, maxt, live, vacuum, tile=tile)
    got = got.numpy()
    lanes = np.ones(N_LANES, bool) if tile == 1024 else live.numpy()
    np.testing.assert_array_equal(got[lanes], occ[vacuum][lanes])
    assert 0.1 < got[lanes].mean() < 0.9
    assert not got[:1024].any()
    if vacuum:       # emitters block shadow rays, not vacuum rays
        shadow = tscan.anyhit_plain(scene, o, d, maxt, live,
                                    tile=tile).numpy()
        assert (got <= shadow).all()
        assert tile != 1024 or (got < shadow).any()


def rig(scene, seed=0, w=W, h=H):
    cam = JCamera.make(jbuiltin.DEFAULT_CAMERA_ORIG,
                       jbuiltin.DEFAULT_CAMERA_TARGET, w, h)
    key = jrng.make_key(seed)
    u = jrng.site_uniforms(key, 0, 0, jrng.CAM_JITTER, 2, w * h)
    px, py = jcam.pixel_grid(w, h)
    return jlights(scene), key, jcam.primary_rays(cam, w, h, u[0], u[1],
                                                  px, py)


# Scene, config, VPLs, the bad-pixel bound of tests/test_pallas_scan.py
# (the VPL case floats its VPL clear of the walls, so it takes the 3.5%
# protocol rather than that file's 12% for on-surface VPLs) and the
# relative energy bound (None where that file sets none).
TRACES = {
    "cornell_no_vpl": (jbuiltin.cornell_box, JConfig(use_vpl=False), False,
                       0.02, 1e-3),
    "cornell_floating_vpl": (jbuiltin.cornell_box, JConfig(), True, 0.035,
                             2e-3),
    "many96_depth3": (many_sphere_scene, dataclasses.replace(
        JConfig(use_vpl=False), max_depth=3), False, 0.04, None),
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_scan_trace_matches_jax(name):
    make, cfg, with_vpl, max_bad, energy = TRACES[name]
    scene = make()
    li, key, rays = rig(scene)
    vpls = floating_vpl(cfg) if with_vpl else None
    ref = np.asarray(jpt.trace(scene, cfg, li, rays, key, jnp.int32(0),
                               vpls=vpls, vlp_index=jnp.int32(0),
                               scan_backend="pallas"))
    ts, tcfg, tr = to_torch_scene(scene), to_torch_config(cfg), torch_rays(
        rays)
    kw = dict(vpls=None if vpls is None else to_torch_vpls(vpls),
              vlp_index=0)
    before = dict(tops.LAUNCHES)
    got = tpt.trace(ts, tcfg, li, tr, key_words(key), 0,
                    scan_backend="pallas", **kw)
    assert tops.LAUNCHES == before
    assert_protocol(got.numpy(), ref, max_bad_frac=max_bad)
    assert ref.max() > 0.01
    if energy is not None:
        assert abs(float(got.mean()) - ref.mean()) < energy * ref.mean()
    # On the CPU the scan route is the all-pairs tracer, bit for bit.
    assert torch.equal(got, tpt.trace(ts, tcfg, li, tr, key_words(key), 0,
                                      **kw))


@pytest.mark.parametrize("impl", ["mix32", "threefry"])
def test_compaction_and_lane_windows_are_bitwise_invariant(impl):
    """tests/test_pallas_scan.py:104-150 for the port: ``scan_compact``
    permutes the lanes every depth and changes no bit; a band traced with
    its lane window equals its slice of the whole frame, compacted or
    not."""
    scene = many_sphere_scene()
    li, _, rays = rig(scene, seed=2)
    ts, tr = to_torch_scene(scene), torch_rays(rays)
    key = trng.make_key(2, impl)
    cfg = IntegratorConfig()
    vpls = to_torch_vpls(floating_vpl(JConfig()))
    kw = dict(vpls=vpls, vlp_index=0, scan_backend="pallas")
    full = tpt.trace(ts, cfg, li, tr, key, 1, **kw)
    assert full.max() > 0.0
    assert torch.equal(full, tpt.trace(ts, cfg, li, tr, key, 1,
                                       scan_compact=True, **kw))
    lo, hi = 3 * W + 5, 9 * W
    band = Rays(o=tr.o[lo:hi], d=tr.d[lo:hi])
    for compact in (False, True):
        got = tpt.trace(ts, cfg, li, band, key, 1, lane_offset=lo,
                        lane_total=W * H, scan_compact=compact, **kw)
        assert torch.equal(got, full[lo:hi])


def test_partition_moves_live_lanes_to_the_front_in_order():
    alive = torch.tensor([False, True, False, True, True, False])
    z = torch.zeros((6, 3))
    state = tpt.PathState(o=torch.arange(18.0).reshape(6, 3), d=z, rad=z,
                          throughput=z, specular=alive, alive=alive)
    moved, pix = tpt._partition_live(state, torch.arange(6) + 10)
    assert pix.tolist() == [11, 13, 14, 10, 12, 15]
    assert moved.alive.tolist() == [True] * 3 + [False] * 3
    assert torch.equal(moved.o, state.o[pix - 10])


def test_scan_route_is_forward_only_and_refuses_what_jax_cannot_run():
    scene = to_torch_scene(jbuiltin.cornell_box())
    li, key, rays = rig(jbuiltin.cornell_box())
    cfg, tr, k = IntegratorConfig(use_vpl=False), torch_rays(rays), \
        key_words(key)
    p = scene.p.clone().requires_grad_()
    with torch.enable_grad(), pytest.raises(RuntimeError,
                                            match="forward only"):
        tpt.trace(scene.replace(p=p), cfg, li, tr, k, 0,
                  scan_backend="pallas")
    o = tr.o.clone().requires_grad_()
    with torch.enable_grad(), pytest.raises(RuntimeError,
                                            match="forward only"):
        tscan.anyhit_tiles(scene, o, tr.d, torch.ones(W * H),
                           torch.ones(W * H, dtype=torch.bool))
    with torch.no_grad():       # no autograd: the inputs may require grad
        tpt.trace(scene.replace(p=p), cfg, li, tr, k, 0,
                  scan_backend="pallas")
    _, aux = tpt.trace(scene, cfg, li, tr, k, 0, collect_aux=True)
    with pytest.raises(ValueError, match="collect_aux"):
        tpt.trace(scene, cfg, li, tr, k, 0, scan_backend="pallas",
                  collect_aux=True)
    with pytest.raises(ValueError, match="scan_compact"):
        tpt.trace(scene, cfg, li, tr, k, 0, scan_backend="pallas",
                  scan_compact=True, aux=aux)
    with pytest.raises(ValueError, match="scan_backend"):
        tpt.trace(scene, cfg, li, tr, k, 0, scan_backend="bvh")
    # With facts the scans are skipped whatever the backend (JAX's aux
    # branch), so the pallas route re-walks as the plain one does.
    assert torch.equal(
        tpt.trace(scene, cfg, li, tr, k, 0, scan_backend="pallas", aux=aux),
        tpt.trace(scene, cfg, li, tr, k, 0, aux=aux))
