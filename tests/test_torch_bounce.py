"""The port's many-sphere forward route against the JAX package on the CPU.

`ops.pallas_bounce.trace_pallas_bounce` (on CPU tensors it loops
`bounce_plain`, the plain version of the CUDA bounce kernel) against JAX
`path_tracer.trace` on a scene of 89 spheres (the Cornell box and 80 small
spheres placed from a numpy seed, as tests/test_bounce_grad.py builds
one), and against JAX's own `trace_pallas_bounce` in interpret mode at
Cornell scale, with and without ``direct_only``; the banded program
(`tiled_pass`) against its untiled self, bit for bit, and against JAX's;
and the streamed tape that the CUDA kernels read for a threefry key.
Radiance is held to the protocol of tests/test_pallas.py (16x12 frames).

The VPL cases use a VPL floating in the box, as tests/test_pallas.py and
tests/test_torch_trace.py do: VPLs the light pass leaves on the
1e4-radius walls sit on a shadow-ray knife edge where JAX's own paths
disagree (ROADMAP). JAX runs compiled, as its own suites run it.
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
from gpu_bidirectional_raytracer_tpu.ops.pallas_bounce import (
    trace_pallas_bounce as jbounce,
)
from gpu_bidirectional_raytracer_tpu.render import progressive as jprog
from gpu_bidirectional_raytracer_tpu.scene import builtin as jbuiltin
from gpu_bidirectional_raytracer_tpu_torch import rng as trng
from gpu_bidirectional_raytracer_tpu_torch.core.types import (
    IntegratorConfig,
    Rays,
)
from gpu_bidirectional_raytracer_tpu_torch.integrators import path_tracer as tpt
from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_bounce as tpb
from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace as tops
from gpu_bidirectional_raytracer_tpu_torch.render import progressive as tprog
from torch_parity import (
    assert_protocol,
    floating_vpl,
    key_words,
    many_sphere_scene,
    to_torch_config,
    to_torch_scene,
    to_torch_vpls,
    torch_rays,
)

torch.set_num_threads(2)

W, H = 16, 12


def rig(scene, seed=0, sample=0, w=W, h=H):
    """``(cam, light ids, key, rays)`` of a frame of ``scene``."""
    cam = JCamera.make(jbuiltin.DEFAULT_CAMERA_ORIG,
                       jbuiltin.DEFAULT_CAMERA_TARGET, w, h)
    key = jrng.make_key(seed)
    u = jrng.site_uniforms(key, sample, 0, jrng.CAM_JITTER, 2, w * h)
    px, py = jcam.pixel_grid(w, h)
    return (cam, jlights(scene), key,
            jcam.primary_rays(cam, w, h, u[0], u[1], px, py))


CONFIGS = {"vpl": JConfig(), "no_vpl": JConfig(use_vpl=False),
           "golden": JConfig.cpu_golden()}


@pytest.mark.parametrize("direct_only", [False, True],
                         ids=["full", "direct_only"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_bounce_matches_jax_tracer_many_spheres(name, direct_only):
    cfg = CONFIGS[name]
    scene = many_sphere_scene()
    assert scene.num_spheres > 64
    cam, li, key, rays = rig(scene)
    vpls = floating_vpl(cfg) if cfg.use_vpl else None
    ref = np.asarray(jpt.trace(scene, cfg, li, rays, key, jnp.int32(0),
                               vpls=vpls, vlp_index=jnp.int32(0),
                               direct_only=direct_only))
    before = dict(tops.LAUNCHES)
    got = tpb.trace_pallas_bounce(
        to_torch_scene(scene), to_torch_config(cfg), li, torch_rays(rays),
        key_words(key), 0, vpls=None if vpls is None else to_torch_vpls(vpls),
        vlp_index=0, direct_only=direct_only, frame_dims=(W, H))
    assert tops.LAUNCHES == before      # CPU: the plain version
    assert_protocol(got.numpy(), ref)
    assert ref.max() > 0.01


@pytest.mark.parametrize("direct_only", [False, True],
                         ids=["full", "direct_only"])
def test_bounce_matches_jax_bounce_kernel_cornell(direct_only):
    """JAX's `trace_pallas_bounce` (interpret mode) at Cornell scale, as
    tests/test_pallas_bounce.py runs it."""
    cfg = JConfig(use_vpl=False)
    scene = jbuiltin.cornell_box()
    cam, li, key, rays = rig(scene, seed=1)
    ref = np.asarray(jbounce(scene, cfg, li, rays, key, jnp.int32(0),
                             direct_only=direct_only, interpret=True))
    got = tpb.trace_pallas_bounce(to_torch_scene(scene), to_torch_config(cfg),
                                  li, torch_rays(rays), key_words(key), 0,
                                  direct_only=direct_only)
    assert_protocol(got.numpy(), ref)
    assert ref.max() > 0.01


@pytest.mark.parametrize("impl", ["mix32", "threefry"])
def test_bounce_plain_loops_to_the_tracer_bitwise(impl):
    """`bounce_plain` over the depths is `path_tracer.trace`, bit for bit,
    in a lane window and with ``direct_only``; one depth advances only the
    live lanes."""
    scene = to_torch_scene(many_sphere_scene())
    cam, li, _, rays = rig(many_sphere_scene(), seed=2)
    key = trng.make_key(2, impl)
    cfg = IntegratorConfig()
    vpls = to_torch_vpls(floating_vpl(JConfig()))
    rays = torch_rays(rays)
    lo, hi = 3 * W, 9 * W
    win = Rays(o=rays.o[lo:hi], d=rays.d[lo:hi])
    for direct_only in (False, True):
        kw = dict(vpls=vpls, vlp_index=0, direct_only=direct_only,
                  lane_offset=lo, lane_total=W * H)
        want = tpt.trace(scene, cfg, li, win, key, 1, **kw)
        got = tpb.trace_pallas_bounce(scene, cfg, li, win, key, 1, **kw)
        assert torch.equal(got, want)
    planes = tpb.state_planes(win)
    one = tpb.bounce_plain(scene, cfg, li, planes, key, 1, 0, vpls, 0,
                           direct_only=True, lane_offset=lo,
                           lane_total=W * H)
    dead = one[13] < 0.5
    assert dead.any() and not dead.all()
    again = tpb.bounce_plain(scene, cfg, li, one, key, 1, 1, vpls, 0,
                             direct_only=True, lane_offset=lo,
                             lane_total=W * H)
    assert torch.equal(again[:, dead], one[:, dead])


def test_tiled_pass_is_bitwise_untiled_and_matches_jax():
    """`Renderer(backend="xla")` above 64 spheres (the plain banded
    program, on any device): 5-row bands equal one band bit for bit, and
    a pass matches JAX's banded renderer."""
    jscene = many_sphere_scene()
    tscene = to_torch_scene(jscene)
    o, t = jbuiltin.DEFAULT_CAMERA_ORIG, jbuiltin.DEFAULT_CAMERA_TARGET
    cfg = JConfig(light_points=64, max_depth=4)
    imgs = []
    for rows in (None, 5):
        r = tprog.Renderer(tscene, o, t, W, H, cfg=to_torch_config(cfg),
                           seed=4, device="cpu", backend="xla",
                           tile_rows=rows)
        assert r.backend == "xla"
        imgs.append(r.render(1))
    assert np.array_equal(imgs[0], imgs[1])
    jr = jprog.Renderer(jscene, o, t, W, H, cfg=cfg, seed=4, backend="xla",
                        tile_rows=5)
    ref = jr.render(1)
    assert_protocol(imgs[1].reshape(-1, 3), np.asarray(ref).reshape(-1, 3))


def test_renderer_routes_like_jax():
    """``"auto"``: the kernels on the card up to 1024 spheres, the plain
    program above it and on the CPU; a CPU renderer of 89 spheres takes
    the plain banded program and launches nothing."""
    rule = tprog.resolve_backend
    assert rule("cuda", 9, "auto") == "pallas"
    assert rule("cuda", 783, "auto") == "pallas"
    assert rule("cuda", 1025, "auto") == "xla"
    assert rule("cpu", 783, "auto") == "xla"
    assert rule("cpu", 783, "pallas") == "pallas"
    with pytest.raises(ValueError):
        rule("cuda", 9, "mxu")
    scene = to_torch_scene(many_sphere_scene())
    r = tprog.Renderer(scene, jbuiltin.DEFAULT_CAMERA_ORIG,
                       jbuiltin.DEFAULT_CAMERA_TARGET, 8, 6, device="cpu")
    before = dict(tops.LAUNCHES)
    r.step(direct_only=True)
    assert r.backend == "xla" and tops.LAUNCHES == before
    assert r.state.sample == 1


@pytest.mark.parametrize("cam_jitter", [False, True], ids=["ray", "camera"])
def test_streamed_tape_rows_are_the_kernel_rows(cam_jitter):
    """The tape a kernel reads for a threefry key: row r of the streamed
    ``[K, n]`` buffer is the r-th site row of `tape_sites`, in the lane
    window; for a mix32 key the site keys regenerate those same rows."""
    cfg = IntegratorConfig(max_depth=3)
    li = (2, 5)
    n, lo, total = 40, 24, 96
    if cam_jitter:
        lo, total = None, None
    for impl in ("threefry", "mix32"):
        key = trng.make_key(11, impl)
        tape = tops.tape_table(cfg, li, key, 4, cam_jitter, n, "cpu", lo,
                               total)
        sites = tops.tape_sites(cfg, len(li), cam_jitter)
        want = torch.cat([trng.site_uniforms(
            key, 4, d, p, len(rows), n, device="cpu", lane_offset=lo,
            lane_total=total)[rows] for d, p, rows in sites])
        assert list(tape.keys[-len(li):].tolist()) == list(li)
        if impl == "threefry":
            assert tape.n_rows == 0 and torch.equal(tape.stream, want)
            continue
        assert tape.stream is None and tape.n_rows == want.shape[0]
        words = tape.keys[:4 * tape.n_rows].to(torch.int64) & trng.MASK32
        lanes = torch.arange(n, dtype=torch.int64) + (lo or 0)
        for r, (k0, k1, row, _) in enumerate(words.reshape(-1, 4).tolist()):
            bits = trng._mix32(((row * (total or n) + lanes) & trng.MASK32)
                               ^ k0, k1)
            assert torch.equal(trng.bits_to_uniform(bits), want[r])
