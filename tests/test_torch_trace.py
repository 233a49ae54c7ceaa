"""The port's plain eye tracer against the JAX package on the CPU.

Ray mode: the port's `path_tracer.trace` (the plain version of the CUDA
kernel in ray mode) against JAX `path_tracer.trace`, in the three configs
of tests/test_pallas.py. Camera mode: the port's `trace_camera_plain` (the
plain version of the kernel in camera mode, and what the kernel wrapper
runs for CPU tensors) against JAX `trace_pallas_camera` run in interpret
mode. Both under the radiance protocol of tests/test_pallas.py.

The VPL configs use a VPL floating in the box, as tests/test_pallas.py
does: VPLs the light pass deposits on the 1e4-radius wall spheres sit on a
shadow-ray knife edge, where the JAX kernel and the JAX XLA tracer
themselves disagree on 1-20% of a 16x12 frame (seeds 0-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_bidirectional_raytracer_tpu import camera as jcam
from gpu_bidirectional_raytracer_tpu import rng as jrng
from gpu_bidirectional_raytracer_tpu.core.types import (
    Camera as JCamera,
    IntegratorConfig as JConfig,
    VplBuffer as JVplBuffer,
)
from gpu_bidirectional_raytracer_tpu.integrators import path_tracer as jpt
from gpu_bidirectional_raytracer_tpu.integrators.direct import (
    static_light_indices as jlights,
)
from gpu_bidirectional_raytracer_tpu.ops.pallas_trace import (
    trace_pallas_camera as jtrace_camera,
)
from gpu_bidirectional_raytracer_tpu.scene import builtin as jbuiltin
from gpu_bidirectional_raytracer_tpu_torch.integrators import direct as tdirect
from gpu_bidirectional_raytracer_tpu_torch.integrators import intersect as tisect
from gpu_bidirectional_raytracer_tpu_torch.integrators import path_tracer as tpt
from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace as tops
from torch_parity import (
    assert_protocol,
    key_words,
    to_torch_camera,
    to_torch_config,
    to_torch_scene,
    to_torch_vpls,
    torch_rays,
)

torch.set_num_threads(2)

W, H = 16, 12


def _floating_vpl(cfg):
    v = JVplBuffer.zeros(cfg.vpl_depth, cfg.light_points)
    return JVplBuffer(
        hp=v.hp.at[0, 0].set(jnp.array([60.0, 50.0, 90.0])),
        rad=v.rad.at[0, 0].set(jnp.array([2.0, 1.5, 1.0])),
        nl=v.nl.at[0, 0].set(jnp.array([0.0, -1.0, 0.0])),
        valid=v.valid.at[0, 0].set(True), sid=v.sid)


def _setup(cfg, seed=0):
    scene = jbuiltin.cornell_box()
    key = jrng.make_key(seed)
    cam = JCamera.make(jbuiltin.DEFAULT_CAMERA_ORIG,
                       jbuiltin.DEFAULT_CAMERA_TARGET, W, H)
    vpls = _floating_vpl(cfg) if cfg.use_vpl else None
    return scene, key, cam, vpls


CONFIGS = {
    "cpu_golden": JConfig.cpu_golden(),
    "gpu_no_vpl": JConfig(use_vpl=False),
    "gpu_vpl": JConfig(),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_ray_mode_matches_jax_trace(name):
    cfg = CONFIGS[name]
    scene, key, cam, vpls = _setup(cfg)
    li = jlights(scene)
    px, py = jcam.pixel_grid(W, H)
    u = jrng.site_uniforms(key, 0, 0, jrng.CAM_JITTER, 2, W * H)
    rays = jcam.primary_rays(cam, W, H, u[0], u[1], px, py)
    ref = np.asarray(jpt.trace(scene, cfg, li, rays, key, jnp.int32(0),
                               vpls=vpls, vlp_index=jnp.int32(0)))
    tscene = to_torch_scene(scene)
    assert tdirect.static_light_indices(tscene) == li
    got = tpt.trace(tscene, to_torch_config(cfg), li, torch_rays(rays),
                    key_words(key), 0,
                    vpls=None if vpls is None else to_torch_vpls(vpls),
                    vlp_index=0)
    assert_protocol(got.numpy(), ref)
    assert ref.max() > 0.01


def test_ray_mode_lane_window_matches():
    """A window of the frame draws its columns of the global tape."""
    cfg = JConfig(use_vpl=False)
    scene, key, cam, _ = _setup(cfg, seed=3)
    li = jlights(scene)
    px, py = jcam.pixel_grid(W, H)
    u = jrng.site_uniforms(key, 1, 0, jrng.CAM_JITTER, 2, W * H)
    rays = jcam.primary_rays(cam, W, H, u[0], u[1], px, py)
    lo, hi = 4 * W, 8 * W
    win = type(rays)(o=rays.o[lo:hi], d=rays.d[lo:hi])
    ref = np.asarray(jpt.trace(scene, cfg, li, win, key, jnp.int32(1),
                               lane_offset=jnp.int32(lo), lane_total=W * H))
    got = tops.trace_pallas(to_torch_scene(scene), to_torch_config(cfg), li,
                            torch_rays(win), key_words(key), 1,
                            lane_offset=lo, lane_total=W * H)
    assert_protocol(got.numpy(), ref)


@pytest.mark.parametrize("sample", [0, 1])
def test_camera_mode_matches_jax_kernel(sample):
    cfg = JConfig()
    scene, key, cam, vpls = _setup(cfg, seed=1)
    li = jlights(scene)
    ref = np.asarray(jtrace_camera(scene, cfg, li, cam, W, H, key,
                                   jnp.int32(sample), vpls=vpls,
                                   vlp_index=jnp.int32(0), interpret=True))
    before = dict(tops.LAUNCHES)
    got = tops.trace_pallas_camera(
        to_torch_scene(scene), to_torch_config(cfg), li,
        to_torch_camera(cam), W, H, key_words(key), sample,
        vpls=to_torch_vpls(vpls), vlp_index=0)
    assert tops.LAUNCHES == before   # CPU tensors: the plain version
    assert_protocol(got.numpy(), ref)


def test_stats_count_useful_work():
    cfg = JConfig(use_vpl=False)
    scene, key, cam, _ = _setup(cfg)
    li = jlights(scene)
    px, py = jcam.pixel_grid(W, H)
    u = jrng.site_uniforms(key, 0, 0, jrng.CAM_JITTER, 2, W * H)
    rays = jcam.primary_rays(cam, W, H, u[0], u[1], px, py)
    _, jstats = jpt.trace(scene, cfg, li, rays, key, jnp.int32(0),
                          with_stats=True)
    rad, tstats = tpt.trace(to_torch_scene(scene), to_torch_config(cfg), li,
                            torch_rays(rays), key_words(key), 0,
                            with_stats=True)
    assert rad.shape == (W * H, 3)
    for k in ("extension_segments", "diffuse_vertices"):
        # knife-edge lanes may end a bounce earlier or later
        assert abs(tstats[k] - int(jstats[k])) <= 0.035 * int(jstats[k])
    assert tstats["extension_segments"] >= W * H
    # The shadow work the kernel does: one light, so one sample set up per
    # diffuse vertex; only the samples facing the vertex are cast, and each
    # cast ray tests between one sphere and all of them.
    s = int(scene.rad.shape[0])
    assert tstats["hit_segments"] <= tstats["extension_segments"]
    assert tstats["shadow_setups"] == tstats["diffuse_vertices"] * len(li)
    assert 0 < tstats["shadow_rays"] < tstats["shadow_setups"]
    assert (tstats["shadow_rays"] <= tstats["shadow_tests"]
            < s * tstats["shadow_rays"])
    # The cast samples no sphere blocks: the ones the adjoint differentiates.
    assert 0 < tstats["shadow_lit"] <= tstats["shadow_rays"]


@pytest.mark.parametrize("vacuum", [False, True])
def test_anyhit_tests_count_the_early_exit_scan(vacuum):
    """`anyhit_tests` equals a scalar scan that stops at the first blocker
    and, in vacuum mode, skips emitters untested (the kernel's loop)."""
    scene = to_torch_scene(jbuiltin.cornell_box())
    rng = np.random.default_rng(5)
    o = torch.as_tensor(rng.uniform([1, 1, 1], [99, 80, 170], (64, 3)),
                        dtype=torch.float32)
    d = torch.as_tensor(rng.normal(size=(64, 3)), dtype=torch.float32)
    d = d / d.norm(dim=-1, keepdim=True)
    maxt = torch.as_tensor(rng.uniform(1, 200, 64), dtype=torch.float32)
    got = tisect.anyhit_tests(scene, o, d, maxt, vacuum=vacuum)
    ts = tisect.sphere_distances(scene, o, d)
    light = scene.is_light()
    want = []
    for i in range(64):
        n = 0
        for j in range(scene.rad.shape[0]):
            if vacuum and light[j]:
                continue
            n += 1
            if 0 < ts[i, j] < maxt[i]:
                break
        want.append(n)
    assert got.tolist() == want
    assert min(want) < max(want)   # some scans stopped early
