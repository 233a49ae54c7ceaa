"""bench_torch.py, the port's bench, against bench.py.

- Its work census of one pass at 16x12 equals bench.py's: the
  ``with_stats`` counts of JAX's tracer on the same rays and tape, and the
  shadow rays, segments and sphere tests bench.py derives from them.
- A run on the CPU (``--device cpu``, tiny sizes and chains) prints one
  JSON line with every key bench.py prints (its VPU utilization renamed
  ``fp32_util_lower_bound_pct_fwd``, which is null off the card), and
  every timed leg a number: no key is left empty or filled from another
  leg.
- A leg that launches another kernel than its own stops the run; a failed
  leg makes the exit code 1 and prints no result.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from gpu_bidirectional_raytracer_tpu import rng as jrng
from gpu_bidirectional_raytracer_tpu.core.types import Camera as JCamera
from gpu_bidirectional_raytracer_tpu.core.types import IntegratorConfig as JConfig
from gpu_bidirectional_raytracer_tpu.integrators import path_tracer as jpt
from gpu_bidirectional_raytracer_tpu.integrators.direct import (
    static_light_indices as jlights,
)
from gpu_bidirectional_raytracer_tpu.render import progressive as jprog
from gpu_bidirectional_raytracer_tpu.scene import parser as jparser
from gpu_bidirectional_raytracer_tpu_torch import rng as trng
from gpu_bidirectional_raytracer_tpu_torch.core.types import (
    Camera,
    IntegratorConfig,
)
from gpu_bidirectional_raytracer_tpu_torch.integrators.direct import (
    static_light_indices,
)
from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace
from gpu_bidirectional_raytracer_tpu_torch.scene import parser as tparser
from torch_parity import scn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_torch  # noqa: E402

# The keys of bench.py's JSON line (its `extra` when every leg ran), with
# `vpu_util_lower_bound_pct_fwd` under the port's name.
BENCH_KEYS = {
    "bwd_backend", "fwd_bwd_fused", "estimator", "rays_per_sec_fwd",
    "rays_per_sec_fwd_pallas", "pass_ms_fwd", "pass_ms_fwd_pallas",
    "rays_per_sec_sustained", "pass_ms_sustained", "pass_ms_sustained_xla",
    "rng_impl_default", "pass_ms_sustained_threefry",
    "rays_per_sec_sustained_threefry", "pass_ms_sustained_fast_rng",
    "rays_per_sec_sustained_fast_rng", "pass_ms_fwd_bwd_sustained",
    "rays_per_sec_fwd_bwd_sustained", "pass_ms_fwd_bwd_xla",
    "segments_per_pass", "extension_segments", "shadow_rays",
    "segments_per_sec_fwd", "segments_per_sec_fwd_bwd",
    "sphere_tests_per_pass", "model_gflops_per_pass",
    "fp32_util_lower_bound_pct_fwd", "resolution", "device", "platform",
    "complex_ms_fwd", "complex_ms_fwd_bwd", "complex_bwd_backend",
}
TIMED = {k for k in BENCH_KEYS if k.startswith(
    ("pass_ms", "rays_per_sec", "complex_ms", "segments_per_sec"))}


@pytest.mark.parametrize("name", ["cornell.scn", "simple.scn"])
def test_census_equals_jax_with_stats(name):
    w, h = 16, 12
    o, t, js = jparser.load_scene(scn(name))
    _, _, ts = tparser.load_scene(scn(name), device="cpu")
    cfg = JConfig()
    jcam = JCamera.make(o, t, w, h)
    key = jrng.make_key(0)
    li = jlights(js)
    rays = jprog.frame_rays(jcam, cfg, w, h, key, jnp.int32(0))
    _, stats = jax.jit(lambda: jpt.trace(js, cfg, li, rays, key,
                                         jnp.int32(0), with_stats=True))()
    n_ext = int(stats["extension_segments"])
    n_dv = int(stats["diffuse_vertices"])
    shadow = n_dv * (max(len(li), 1) + cfg.vpl_depth * cfg.max_vlp)
    got = bench_torch.census(
        ts, Camera.make(o, t, w, h, device="cpu"), IntegratorConfig(), w, h,
        static_light_indices(ts), trng.make_key(0))
    assert got == {
        "extension_segments": n_ext, "diffuse_vertices": n_dv,
        "shadow_rays": shadow, "segments_per_pass": n_ext + shadow,
        "sphere_tests_per_pass": (n_ext + shadow) * js.num_spheres,
        "model_flops_per_pass": ((n_ext + shadow) * js.num_spheres
                                 * bench_torch.FLOPS_PER_SPHERE_TEST)}
    assert n_ext > w * h and n_dv > 0


@pytest.fixture
def short_chains(monkeypatch):
    for name in ("PASSES", "STEPS", "COMPLEX_PASSES", "COMPLEX_STEPS",
                 "XLA_PASSES", "XLA_STEPS", "WARMUP"):
        monkeypatch.setattr(bench_torch, name, 1)
    monkeypatch.setattr(bench_torch, "REPS", 2)
    monkeypatch.setattr(bench_torch, "COMPLEX_W", 16)
    monkeypatch.setattr(bench_torch, "COMPLEX_H", 12)


def test_cpu_run_prints_every_bench_key(short_chains, capsys):
    torch.set_num_threads(2)
    assert bench_torch.main(["--device", "cpu", "--width", "16",
                             "--height", "12"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "rays_per_sec_per_chip_fwd_bwd_cornell"
    assert out["unit"] == "rays/s" and out["value"] > 0
    extra = out["extra"]
    assert BENCH_KEYS <= set(extra), BENCH_KEYS - set(extra)
    for k in TIMED:
        assert isinstance(extra[k], float) and extra[k] > 0, k
    assert extra["platform"] == "cpu" and extra["device"] == "cpu"
    assert extra["fp32_util_lower_bound_pct_fwd"] is None
    assert extra["resolution"] == "16x12"
    assert extra["complex_resolution"] == "16x12"
    assert all(len(v) == 2 for v in extra["reps_ms"].values())
    assert all(v == {} for v in extra["launches"].values())
    assert extra["pass_ms_fwd_pallas"] == extra["pass_ms_sustained"]
    assert extra["pass_ms_fwd"] == extra["pass_ms_sustained_xla"]


def test_a_leg_launching_another_kernel_fails():
    bench = bench_torch.Bench(torch.device("cpu"), reps=1)

    def chain(n):
        pallas_trace.LAUNCHES["trace_kernel"] += n

    with pytest.raises(bench_torch.LegFailure, match="trace_kernel"):
        bench.time("leg", chain, 3, {})
    pallas_trace.reset_launches()


def test_a_failed_leg_exits_1_without_a_result(monkeypatch, capsys):
    def fail(*args):
        raise bench_torch.LegFailure("leg fwd_pallas: launched {}")

    monkeypatch.setattr(bench_torch, "run", fail)
    assert bench_torch.main(["--device", "cpu"]) == 1
    cap = capsys.readouterr()
    assert cap.out == "" and "FAILED" in cap.err
