"""The port's progressive renderer and film against the JAX package, and
the port's own guarantees: it never imports JAX, and its entry points
raise when asked for a card that is not there."""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_bidirectional_raytracer_tpu.core.types import IntegratorConfig as JConfig
from gpu_bidirectional_raytracer_tpu.render import film as jfilm
from gpu_bidirectional_raytracer_tpu.render import progressive as jprog
from gpu_bidirectional_raytracer_tpu.scene import parser as jparser
import gpu_bidirectional_raytracer_tpu_torch as tpkg
from gpu_bidirectional_raytracer_tpu_torch import cli as tcli
from gpu_bidirectional_raytracer_tpu_torch import convert
from gpu_bidirectional_raytracer_tpu_torch import rng as trng
from gpu_bidirectional_raytracer_tpu_torch.core import types as ttypes
from gpu_bidirectional_raytracer_tpu_torch.integrators.direct import (
    static_light_indices,
)
from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace as tops
from gpu_bidirectional_raytracer_tpu_torch.parallel import _local_ranks as local_ranks
from gpu_bidirectional_raytracer_tpu_torch.parallel import distributed as tdist
from gpu_bidirectional_raytracer_tpu_torch.parallel import mesh as tmesh
from gpu_bidirectional_raytracer_tpu_torch.render import film as tfilm
from gpu_bidirectional_raytracer_tpu_torch.render import progressive as tprog
from gpu_bidirectional_raytracer_tpu_torch.scene import parser as tparser
from gpu_bidirectional_raytracer_tpu_torch.utils import profiling as tprof
from torch_parity import assert_protocol, scn, to_torch_vpls

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 16, 12


def _renderers(seed=0, cfg=None, w=W, h=H):
    o, t, js = jparser.load_scene(scn("cornell.scn"))
    _, _, ts = tparser.load_scene(scn("cornell.scn"), device="cpu")
    jr = jprog.Renderer(js, o, t, w, h, cfg=cfg, seed=seed, backend="xla")
    tr = tprog.Renderer(ts, o, t, w, h,
                        cfg=None if cfg is None else ttypes.IntegratorConfig(
                            **cfg.__dict__),
                        seed=seed, device="cpu")
    return jr, tr


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_eight_pass_render_matches_jax(seed):
    """8 passes at 48x36 (1728 pixels), so the 3.5% bound is 60 pixels.
    Measured bad fractions for seeds 0-3: 2.95%, 2.20%, 2.37%, 2.95%. A
    path flipped in any one pass makes its pixel bad, so 8 passes add up;
    JAX's own kernel and XLA renderers differ by 2.3-3.7% on the same
    frames (ROADMAP queue 3)."""
    jr, tr = _renderers(seed=seed, w=48, h=36)
    before = dict(tops.LAUNCHES)
    ref = jr.render(8)
    got = tr.render(8)
    assert tops.LAUNCHES == before   # CPU: the plain version, no kernel
    assert_protocol(got.reshape(-1, 3), ref.reshape(-1, 3))
    assert tr.state.sample == int(jr.state.sample) == 8
    assert tr.state.vlp_index == int(jr.state.vlp_index)
    assert np.array_equal(tr.state.counter.numpy(),
                          np.asarray(jr.state.counter))
    # colour bleeding: left wall red, right wall blue
    left, right = got[:, :6].mean(axis=(0, 1)), got[:, -6:].mean(axis=(0, 1))
    assert left[0] > left[2] and right[2] > right[0]


def test_state_carried_across_continues_like_jax():
    """Both packages continue from the same JAX state (`convert`)."""
    jr, tr = _renderers(seed=2)
    jr.render(3)
    st = jr.state
    tr.state = convert.state_from_numpy(
        np.asarray(st.colors), np.asarray(st.counter), to_torch_vpls(st.vpls),
        np.asarray(st.vlp_index), np.asarray(st.sample),
        jax.random.key_data(st.key), device="cpu")
    assert tr.state.key == tprog.init_state(W, H, tr.cfg, 2, "cpu").key
    ref = jr.render(3)
    got = tr.render(3)
    assert tr.state.sample == 6
    assert_protocol(got.reshape(-1, 3), ref.reshape(-1, 3))


def test_vpl_schedule_matches_jax():
    cfg = JConfig(light_points=64, max_vlp=5)
    jr, tr = _renderers(cfg=cfg)
    for _ in range(7):
        jr.step()
        tr.step()
        assert tr.state.vlp_index == int(jr.state.vlp_index)
    stale = JConfig(light_points=8, max_vlp=5, stale_vpl_window=True)
    jr, tr = _renderers(cfg=stale)
    for _ in range(6):
        jr.step()
        tr.step()
        assert tr.state.vlp_index == int(jr.state.vlp_index)


def test_accumulate_freezes_at_cap_like_jax():
    rng = np.random.default_rng(7)
    colors = rng.uniform(0, 1, (4, 5, 3)).astype(np.float32)
    counter = np.array([[0, 1, 5, 29999, 30000]] * 4, np.int32)
    radiance = rng.uniform(0, 2, (4, 5, 3)).astype(np.float32)
    jc, jn = jprog._accumulate(jnp.asarray(colors), jnp.asarray(counter),
                               jnp.asarray(radiance), 30000)
    tc, tn = tprog._accumulate(torch.as_tensor(colors),
                               torch.as_tensor(counter),
                               torch.as_tensor(radiance), 30000)
    assert np.array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-7)
    assert np.array_equal(tc.numpy()[:, 4], colors[:, 4])


def test_edits_reset_and_match_jax_camera():
    jr, tr = _renderers()
    tr.render(2)
    for r in (jr, tr):
        r.move_camera("dir", -5.0)
        r.rotate_camera("yaw", 0.1)
    assert tr.state.sample == 0 and float(tr.state.colors.abs().sum()) == 0
    for f in ("orig", "target", "dir", "x", "y"):
        np.testing.assert_allclose(getattr(tr.camera, f).numpy(),
                                   np.asarray(getattr(jr.camera, f)),
                                   rtol=1e-5, atol=1e-5)
    tr.edit_sphere(6, [1.0, 0.0, -2.0])
    jr.edit_sphere(6, [1.0, 0.0, -2.0])
    assert np.array_equal(tr.scene.p.numpy(), np.asarray(jr.scene.p))
    assert tr.light_idx == jr.light_idx


def test_ppm_bytes_identical(tmp_path):
    rng = np.random.default_rng(3)
    colors = rng.uniform(-0.1, 1.2, (H, W, 3)).astype(np.float32)
    jpath, tpath = tmp_path / "j.ppm", tmp_path / "t.ppm"
    jfilm.write_ppm(jnp.asarray(colors), jpath)
    tfilm.write_ppm(torch.as_tensor(colors), tpath)
    assert jpath.read_bytes() == tpath.read_bytes()
    assert np.array_equal(tfilm.read_ppm(tpath), jfilm.read_ppm(jpath))
    assert np.array_equal(tfilm.to_bytes(colors), jfilm.to_bytes(colors))
    assert (tfilm.snapshot_name(1, 2.5, 30)
            == jfilm.snapshot_name(1, 2.5, 30))


def test_port_and_smoke_script_never_import_jax(tmp_path):
    code = (
        "import sys, runpy\n"
        "import gpu_bidirectional_raytracer_tpu_torch as p\n"
        "from gpu_bidirectional_raytracer_tpu_torch import convert, camera\n"
        "from gpu_bidirectional_raytracer_tpu_torch.ops import _build, "
        "pallas_bounce, pallas_bounce_grad, pallas_grad, pallas_scan, "
        "pallas_trace\n"
        "from gpu_bidirectional_raytracer_tpu_torch.diff import gradients\n"
        "from gpu_bidirectional_raytracer_tpu_torch.render import film, "
        "progressive, viewer\n"
        "from gpu_bidirectional_raytracer_tpu_torch.integrators import "
        "direct, golden, intersect, light_tracer, path_tracer\n"
        "from gpu_bidirectional_raytracer_tpu_torch.parallel import "
        "_local_ranks, distributed, mesh\n"
        "from gpu_bidirectional_raytracer_tpu_torch import cli, native, rng\n"
        "from gpu_bidirectional_raytracer_tpu_torch.utils import checkpoint, "
        "debug, profiling\n"
        "assert cli.main(['--device', 'cpu', 'render', "
        "'assets/scenes/cornell.scn', '--width', '8', '--height', '6', "
        "'--spp', '2', '--out', sys.argv[1]]) == 0\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        # The programs around the package, each on the CPU at a tiny size.
        "import importlib.util, os, torch\n"
        "torch.set_num_threads(1)   # beside the other test workers\n"
        "def load(path):\n"
        "    spec = importlib.util.spec_from_file_location("
        "os.path.basename(path)[:-3], path)\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "    return mod\n"
        "tmp = os.path.dirname(sys.argv[1])\n"
        "ns = load('tools/torch_northstar.py')\n"
        "assert ns.main(['--family', 'golden', '--device', 'cpu', "
        "'--width', '8', '--height', '6', '--spp', '1', '--leg', 'render', "
        "'--out', os.path.join(tmp, 'g.npy')]) == 0\n"
        "lad = load('tools/torch_ladder.py')\n"
        "lad.render_leg('simple.scn', 8, 6, 1, 'cpu', 'auto')\n"
        "lad.inverse_scene('cpu')\n"
        "bt = load('bench_torch.py')\n"
        "o, t, sc = p.load_scene('assets/scenes/cornell.scn', device='cpu')\n"
        "assert bt.census(sc, p.Camera.make(o, t, 8, 6, device='cpu'), "
        "p.IntegratorConfig(), 8, 6, direct.static_light_indices(sc), "
        "rng.make_key(0))"
        "['extension_segments'] > 0\n"
        "inv = load('examples/torch_inverse_rendering.py')\n"
        "mc = load('examples/torch_multi_chip_render.py')\n"
        "inv.STEPS, mc.PASSES = 1, 1\n"
        "os.chdir(tmp)   # the examples write their images here\n"
        "assert inv.main(['--device', 'cpu']) == 0\n"
        "assert mc.main(['--device', 'cpu']) == 0\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m.startswith("
        "'gpu_bidirectional_raytracer_tpu.') "
        "or m == 'gpu_bidirectional_raytracer_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code,
                          str(tmp_path / "a.ppm")], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def _program(rel):
    """A program of the repo around the package (``bench_torch.py``,
    ``tools/``, ``examples/``) loaded as a module, its ``main`` not
    run."""
    spec = importlib.util.spec_from_file_location(
        os.path.basename(rel)[:-3], os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    o, t, scene = tparser.load_scene(scn("cornell.scn"), device="cpu")
    cfg = ttypes.IntegratorConfig()
    state = tprog.init_state(W, H, cfg, device="cpu")
    cam = ttypes.Camera.make(o, t, W, H, device="cpu")
    key, li = trng.make_key(0), static_light_indices(scene)
    rays = tprog.frame_rays(cam, cfg, W, H, key, 0)
    calls = [
        lambda: tparser.load_scene(scn("cornell.scn")),
        lambda: tpkg.cornell_box(),
        lambda: tprog.init_state(W, H, cfg),
        lambda: tprog.Renderer(scene, o, t, W, H),
        lambda: tprog.render_image(scene, o, t, W, H, 1),
        lambda: ttypes.Camera.make(o, t, W, H),
        lambda: ttypes.VplBuffer.zeros(),
        lambda: trng.uniforms(trng.make_key(0), 0, 0, 0, (4,)),
        lambda: trng.normals(trng.make_key(0), 0, 0, 0, (4,)),
        lambda: trng.fill_pool(trng.make_key(0), 4),
        lambda: tcli.main(["render", scn("cornell.scn"), "--spp", "1"]),
        lambda: tcli.main(["--device", "cuda:0", "render", "--spp", "1"]),
        lambda: tcli.main(["view", scn("cornell.scn")]),
        lambda: tcli.main(["optimize", "target.ppm", scn("cornell.scn")]),
        lambda: tprof.torch_trace("trace.json").__enter__(),
        lambda: tmesh.make_mesh(),
        lambda: tdist.initialize_cluster(),
        lambda: local_ranks.spawn_ranks(len, 2),
        lambda: tmesh.shard_state(state),
        lambda: tmesh.render_pass_sharded(scene, cam, state, cfg, W, H, li),
        lambda: tmesh.trace_pallas_sharded(scene, cfg, li, rays, key, 0),
        lambda: tmesh.trace_pallas_bounce_sharded(scene, cfg, li, rays, key,
                                                  0),
        lambda: tmesh.light_splat_sharded(scene, cam, cfg, li, key, 0, W, H),
        lambda: tmesh.render_loss_grad_sharded(scene, cam, key,
                                               torch.zeros(H, W, 3), cfg, W,
                                               H, li),
        # The programs around the package, without --device cpu.
        lambda: _program("bench_torch.py").main([]),
        lambda: _program("tools/torch_northstar.py").main(
            ["--family", "vpl"]),
        lambda: _program("tools/torch_ladder.py").main(["--rung", "simple"]),
        lambda: _program("examples/torch_inverse_rendering.py").main([]),
        lambda: _program("examples/torch_multi_chip_render.py").main([]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="is_available"):
            call()


def test_wrapper_refuses_cuda_without_kernel_route(monkeypatch):
    """A non-CPU tensor never takes the plain version: the wrapper goes
    to the kernel launch, which refuses a device that is not CUDA."""
    o, t, scene = tparser.load_scene(scn("cornell.scn"), device="cpu")
    cfg = ttypes.IntegratorConfig()
    meta = scene.replace(rad=scene.rad.to("meta"), p=scene.p.to("meta"),
                         e=scene.e.to("meta"), c=scene.c.to("meta"),
                         refl=scene.refl.to("meta"))
    cam = ttypes.Camera.make(o, t, W, H, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        tops.trace_pallas_camera(meta, cfg, (8,), cam, W, H, (1, 2), 0)


@pytest.mark.parametrize("rng_impl", [None, "threefry"])
def test_direct_only_and_threefry_renders_match_jax(rng_impl):
    """`Renderer(rng_impl=...)` and `step(direct_only=True)` against the
    JAX renderer with the same options: two direct-only passes (on the
    CPU both take the plain banded program), then two full passes."""
    o, t, js = jparser.load_scene(scn("cornell.scn"))
    _, _, ts = tparser.load_scene(scn("cornell.scn"), device="cpu")
    jr = jprog.Renderer(js, o, t, W, H, seed=3, backend="xla",
                        rng_impl=rng_impl)
    tr = tprog.Renderer(ts, o, t, W, H, seed=3, device="cpu",
                        rng_impl=rng_impl)
    assert tr.state.key == tuple(
        int(w) for w in np.asarray(jax.random.key_data(jr.state.key)))
    for direct_only in (True, False):
        ref = jr.render(2, direct_only=direct_only)
        got = tr.render(2, direct_only=direct_only)
        assert_protocol(got.reshape(-1, 3), np.asarray(ref).reshape(-1, 3))
    assert tr.state.sample == 4
    tr.reset()
    assert tr.state.key == tprog.init_state(W, H, tr.cfg, 3, "cpu",
                                            rng_impl).key


def _port_renderer(w=W, h=H, **kw):
    o, t, ts = tparser.load_scene(scn("cornell.scn"), device="cpu")
    return tprog.Renderer(ts, o, t, w, h, seed=4, device="cpu", **kw)


def _same_state(a, b):
    for f in ("colors", "counter"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (a.sample, a.vlp_index, a.key) == (b.sample, b.vlp_index, b.key)
    for f in ("hp", "rad", "nl", "valid", "sid"):
        assert torch.equal(getattr(a.vpls, f), getattr(b.vpls, f)), f


@pytest.mark.parametrize("kw", [dict(backend="pallas"),
                                dict(backend="xla", tile_rows=5)],
                         ids=["render_pass", "tiled_pass"])
def test_chunk_equals_steps_across_a_vpl_refresh(kw):
    """`step_n(5)` and `render_chunk` against five `step`s, through the
    untiled kernel route's body (`render_pass`; on the CPU its plain
    version) and the banded one; the VPLs refresh at passes 0, 2 and 4."""
    stepped, chunked = _port_renderer(**kw), _port_renderer(**kw)
    for _ in range(5):
        stepped.step()
    chunked.step_n(5)
    _same_state(stepped.state, chunked.state)
    assert chunked.state.vlp_index == 2 * chunked.cfg.max_vlp
    r = _port_renderer(**kw)
    st = tprog.render_chunk(r.scene, r.camera, r.state, 5, r.cfg, W, H,
                            r.light_idx, r.tile_rows, r.backend)
    _same_state(st, stepped.state)


def test_chunk_boundary_invariance():
    """2 + 3 chunked passes, and `render(5, chunk=2)`, equal 5 steps (as
    tests/test_render.py::TestChunkedRendering)."""
    a, b, c = _port_renderer(), _port_renderer(), _port_renderer()
    img = a.render(5)
    b.step_n(2)
    b.step_n(3)
    _same_state(a.state, b.state)
    assert np.array_equal(c.render(5, chunk=2), img)
    _same_state(a.state, c.state)


def test_chunked_render_matches_jax():
    """`Renderer.render(spp=6, chunk=4)` against JAX's (backend "xla")
    under the radiance protocol."""
    jr, tr = _renderers(seed=6)
    ref = jr.render(6, chunk=4)
    got = tr.render(6, chunk=4)
    assert_protocol(got.reshape(-1, 3), np.asarray(ref).reshape(-1, 3))
    assert tr.state.sample == int(jr.state.sample) == 6
    assert tr.state.vlp_index == int(jr.state.vlp_index)
    assert np.array_equal(tr.state.counter.numpy(),
                          np.asarray(jr.state.counter))
