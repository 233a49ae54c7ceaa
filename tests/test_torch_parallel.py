"""The port's sharding (`parallel.mesh`, `parallel.distributed`) on
``gloo`` ranks of the CPU, against one process and against the JAX
package's `parallel.mesh` on the conftest's 8-device CPU mesh.

Each rank count (1, 2, 4) is one spawn (`parallel._local_ranks.spawn_ranks`:
one intra-op thread per rank, a timeout of its own, the ranks killed on
expiry) that runs every sharded function once
(tests/torch_parallel_ranks.py); the tests read its results. Inputs are
cornell.scn at 16x16 and an 89-sphere scene (tests/torch_parity.py's
`many_sphere_scene`) for the bounce route, with keys, a VPL floating in
the box and training targets made from numpy seeds, shared with the JAX
side.

- Bits (``torch.equal``) against one process: the gathered trace and
  bounce trace against the monolithic `trace_pallas` /
  `trace_pallas_bounce`; the render passes (across the VPL refresh at
  sample 2) against ``Renderer(tile_rows=H/N)``; each rank's light
  subpaths against their slice of the full pass.
- tests/test_parallel.py's tolerances: the render against the untiled
  renderer ``rtol=1e-5, atol=1e-6``; the splat's counts exact and its
  colours ``rtol=1e-5, atol=1e-6 max|ref|``; the training step's loss
  within 1e-5 and ``p, rad, e, c`` within ``rtol=1e-4, atol=1e-4
  max|ref|`` of `render_loss_grad` on one process.
- Against JAX (the port's 4 ranks, JAX's 8 devices), each test names the
  JAX function and the tolerance it uses.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_parallel_ranks as tr
from gpu_bidirectional_raytracer_tpu import rng as jrng
from gpu_bidirectional_raytracer_tpu.core.types import Camera as JCamera
from gpu_bidirectional_raytracer_tpu.core.types import IntegratorConfig as JConfig
from gpu_bidirectional_raytracer_tpu.diff import gradients as JG
from gpu_bidirectional_raytracer_tpu.integrators import path_tracer as jpt
from gpu_bidirectional_raytracer_tpu.integrators.direct import (
    static_light_indices as jlights,
)
from gpu_bidirectional_raytracer_tpu.parallel import mesh as jmesh
from gpu_bidirectional_raytracer_tpu.render import progressive as jprog
from gpu_bidirectional_raytracer_tpu.scene import parser as jparser
from gpu_bidirectional_raytracer_tpu_torch.parallel import _local_ranks as local
from gpu_bidirectional_raytracer_tpu_torch.parallel import distributed as tdist
from gpu_bidirectional_raytracer_tpu_torch.parallel import mesh as tmesh
from torch_parity import (
    assert_protocol,
    floating_vpl,
    key_words,
    many_sphere_scene,
    max_rel,
    scn,
    to_torch_config,
)

torch.set_num_threads(2)

WORLDS = (1, 2, 4)
SPAWN_TIMEOUT = 120.0
W, H = tr.W, tr.H
PARAMS = ("p", "rad", "e", "c")

# The JAX side of every case: config and key (mix32 from `rng.make_key`,
# threefry from `jax.random.key`).
JCASES = {
    "trace/cornell": ("cornell", JConfig(max_depth=2), jrng.make_key(0)),
    "bounce/cornell": ("cornell", JConfig(use_vpl=False), jrng.make_key(1)),
    "bounce/many": ("many", JConfig(), jrng.make_key(2)),
    "splat": ("cornell", JConfig(), jax.random.key(11)),
    "step/cornell": ("cornell", JConfig(vis_grad_tau=2.0, max_depth=2),
                     jax.random.key(3)),
    "step/many": ("many", JConfig(max_depth=2), jrng.make_key(5)),
}
RENDER = {"cornell": (JConfig(), 3, tr.RENDER_PASSES),
          "many": (JConfig(light_points=64, max_depth=4), 4, 2)}
LOSSES = {"cornell": "l2", "many": "log"}


def _impl(jkey):
    return "threefry" if "fry" in str(jkey.dtype) else "mix32"


def _np(*arrays):
    return tuple(np.asarray(a) for a in arrays)


@pytest.fixture(scope="module")
def jax_side():
    o, t, cornell = jparser.load_scene(scn("cornell.scn"))
    return {"cornell": cornell, "many": many_sphere_scene(),
            "orig": np.asarray(o, np.float32),
            "target": np.asarray(t, np.float32),
            "vpl": floating_vpl(JConfig()),
            # Cornell: tests/test_parallel.py's black target.
            "step_target": {
                "cornell": np.zeros((H, W, 3), np.float32),
                "many": np.random.default_rng(8).uniform(
                    0.0, 0.5, (H, W, 3)).astype(np.float32)}}


@pytest.fixture(scope="module")
def spec(jax_side):
    def case(name, **kw):
        scene, cfg, jkey = JCASES[name]
        return tr.Case(scene, to_torch_config(cfg), key_words(jkey),
                       _impl(jkey), **kw)

    v = jax_side["vpl"]
    return tr.Spec(
        scenes={k: _np(s.rad, s.p, s.e, s.c, s.refl)
                for k in ("cornell", "many") for s in [jax_side[k]]},
        orig=jax_side["orig"], target=jax_side["target"],
        vpl=_np(v.hp, v.rad, v.nl, v.valid, v.sid),
        step_target=jax_side["step_target"],
        trace={"cornell": case("trace/cornell")},
        bounce={k: case(f"bounce/{k}") for k in ("cornell", "many")},
        render={k: tr.Case(k, to_torch_config(cfg), (), seed=seed,
                           passes=passes)
                for k, (cfg, seed, passes) in RENDER.items()},
        splat=case("splat"),
        step={k: case(f"step/{k}", loss=LOSSES[k])
              for k in ("cornell", "many")})


def _cached(compute):
    """A per-module cache of ``compute(world)``; a failure is kept and
    raised again, so a failed spawn is not repeated by every test."""
    cache = {}

    def get(world):
        if world not in cache:
            try:
                cache[world] = (True, compute(world))
            except Exception as err:  # noqa: BLE001 - re-raised below
                cache[world] = (False, err)
        ok, value = cache[world]
        if not ok:
            raise value
        return value
    return get


@pytest.fixture(scope="module")
def ranks(spec):
    """Each rank's `sharded_cases` results, one spawn per rank count."""
    return _cached(lambda world: local.spawn_ranks(
        tr.sharded_cases, world, (spec,), device="cpu",
        timeout=SPAWN_TIMEOUT))


@pytest.fixture(scope="module")
def one_rank(spec):
    return tr.one_rank_cases(spec)


@pytest.fixture(scope="module")
def eight_devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the conftest's 8 virtual devices")
    return jmesh.make_mesh(devs)


# -- N ranks against one process --------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["trace/cornell", "bounce/cornell",
                                  "bounce/many"])
def test_sharded_traces_are_the_one_rank_bits(ranks, one_rank, world, name):
    ref = one_rank[name]
    for out in ranks(world):
        assert torch.equal(out[name], ref), name
    assert ref.max() > 0.01


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("scene", ["cornell", "many"])
def test_sharded_render_passes_are_the_banded_renderer_bits(
        spec, ranks, world, scene):
    """Every pass, across the VPL refresh (samples 0 and 2), gathered on
    every rank: ``Renderer(tile_rows=H/N)``'s colours, counts, sample and
    VPL window."""
    ref = tr.one_rank_render(spec, scene, H // world)
    for out in ranks(world):
        for got, want in zip(out[f"render/{scene}"], ref):
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
            assert got[2:] == want[2:]


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_render_matches_the_untiled_renderer(spec, ranks, world):
    """tests/test_parallel.py:50's tolerance against the untiled
    renderer's image."""
    ref = tr.one_rank_render(spec, "cornell", None)[-1][0]
    got = ranks(world)[0]["render/cornell"][-1][0]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert ref.max() > 0.01


@pytest.mark.parametrize("world", WORLDS)
def test_light_subpath_windows_are_slices_of_the_full_pass(ranks, one_rank,
                                                           world):
    full = one_rank["light_full"]
    n = full.hp.shape[1] // world
    for r, out in enumerate(ranks(world)):
        for f, win in out["light_window"].items():
            assert torch.equal(win, getattr(full, f)[:, r * n:(r + 1) * n]), f


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_splat_matches_one_rank(ranks, one_rank, world):
    """tests/test_parallel.py:236-240: counts exact, colours within
    ``1e-5 |ref| + 1e-6 max|ref|``; every rank holds the same films."""
    ref_c, ref_n = one_rank["splat"]
    outs = ranks(world)
    c, cnt = outs[0]["splat"]
    assert cnt.dtype == torch.int32 and torch.equal(cnt, ref_n)
    scale = float(ref_c.abs().max())
    np.testing.assert_allclose(c.numpy(), ref_c.numpy(), rtol=1e-5,
                               atol=1e-6 * scale)
    assert int(cnt.sum()) > 1000
    for out in outs[1:]:
        assert torch.equal(out["splat"][0], c)
        assert torch.equal(out["splat"][1], cnt)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("scene", ["cornell", "many"])
def test_sharded_step_matches_render_loss_grad(ranks, one_rank, world,
                                               scene):
    """Cornell: l2 with VPLs and the visibility carrier, max_depth 2 (the
    eye-path kernel and its adjoint's route); 89 spheres: log, max_depth
    3 (the fact kernel and the re-walk's route). Every rank holds the
    same bits."""
    ref = one_rank[f"step/{scene}"]
    outs = ranks(world)
    res = local.step_close(outs[0][f"step/{scene}"], ref)
    assert res["ok"], res
    assert np.abs(np.asarray(ref["p"])).max() > 0
    for out in outs[1:]:
        for f, v in out[f"step/{scene}"].items():
            assert torch.equal(v, outs[0][f"step/{scene}"][f]), f


# -- Against the JAX package -------------------------------------------------

def _jax_rays(jax_side, cfg, jkey):
    cam = JCamera.make(jax_side["orig"], jax_side["target"], W, H)
    return cam, jprog.frame_rays(cam, cfg, W, H, jkey, jnp.int32(0))


def test_sharded_trace_matches_jax(jax_side, eight_devices, ranks):
    """JAX's `trace_pallas_sharded` (interpret mode, 8 devices) against
    the port's 4 ranks, under the radiance protocol of
    tests/test_pallas.py (2e-3 + 2e-3 |ref|, at most 3.5% of pixels):
    JAX's kernel and the port's plain tracer round knife edges apart."""
    scene, cfg, jkey = JCASES["trace/cornell"]
    js = jax_side[scene]
    _, rays = _jax_rays(jax_side, cfg, jkey)
    ref = jmesh.trace_pallas_sharded(js, cfg, jlights(js), rays, jkey,
                                     jnp.int32(0), eight_devices,
                                     vpls=jax_side["vpl"],
                                     vlp_index=jnp.int32(0), interpret=True)
    assert_protocol(ranks(4)[0]["trace/cornell"].numpy(), np.asarray(ref))


def test_sharded_bounce_trace_matches_jax(jax_side, eight_devices, ranks):
    """Cornell: JAX's `trace_pallas_bounce_sharded` (interpret mode, 8
    devices) against the port's 4 ranks, under the radiance protocol."""
    _, cfg, jkey = JCASES["bounce/cornell"]
    js = jax_side["cornell"]
    _, rays = _jax_rays(jax_side, cfg, jkey)
    ref = jmesh.trace_pallas_bounce_sharded(
        js, cfg, jlights(js), rays, jkey, jnp.int32(0), eight_devices,
        interpret=True)
    assert_protocol(ranks(4)[0]["bounce/cornell"].numpy(), np.asarray(ref))


def test_sharded_bounce_trace_matches_jax_tracer_many_spheres(jax_side,
                                                               ranks):
    """89 spheres: JAX's tracer (`path_tracer.trace`, one device; its
    bounce kernel in interpret mode costs minutes at 89 spheres) against
    the port's 4 ranks, under the radiance protocol, as
    tests/test_torch_bounce.py holds the one-process route."""
    _, cfg, jkey = JCASES["bounce/many"]
    js = jax_side["many"]
    _, rays = _jax_rays(jax_side, cfg, jkey)
    ref = jpt.trace(js, cfg, jlights(js), rays, jkey, jnp.int32(0),
                    vpls=jax_side["vpl"], vlp_index=jnp.int32(0))
    assert_protocol(ranks(4)[0]["bounce/many"].numpy(), np.asarray(ref))


def test_sharded_render_matches_jax(jax_side, eight_devices, ranks):
    """JAX's `Renderer` on a state placed by its `shard_state` (8
    devices, tests/test_parallel.py's `_render`), four passes, against
    the port's 4 ranks, under the radiance protocol."""
    cfg, seed, passes = RENDER["cornell"]
    r = jprog.Renderer(jax_side["cornell"], jax_side["orig"],
                       jax_side["target"], W, H, cfg=cfg, seed=seed)
    r.state = jmesh.shard_state(r.state, eight_devices)
    ref = np.asarray(r.render(passes))
    got = ranks(4)[0]["render/cornell"][-1][0].numpy()
    assert_protocol(got.reshape(-1, 3), ref.reshape(-1, 3))


def test_sharded_splat_matches_jax(jax_side, eight_devices, ranks):
    """JAX's `light_splat_sharded` (8 devices) against the port's 4
    ranks. The port's light pass differs from JAX's on a few wall hits
    (tests/test_torch_light_tracer.py), so the films are held as
    tests/test_torch_splat.py holds light passes: the colour film divided
    by the lanes per light under the radiance protocol, and the counts to
    0.5% of the splats."""
    scene, cfg, jkey = JCASES["splat"]
    js = jax_side[scene]
    cam = JCamera.make(jax_side["orig"], jax_side["target"], tr.SPLAT_W,
                       tr.SPLAT_H)
    ref_c, ref_n = jmesh.light_splat_sharded(
        js, cam, cfg, jlights(js), jkey, jnp.int32(0), tr.SPLAT_W,
        tr.SPLAT_H, eight_devices)
    c, cnt = ranks(4)[0]["splat"]
    per_light = cfg.light_points // len(jlights(js))
    assert_protocol(c.numpy().reshape(-1, 3) / per_light,
                    np.asarray(ref_c).reshape(-1, 3) / per_light)
    diff = np.abs(cnt.numpy().astype(np.int64) - np.asarray(ref_n)).sum()
    assert diff <= 0.005 * np.asarray(ref_n).sum()


@pytest.mark.parametrize("scene", ["cornell", "many"])
def test_sharded_step_matches_jax(jax_side, ranks, scene):
    """JAX's `render_loss_grad(backend="xla")` on one device, run op by op
    (``jax.disable_jit``): its sharded step's interpret-mode adjoint costs
    minutes at these sizes, and tests/test_parallel.py holds that step to
    this one. The port's 4 ranks against it under the bounds of
    tests/test_torch_grad.py for the port against JAX (the JAX suite's,
    tests/test_pallas_grad.py:108): the loss within 1e-5 relative and
    each gradient's `_max_rel` below 2e-2 with VPLs.

    The port's one process on these inputs (tools/torch_step_vs_jax.py;
    the ranks equal it within 1e-4): Cornell loss 2.1e-6, ``_max_rel``
    3.0e-4 (p, rad), 2.4e-6 (e), 4.8e-5 (c); 89 spheres loss 4.6e-7,
    8.1e-4 (p, rad), 8.0e-7 (e), 3.9e-4 (c). Jitted JAX differs from its
    own op-by-op run by 2.0e-2 (Cornell, on the 1e4-radius walls, spheres
    0-2, whose float32 hit points keep about 1e-3 of precision) and
    7.0e-3 (89 spheres), so it is not the reference here. Over 20
    Cornell keys and targets at this size (this one among them) the step
    is a knife-edge matter for JAX itself: its jitted and op-by-op runs
    break these bounds on 9 (gradients) and 16 (loss) of them, the port
    against op-by-op JAX on 4 and 12 (tools/torch_step_vs_jax.py)."""
    name = f"step/{scene}"
    _, cfg, jkey = JCASES[name]
    js = jax_side[scene]
    cam = JCamera.make(jax_side["orig"], jax_side["target"], W, H)
    with jax.disable_jit():
        loss, g = JG.render_loss_grad.__wrapped__(
            js, cam, jkey, jnp.asarray(jax_side["step_target"][scene]), cfg,
            W, H, jlights(js), 1, LOSSES[scene], "xla")
    got = ranks(4)[0][name]
    assert abs(float(got["loss"]) - float(loss)) <= 1e-5 * abs(float(loss))
    for f in PARAMS:
        assert max_rel(np.asarray(getattr(g, f)), got[f].numpy()) < 2e-2, f


# -- Meshes, groups and spawns ---------------------------------------------

def test_one_rank_mesh_without_a_process_group(spec, one_rank):
    """Without a group `make_mesh` is one rank, and every sharded
    function is the one-process program, bit for bit."""
    assert not dist.is_initialized()
    m = tmesh.make_mesh(device="cpu")
    assert (m.group, m.size, m.rank, m.device) == (None, 1, 0,
                                                  torch.device("cpu"))
    assert m.axis_names == ("rays",)
    assert tmesh.pad_height_to(m, 30) == 30
    assert tmesh.pad_height_to(tmesh.Mesh(None, 4, 0, m.device), 30) == 32
    out = tr.sharded_cases(m, spec)
    for name in ("trace/cornell", "bounce/cornell", "bounce/many"):
        assert torch.equal(out[name], one_rank[name])
    for scene in ("cornell", "many"):
        ref = tr.one_rank_render(spec, scene, H)
        for got, want in zip(out[f"render/{scene}"], ref):
            assert torch.equal(got[0], want[0])
            assert got[2:] == want[2:]
    assert torch.equal(out["splat"][0], one_rank["splat"][0])
    for f, v in out["step/many"].items():
        assert torch.allclose(v, one_rank["step/many"][f], rtol=1e-4,
                              atol=1e-4 * float(v.abs().max())), f


def test_ragged_splits_raise_jax_value_error(spec):
    """JAX's ``ValueError("... not divisible by mesh size ...")``."""
    case = spec.trace["cornell"]
    dev = torch.device("cpu")
    m3 = tmesh.Mesh(None, 3, 1, dev)
    scene, cam, li = tr._inputs(spec, case, dev)
    key = case.port_key()
    from gpu_bidirectional_raytracer_tpu_torch.render import progressive

    rays = progressive.frame_rays(cam, case.cfg, W, H, key, 0)
    state = progressive.init_state(W, H, case.cfg, 0, dev)
    calls = [
        lambda: tmesh.trace_pallas_sharded(scene, case.cfg, li, rays, key, 0,
                                           m3),
        lambda: tmesh.trace_pallas_bounce_sharded(scene, case.cfg, li, rays,
                                                  key, 0, m3),
        lambda: tmesh.shard_state(state, m3),
        lambda: tmesh.render_pass_sharded(scene, cam, state, case.cfg, W, H,
                                          li, m3),
        lambda: tmesh.light_splat_sharded(scene, cam, case.cfg, li, key, 0,
                                          W, H, m3),
        lambda: tmesh.render_loss_grad_sharded(
            scene, cam, key, torch.zeros(H, W, 3), case.cfg, W, H, li, 1,
            m3),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="not divisible by mesh size 3"):
            call()


def test_make_mesh_raises_on_world_size_without_a_group(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_mesh(device="cpu")


def test_initialize_cluster_is_idempotent():
    """A second call does nothing, whatever it names; the group is one
    process on the CPU with ``gloo``."""
    assert not dist.is_initialized()
    try:
        tdist.initialize_cluster(f"tcp://localhost:{local.free_port()}", 1,
                                 0, device="cpu")
        group = dist.group.WORLD
        assert dist.get_backend() == "gloo"
        tdist.initialize_cluster("tcp://localhost:1", 5, 3, backend="nccl")
        assert dist.group.WORLD is group and dist.get_world_size() == 1
        assert not tdist.is_multi_host()
        m = tmesh.make_mesh(device="cpu")
        assert m.group is group and (m.size, m.rank) == (1, 0)
        t = torch.arange(6, dtype=torch.float32).reshape(3, 2)
        assert torch.equal(tmesh.gather_rows(t, m), t)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_nccl_needs_a_card():
    with pytest.raises(ValueError, match="nccl backend needs a card"):
        tdist.initialize_cluster(backend="nccl", device="cpu")
    assert not dist.is_initialized()


def test_a_failed_rank_fails_the_caller():
    """Rank 1 raises while rank 0 waits in a collective: the caller gets
    rank 1's traceback and rank 0 is killed."""
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        local.spawn_ranks(tr.failing_rank, 2, (1,), device="cpu",
                          timeout=SPAWN_TIMEOUT)


def test_a_hung_rank_fails_the_caller_at_its_timeout():
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="did not finish within 5"):
        local.spawn_ranks(tr.hanging_rank, 2, (600.0,), device="cpu",
                          timeout=5.0)
    assert time.monotonic() - t < 60.0
