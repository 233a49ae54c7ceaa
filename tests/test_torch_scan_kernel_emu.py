"""The bounce, fact and scan kernels' CUDA sources run on the CPU by host
emulation, against the port's plain versions.

``csrc/bounce_kernel.cu`` and ``csrc/scan_kernel.cu`` are compiled as C++
with g++ (``-std=c++20 -ffp-contract=off``) against the shim in
``csrc/emu/`` (every CUDA thread a fiber; each collective a barrier of the
lanes its mask names, so the groups of lanes of a warp run theirs apart;
``__syncthreads_or``; an emulated card of 3 SMs holding one block each, so
the persistent blocks take the rays in several rounds). Only two things of the source
are rewritten: the ``<<<...>>>`` launch and the ``extern __shared__``
lines. The entry points are called through the real wrappers
(`pallas_scan.prepare_anyhit`, `prepare_nearest`,
`pallas_bounce.prepare_bounce`) on CPU tensors, with ``_build.load``
patched to the emulated library.

Cases, on complex.scn (783 spheres):
- ``anyhit_kernel`` in both modes with G = 1, 8 and 32 lanes a segment,
  on 1,000 random segments (not a multiple of G times the block) with a
  dead first stretch and 35% of the rest active, against
  ``anyhit_plain(tile=1)`` bit for bit on every lane;
- ``nearest_kernel`` at its default G against ``nearest_plain``
  (``tile=1``) on every lane, with dead stretches: bit for bit but for
  ``t``, which PyTorch's CPU arithmetic rounds otherwise on the ground
  sphere of radius 1e4 (within 4 ulps of the scene's scale); at G = 1, 4,
  8 and 32 the bits of G = 16 on every lane, and on a ragged prefix of
  987 lanes the full launch's bits;
- ``bounce_kernel`` and ``aux_kernel`` at 16x12, depth 7, mix32 and
  threefry keys: each depth launched with G = 1, 4, 8 and 32 on the
  plain version's state, every G the bits
  of G = 1 in the state and the facts; G = 1 against ``bounce_plain``
  within the radiance protocol of tests/test_pallas.py, and its facts
  against the plain collector's (at most 3.5% of the entries either side
  consumed differ). The host's ``cosf``/``sinf`` may differ from
  PyTorch's by an ulp, which may turn a path, so the state is not held
  bit for bit to the plain version here; on the card ``chip_smoke.py``
  holds it so;
- ties: complex.scn with a copy of a sphere appended, so its hits tie in
  t across the lanes of a group; G = 8 and 32 keep the lowest index, as
  G = 1 (the serial scan) does, at depth 0, in the fact kernel and in
  ``nearest_kernel``.

Skips when g++ is missing. About 30 s of one worker.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gpu_bidirectional_raytracer_tpu_torch import rng
from gpu_bidirectional_raytracer_tpu_torch.core.types import (
    Camera,
    IntegratorConfig,
)
from gpu_bidirectional_raytracer_tpu_torch.integrators import light_tracer
from gpu_bidirectional_raytracer_tpu_torch.integrators.direct import (
    static_light_indices,
)
from gpu_bidirectional_raytracer_tpu_torch.ops import _build
from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_bounce as pb
from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_scan as ps
from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace as ops
from gpu_bidirectional_raytracer_tpu_torch.render import progressive
from gpu_bidirectional_raytracer_tpu_torch.scene.parser import load_scene

from test_torch_grad_kernel_emu import _emulated_source
from torch_parity import MAX_BAD_FRAC, assert_protocol, scn

W, H, N_SEGMENTS, BLOCK = 16, 12, 1000, 64
GROUPS = (1, 4, 8, 32)


@pytest.fixture(scope="module")
def emu_libs(tmp_path_factory):
    """The two kernel sources built for the host."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host emulation of the "
                    "kernel sources needs a C++ compiler")
    out = tmp_path_factory.mktemp("scan_emu")
    libs = {}
    for name in ("bounce_kernel", "scan_kernel"):
        src = out / f"{name}.cpp"
        src.write_text(_emulated_source(_build.SOURCES[name].read_text()))
        lib = out / f"lib{name}_emu.so"
        proc = subprocess.run(
            [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
             "-shared", "-w", "-I", str(_build.CSRC_DIR / "emu"), "-I",
             str(_build.CSRC_DIR), "-o", str(lib), str(src)],
            capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-4000:]
        libs[name] = ctypes.CDLL(str(lib))
    return libs


@pytest.fixture
def emulated(emu_libs, monkeypatch):
    """The wrappers launching the emulated entry points on CPU tensors."""

    def load(entry):
        source, name, argtypes = _build._ENTRIES[entry]
        f = getattr(emu_libs[source], name)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        return f

    def tables(scene, cfg, li, key, sample, vpls, vlp_index, n,
               cam_jitter=False, lane_offset=None, lane_total=None):
        # ops.launch_tables's tables, which it builds only on the card.
        return (ops._scene_table(scene),
                ops._vpl_table(cfg, vpls, vlp_index, scene.device),
                ops.tape_table(cfg, li, key, sample, cam_jitter, n,
                               scene.device, lane_offset, lane_total))

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(ops, "current_stream", lambda dev: None)
    monkeypatch.setattr(ops, "launch_tables", tables)


@pytest.fixture(scope="module")
def complex_scene():
    return load_scene(scn("complex.scn"), device="cpu")


def _segments(scene):
    """Random segments among complex.scn's spheres: origins in the box of
    the fractal, unit directions, lengths up to 100; the first 100 lanes
    inactive, 35% of the rest active."""
    r = np.random.default_rng(5)
    o = r.uniform(-60.0, 60.0, (N_SEGMENTS, 3)).astype(np.float32)
    d = r.normal(size=(N_SEGMENTS, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    maxt = r.uniform(1.0, 100.0, N_SEGMENTS).astype(np.float32)
    active = r.random(N_SEGMENTS) < 0.35
    active[:100] = False
    return [torch.tensor(x) for x in (o, d, maxt, active)]


@pytest.mark.parametrize("group", [1, 8, 32])
@pytest.mark.parametrize("vacuum", [False, True], ids=["shadow", "vacuum"])
def test_emulated_anyhit_matches_plain(emulated, complex_scene, vacuum,
                                       group):
    scene = complex_scene[2]
    o, d, maxt, active = _segments(scene)
    before = ops.LAUNCHES["anyhit_kernel"]
    got = ps.prepare_anyhit(scene, o, d, maxt, active, vacuum, block=BLOCK,
                            group=group)()[0]
    assert ops.LAUNCHES["anyhit_kernel"] == before + 1
    want = ps.anyhit_plain(scene, o, d, maxt, active, vacuum, tile=1)
    assert torch.equal(got, want)
    assert not got[~active].any()
    assert 0.1 < float(got[active].float().mean()) < 0.9
    if vacuum:   # the light blocks some shadow segments, no vacuum one
        shadow = ps.anyhit_plain(scene, o, d, maxt, active, tile=1)
        assert bool((got <= shadow).all())


def _nearest(scene, o, d, alive, group=None):
    """``nearest_kernel``'s outputs in `nearest_tiles`' form."""
    t, hit_id, attrs, refl = ps.prepare_nearest(scene, o, d, alive,
                                                block=BLOCK, group=group)()
    return (t < 1e20, t, hit_id, attrs[0:3].T, attrs[3:6].T, attrs[6:9].T,
            refl)


def test_emulated_nearest_matches_plain(emulated, complex_scene):
    scene = complex_scene[2]
    o, d, _, alive = _segments(scene)
    alive[300:400] = False      # a dead stretch in a live block
    before = ops.LAUNCHES["nearest_kernel"]
    got = _nearest(scene, o, d, alive)
    assert ops.LAUNCHES["nearest_kernel"] == before + 1
    want = ps.nearest_plain(scene, o, d, alive, tile=1)
    for k, (a, b) in enumerate(zip(got, want)):
        if k != 1:
            assert torch.equal(a, b), k
    # t: PyTorch's CPU kernels round the plain version's b * b - |op|^2 +
    # r^2 otherwise than IEEE single in sequence, which the emulated kernel
    # and the card both do (numpy float32 in sequence gives the emulated
    # bits); on the ground sphere of radius 1e4 the cancellation leaves a
    # few ulps of the scene's scale. On the card chip_smoke.py holds t bit
    # for bit.
    scale = float(scene.p.abs().max() + scene.rad.max())
    torch.testing.assert_close(got[1], want[1], rtol=2e-5,
                               atol=4 * float(np.spacing(np.float32(scale))))
    assert float(got[0][alive].float().mean()) > 0.3
    assert not got[0][~alive].any() and bool((got[1][~alive] == 1e20).all())


@pytest.mark.parametrize("group", [1, 4, 8, 32])
def test_emulated_nearest_groups_same_bits(emulated, complex_scene, group):
    """Every G gives the default G's bits on every lane, and a ragged
    prefix of the lanes the full launch's."""
    scene = complex_scene[2]
    o, d, _, alive = _segments(scene)
    assert ps.group_size(scene.num_spheres, ps.PER_LANE) == 16
    want = _nearest(scene, o, d, alive)
    got = _nearest(scene, o, d, alive, group)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    m = N_SEGMENTS - 13
    ragged = _nearest(scene, o[:m], d[:m], alive[:m], group)
    assert all(torch.equal(a, b[:m]) for a, b in zip(ragged, want))


def _facts_mismatch(a, b):
    """Over the occlusion entries either side consumed (not blocked)."""
    used = ~a | ~b
    return float((a != b)[used].float().mean()) if bool(used.any()) else 0.0


@pytest.mark.parametrize("impl", [None, "threefry"], ids=["mix32",
                                                          "threefry"])
def test_emulated_bounce_and_facts_match_plain(emulated, complex_scene,
                                               impl):
    orig, target, scene = complex_scene
    n = W * H
    cam = Camera.make(orig, target, W, H, device="cpu")
    li = static_light_indices(scene)
    cfg = IntegratorConfig()
    key = rng.make_key(0, impl)
    vpls = light_tracer.trace_light_paths(scene, cfg, li, key, 0)
    rays = progressive.frame_rays(cam, cfg, W, H, key, 0)
    calls = {(entry, g): pb.prepare_bounce(
        scene, cfg, li, key, 0, vpls, 0, n, entry=entry, block=BLOCK,
        group=g) for entry in ("bounce_kernel", "aux_kernel")
        for g in GROUPS}
    planes = pb.state_planes(rays)
    live = []
    for depth in range(cfg.max_depth):
        want, (hit_p, occ_l_p, occ_v_p, *_) = pb.bounce_plain(
            scene, cfg, li, planes, key, 0, depth, vpls, 0, collect=True)
        got = {}
        for (entry, g), call in calls.items():
            p = planes.clone()
            facts = ()
            if entry == "aux_kernel":
                facts = (torch.empty((n,), dtype=torch.int32),
                         torch.empty((len(li), n), dtype=torch.bool),
                         torch.empty((call.tables[1].shape[0], n),
                                     dtype=torch.bool))
                call.launch(p, depth, tuple(f.data_ptr() for f in facts))
            else:
                call.launch(p, depth)
            got[entry, g] = (p,) + facts
        for (entry, g), outs in got.items():
            ref = got[entry, 1]
            assert all(torch.equal(a, b) for a, b in zip(outs, ref)), (
                depth, entry, g)
        ref = got["bounce_kernel", 1][0]
        assert torch.equal(ref, got["aux_kernel", 1][0])
        assert_protocol(ref[6:9].T.numpy(), want[6:9].T.numpy())
        hit_k, occ_l_k, occ_v_k = got["aux_kernel", 1][1:]
        assert float((hit_k != hit_p).float().mean()) <= MAX_BAD_FRAC
        assert _facts_mismatch(occ_l_k.T, occ_l_p) <= MAX_BAD_FRAC
        assert _facts_mismatch(occ_v_k.T, occ_v_p) <= MAX_BAD_FRAC
        live.append(float((planes[13] > 0.5).float().mean()))
        planes = want
    assert live[0] == 1.0 and live[-1] < 0.5


def _tie_scene(scene):
    """complex.scn with a far speck and then a copy of its sphere 2
    (radius 15 at the origin) appended: every hit on sphere 2 ties in t
    with the copy, which sits in lane 0 of a group of 8 and lane 16 of a
    group of 32, below sphere 2's lane or across the first shuffle from
    it."""
    speck = {"rad": [0.01], "p": [[0.0, -1e5, 0.0]], "e": [[0.0] * 3],
             "c": [[0.5] * 3], "refl": [0]}

    def cat(a, name):
        extra = torch.tensor(speck[name], dtype=a.dtype)
        return torch.cat([a, extra, a[2:3]])

    return scene.replace(**{k: cat(getattr(scene, k), k) for k in speck})


def test_emulated_group_nearest_keeps_the_lowest_index_on_ties(
        emulated, complex_scene):
    """On the tie scene the fact kernel's group must keep sphere 2, as
    the serial scan does."""
    orig, target, scene = complex_scene
    scene = _tie_scene(scene)
    n = W * H
    cam = Camera.make(orig, target, W, H, device="cpu")
    li = static_light_indices(scene)
    cfg = IntegratorConfig()
    key = rng.make_key(0)
    vpls = light_tracer.trace_light_paths(scene, cfg, li, key, 0)
    rays = progressive.frame_rays(cam, cfg, W, H, key, 0)
    planes = pb.state_planes(rays)
    hits = {}
    for g in (1, 8, 32):
        call = pb.prepare_bounce(scene, cfg, li, key, 0, vpls, 0, n,
                                 entry="aux_kernel", block=BLOCK,
                                 group=g)
        hit = torch.empty((n,), dtype=torch.int32)
        occ_l = torch.empty((len(li), n), dtype=torch.bool)
        occ_v = torch.empty((call.tables[1].shape[0], n), dtype=torch.bool)
        call.launch(planes.clone(), 0, (hit.data_ptr(), occ_l.data_ptr(),
                                        occ_v.data_ptr()))
        hits[g] = hit
    copy = scene.num_spheres - 1
    assert int((hits[1] == 2).sum()) > 0 and not bool((hits[1] == copy).any())
    assert torch.equal(hits[8], hits[1]) and torch.equal(hits[32], hits[1])


def test_emulated_nearest_kernel_keeps_the_lowest_index_on_ties(
        emulated, complex_scene):
    """On the tie scene ``nearest_kernel`` keeps sphere 2 at every G, as
    the serial scan does, on the camera's rays."""
    orig, target, scene = complex_scene
    scene = _tie_scene(scene)
    cam = Camera.make(orig, target, W, H, device="cpu")
    cfg = IntegratorConfig()
    rays = progressive.frame_rays(cam, cfg, W, H, rng.make_key(0), 0)
    alive = torch.ones((W * H,), dtype=torch.bool)
    ids = {g: _nearest(scene, rays.o, rays.d, alive, g)[2]
           for g in (1, 8, 32)}
    copy = scene.num_spheres - 1
    assert int((ids[1] == 2).sum()) > 0 and not bool((ids[1] == copy).any())
    assert torch.equal(ids[8], ids[1]) and torch.equal(ids[32], ids[1])
