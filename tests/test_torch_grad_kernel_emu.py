"""The adjoint kernels' CUDA source itself, run on the CPU by host
emulation, against autograd of the port's plain tracer.

``csrc/grad_kernel.cu`` is compiled as C++ with g++ (``-std=c++20
-ffp-contract=off``) against the shim in ``csrc/emu/`` (every CUDA thread
a fiber; shuffles, ballots, votes and ``__syncthreads`` as barriers of the
warp or block; dynamic shared memory per block). Only two things of the
source are rewritten: the ``<<<...>>>`` launch and the ``extern
__shared__`` line. The library's entry points are called through the
wrappers of ``ops/pallas_grad.py`` (`grad_launch`, `fused_launch`) on CPU
tensors, so the per-block partials and their sum are the wrappers' own.

Cases at 16x12 (two blocks, the second half empty), depth 7, mix32 key of
seed 0: cornell.scn with VPLs through the carrier-off ``grad_kernel`` and
``fused_kernel`` (l2 and log); tests/test_pallas_grad.py's occluder scene
(simple.scn plus a sphere of radius 6 at (0, 40, 0)) with VPLs through the
carrier instantiations (``vis_grad_tau`` 2), where the carrier moves the
occluder's gradient; and cornell.scn with twelve VPL slots (``max_vlp``
12), past the shared-memory budget of the per-lane VPL rows. Gates of
``chip_smoke.py``'s ``grad_vs_plain``: the loss within 1e-5 relative,
each gradient array within ``2e-3 |plain| + 2e-3 max|plain|`` with a
``_max_rel`` of at most 1e-3, the fused kernel's radiance under the
radiance protocol of tests/test_pallas.py against the plain tracer's, and
two launches the same bits. The host's ``expf``/``cosf``/``sinf`` may
differ from the card's by an ulp, so the radiance is not held bit for bit
here; on the card ``chip_smoke.py`` holds it so.

Skips when g++ is missing. About 20 s of one worker.
"""

import ctypes
import dataclasses
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gpu_bidirectional_raytracer_tpu_torch import camera as cam_mod
from gpu_bidirectional_raytracer_tpu_torch import rng
from gpu_bidirectional_raytracer_tpu_torch.core.types import (
    Camera,
    IntegratorConfig,
    Rays,
)
from gpu_bidirectional_raytracer_tpu_torch.integrators import (
    light_tracer,
    path_tracer,
)
from gpu_bidirectional_raytracer_tpu_torch.integrators.direct import (
    static_light_indices,
)
from gpu_bidirectional_raytracer_tpu_torch.ops import _build
from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_grad as pg
from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace as ops
from gpu_bidirectional_raytracer_tpu_torch.scene.parser import load_scene

from torch_parity import assert_protocol, scn

W, H = 16, 12
GRAD_RTOL, GRAD_ATOL_REL, LOSS_RTOL, GRAD_MAX_REL = 2e-3, 2e-3, 1e-5, 1e-3
VIS_TAU = 2.0
MIN_SAME_LANES = 0.7   # lanes whose emulated radiance is the plain's bits


def _emulated_source(text: str) -> str:
    text, n_launch = re.subn(
        r"([\w:]+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\s*\((.*?)\);",
        r"emu::launch(\1, \2, \3);", text, flags=re.S)
    text, n_smem = re.subn(
        r"extern __shared__ (?:__align__\(\d+\) )?(\w+) (\w+)\[\];",
        r"\1* \2 = reinterpret_cast<\1*>(emu::dynamic_smem());", text)
    assert n_launch >= 1 and n_smem >= 1, (n_launch, n_smem)
    return text


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    """The adjoint kernels' source built for the host."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host emulation of "
                    "csrc/grad_kernel.cu needs a C++ compiler")
    out = tmp_path_factory.mktemp("grad_emu")
    src = out / "grad_kernel.cpp"
    src.write_text(_emulated_source(
        _build.SOURCES["grad_kernel"].read_text()))
    lib = out / "libgrad_emu.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-w", "-I", str(_build.CSRC_DIR / "emu"), "-I",
         str(_build.CSRC_DIR), "-o", str(lib), str(src)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return ctypes.CDLL(str(lib))


@pytest.fixture
def emulated(emu_lib, monkeypatch):
    """`pallas_grad`'s wrappers launching the emulated entry points."""

    def fn(entry):
        _, name, argtypes = _build._ENTRIES[entry]
        f = getattr(emu_lib, name)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        return f

    monkeypatch.setattr(pg, "_fn", fn)
    monkeypatch.setattr(pg, "_stream", lambda dev: None)


def _occluder_scene():
    orig, target, base = load_scene(scn("simple.scn"), device="cpu")

    def cat(a, row):
        return torch.cat([a, torch.tensor([row], dtype=a.dtype)])

    return orig, target, base.replace(
        rad=torch.cat([base.rad, torch.tensor([6.0])]),
        p=cat(base.p, [0.0, 40.0, 0.0]), e=cat(base.e, [0.0, 0.0, 0.0]),
        c=cat(base.c, [0.5, 0.5, 0.5]), refl=cat(base.refl, 0))


def _setup(scene_name: str, cfg: IntegratorConfig):
    if scene_name == "occluder":
        orig, target, scene = _occluder_scene()
    else:
        orig, target, scene = load_scene(scn(f"{scene_name}.scn"),
                                         device="cpu")
    n = W * H
    cam = Camera.make(orig, target, W, H, device="cpu")
    li = static_light_indices(scene)
    key = rng.make_key(0)
    ju = rng.site_uniforms(key, 0, 0, rng.CAM_JITTER, 2, n, device="cpu")
    px, py = cam_mod.pixel_grid(W, H, device="cpu")
    rays = cam_mod.primary_rays(cam, W, H, ju[0], ju[1], px, py)
    vpls = light_tracer.trace_light_paths(scene, cfg, li, key, 0)
    g = np.random.default_rng(7)
    cot = torch.tensor(g.uniform(-1.0, 1.0, (n, 3)), dtype=torch.float32)
    tgt = torch.tensor(g.uniform(0.0, 0.5, (n, 3)), dtype=torch.float32)
    return scene, li, key, rays, vpls, cot, tgt


def _grad_check(name, got, ref):
    """``chip_smoke.py``'s gate of one gradient array."""
    got, ref = got.detach().double(), ref.detach().double()
    assert got.shape == ref.shape and bool(torch.isfinite(got).all()), name
    err = (got - ref).abs()
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    assert bool((err <= GRAD_RTOL * ref.abs()
                 + GRAD_ATOL_REL * scale).all()), (name, float(err.max()),
                                                   scale)
    big = ref.abs() > 1e-3 * max(scale, 1e-9)
    rel = (err / ref.abs().clamp(min=1e-6))[big]
    assert rel.numel() == 0 or float(rel.max()) <= GRAD_MAX_REL, (
        name, float(rel.max()))


def _kernel_grads(scene, cfg, li, key, rays, vpls, cot, tgt, loss):
    """The emulated kernel's radiance (fused) or None, loss (fused) or
    None, and gradients of the scene's fields, the VPL buffer and (grad
    kernel) the rays, pulled through the tables as the wrappers' callers
    do; and the raw launch outputs."""
    n = rays.o.shape[0]
    with torch.enable_grad():
        sc, vb, sl, vl = pg.param_leaves(scene, vpls)
        # ops.launch_tables's tables, which it builds only on the card.
        scene_tab = ops._scene_table(sc)
        vpl_tab = ops._vpl_table(cfg, vb, 0, sc.device)
    tape = ops.tape_table(cfg, li, key, 0, False, n, sc.device)
    rad = value = None
    if loss is None:
        raw = pg.grad_launch(scene_tab.detach(), vpl_tab.detach(), tape, cfg,
                             li, rays, cot)
        dtab, dvpl, d_o, d_d = raw
        extra = [d_o, d_d]
    else:
        rad = torch.empty((n, 3), dtype=torch.float32)
        tk = torch.log1p(tgt) if loss == "log" else tgt
        raw = pg.fused_launch(scene_tab.detach(), vpl_tab.detach(), tape,
                              cfg, li, rays, tk, loss, radiance_out=rad)
        value, dtab, dvpl = raw
        extra = []
    grads = torch.autograd.grad([scene_tab, vpl_tab], sl + vl, [dtab, dvpl],
                                allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, sl + vl)]
    return rad, value, list(grads) + extra, raw


def _plain_grads(scene, cfg, li, key, rays, vpls, cot, tgt, loss):
    with torch.enable_grad():
        sc, vb, sl, vl = pg.param_leaves(scene, vpls)
        o = rays.o.detach().clone().requires_grad_()
        d = rays.d.detach().clone().requires_grad_()
        rad = path_tracer.trace(sc, cfg, li, Rays(o=o, d=d), key, 0,
                                vpls=vb, vlp_index=0)
        if loss is None:
            value = (rad * cot).sum()
            leaves = sl + vl + [o, d]
        else:
            value = pg.LOSSES[loss](rad, tgt)
            leaves = sl + vl
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, leaves)]
    return rad.detach(), value.detach(), grads


NAMES = ("p", "rad", "e", "c", "vpl_hp", "vpl_rad", "vpl_nl", "ray_o",
         "ray_d")


def _masked(scene, cfg, li, key, rays, vpls, cot, tgt):
    """The cotangent and the two targets with the lanes whose emulated
    radiance is not the plain tracer's bit for bit taken out: there the
    cotangent is 0 and each side's target is its own radiance, so those
    lanes add nothing on either side. The host's cosf/sinf differ from
    PyTorch's CPU ones by an ulp on some inputs, which on cornell.scn's
    1e4-radius walls turns some paths (on the card both use the same cosf
    and the radiance is bit for bit)."""
    rad_k = _kernel_grads(scene, dataclasses.replace(cfg, vis_grad_tau=0.0),
                          li, key, rays, vpls, cot, tgt, "l2")[0]
    with torch.no_grad():
        rad_p = path_tracer.trace(scene, cfg, li, rays, key, 0, vpls=vpls,
                                  vlp_index=0)
    assert_protocol(rad_k.numpy(), rad_p.numpy())
    same = (rad_k == rad_p).all(dim=-1, keepdim=True)
    assert float(same.float().mean()) >= MIN_SAME_LANES
    return (cot * same, torch.where(same, tgt, rad_k),
            torch.where(same, tgt, rad_p))


@pytest.mark.parametrize("scene_name,vis_tau,max_vlp,loss", [
    ("cornell", 0.0, 1, None),
    ("cornell", 0.0, 1, "l2"),
    ("cornell", 0.0, 1, "log"),
    ("occluder", VIS_TAU, 1, None),
    ("occluder", VIS_TAU, 1, "l2"),
    ("cornell", 0.0, 12, None),
], ids=["cornell_grad", "cornell_fused_l2", "cornell_fused_log",
        "occluder_grad_vis", "occluder_fused_vis", "cornell_vpl12_grad"])
def test_emulated_kernel_matches_plain_autograd(emulated, scene_name,
                                                vis_tau, max_vlp, loss):
    cfg = IntegratorConfig(vis_grad_tau=vis_tau, max_vlp=max_vlp)
    scene, li, key, rays, vpls, cot, tgt = _setup(scene_name, cfg)
    cot, tgt_k, tgt_p = _masked(scene, cfg, li, key, rays, vpls, cot, tgt)
    entry = ("grad_kernel" if loss is None else "fused_kernel") + (
        "_vis" if vis_tau > 0 else "")
    before = ops.LAUNCHES[entry]
    rad_k, value_k, g_k, first = _kernel_grads(scene, cfg, li, key, rays,
                                               vpls, cot, tgt_k, loss)
    assert ops.LAUNCHES[entry] == before + 1
    rad_p, value_p, g_p = _plain_grads(scene, cfg, li, key, rays, vpls, cot,
                                       tgt_p, loss)
    if loss is not None:
        assert abs(float(value_k) - float(value_p)) <= LOSS_RTOL * abs(
            float(value_p)), (float(value_k), float(value_p))
        assert_protocol(rad_k.numpy(), rad_p.numpy())
    for name, a, b in zip(NAMES, g_k, g_p):
        _grad_check(name, a, b)
    if scene_name == "occluder":   # the carrier moves the occluder's p
        off = dataclasses.replace(cfg, vis_grad_tau=0.0)
        g_off = _kernel_grads(scene, off, li, key, rays, vpls, cot, tgt_k,
                              loss)[2]
        moved = (g_k[0][-1] - g_off[0][-1]).abs().max()
        assert float(moved) > GRAD_MAX_REL * float(g_k[0][-1].abs().max())
    second = _kernel_grads(scene, cfg, li, key, rays, vpls, cot, tgt_k,
                           loss)[3]
    assert all(torch.equal(a, b) for a, b in zip(first, second))
