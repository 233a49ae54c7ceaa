"""The eye-path kernel's CUDA source run on the CPU by host emulation,
against the port's plain versions.

``csrc/trace_kernel.cu`` is compiled as C++ with g++ (``-std=c++20
-ffp-contract=off``) against the shim in ``csrc/emu/`` (every CUDA thread
a fiber, ``__syncthreads`` a barrier of the block, dynamic shared memory
per block); only the ``<<<...>>>`` launch and the ``extern __shared__``
line are rewritten. The launches go through the real wrappers
(`pallas_trace.prepare_camera_launch`, `prepare_launch`) on CPU tensors,
with ``_build.load`` patched to the emulated library.

Cases on cornell.scn at 16x12, sample 1, depth 7: the default config
(VPLs, (direct + vpl) / 2) and the CPU-golden gains with 3x3 stratified
jitter; the mix32 key (the tape regenerated in the kernel) and the
threefry key (the tape streamed); camera mode against
``trace_camera_plain``, ray mode on the whole frame and on a window of
lanes (``lane_offset`` 40 of 192) against ``path_tracer.trace``. Each
under the radiance protocol of tests/test_pallas.py, with at least 70% of
the pixels bit for bit: the host's ``cosf``/``sinf`` may differ from
PyTorch's by an ulp, which turns a few paths on the 1e4-radius walls (on
the card ``chip_smoke.py`` holds the kernel bit for bit). Two launches
give the same bits.

Skips when g++ is missing. About 10 s of one worker.
"""

import ctypes
import dataclasses
import shutil
import subprocess

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
from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace as ops
from gpu_bidirectional_raytracer_tpu_torch.scene.parser import load_scene

from test_torch_grad_kernel_emu import _emulated_source
from torch_parity import assert_protocol, scn

W, H, SAMPLE = 16, 12, 1
WINDOW = (40, 100)        # ray mode on lanes [40, 140) of the frame
MIN_SAME_LANES = 0.7      # pixels whose emulated radiance is the plain's bits
CONFIGS = {
    "default": IntegratorConfig(),
    "golden_stratified": dataclasses.replace(IntegratorConfig.cpu_golden(),
                                             stratify=3),
}


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    """The eye-path kernel's source built for the host."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host emulation of "
                    "csrc/trace_kernel.cu needs a C++ compiler")
    out = tmp_path_factory.mktemp("trace_emu")
    src = out / "trace_kernel.cpp"
    src.write_text(_emulated_source(
        _build.SOURCES["trace_kernel"].read_text()))
    lib = out / "libtrace_emu.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-w", "-I", str(_build.CSRC_DIR / "emu"), "-I",
         str(_build.CSRC_DIR), "-o", str(lib), str(src)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return ctypes.CDLL(str(lib))


@pytest.fixture
def emulated(emu_lib, monkeypatch):
    """`pallas_trace`'s wrappers launching the emulated entry point."""

    def load(entry):
        _, name, argtypes = _build._ENTRIES[entry]
        f = getattr(emu_lib, name)
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


def _twice(launch):
    before = ops.LAUNCHES["trace_kernel"]
    a = launch().clone()
    b = launch()
    assert ops.LAUNCHES["trace_kernel"] == before + 2
    assert torch.equal(a, b)
    return a


@pytest.mark.parametrize("mode", ["camera", "ray", "window"])
@pytest.mark.parametrize("impl", [None, "threefry"], ids=["mix32",
                                                          "threefry"])
@pytest.mark.parametrize("cname", sorted(CONFIGS))
def test_emulated_trace_kernel_matches_plain(emulated, cname, impl, mode):
    orig, target, scene = load_scene(scn("cornell.scn"), device="cpu")
    cfg = CONFIGS[cname]
    n = W * H
    cam = Camera.make(orig, target, W, H, device="cpu")
    li = static_light_indices(scene)
    key = rng.make_key(0, impl)
    vpls = (light_tracer.trace_light_paths(scene, cfg, li, key, SAMPLE)
            if cfg.use_vpl else None)
    kw = dict(vpls=vpls, vlp_index=0)
    if mode == "camera":
        got = _twice(ops.prepare_camera_launch(scene, cfg, li, cam, W, H,
                                               key, SAMPLE, **kw))
        ref = ops.trace_camera_plain(scene, cfg, li, cam, W, H, key, SAMPLE,
                                     **kw)
    else:
        ju = rng.site_uniforms(key, SAMPLE, 0, rng.CAM_JITTER, 2, n,
                               device="cpu")
        px, py = cam_mod.pixel_grid(W, H, device="cpu")
        rays = cam_mod.primary_rays(cam, W, H, ju[0], ju[1], px, py)
        lo, m = WINDOW if mode == "window" else (0, n)
        rays = Rays(o=rays.o[lo:lo + m].contiguous(),
                    d=rays.d[lo:lo + m].contiguous())
        got = _twice(ops.prepare_launch(scene, cfg, li, key, SAMPLE,
                                        vpls, 0, m, rays=rays,
                                        lane_offset=lo, lane_total=n))
        ref = path_tracer.trace(scene, cfg, li, rays, key, SAMPLE, **kw,
                                lane_offset=lo, lane_total=n)
    assert got.shape == ref.shape
    assert_protocol(got.numpy(), ref.numpy())
    same = float((got == ref).all(dim=-1).float().mean())
    assert same >= MIN_SAME_LANES, same
    assert float(got.mean()) > 0.0
