"""Where the adjoint kernels' time goes: timed probes built from copies of
``csrc/grad_kernel.cu``, and the SASS of the real build.

    python3 tools/probe_grad_kernel.py [--source FILE] [--size 512]
        [--reps 20] [--probes fwd_only,no_flush,lb5,lb6] [--out FILE]

Each probe is the source with a few textual edits, written with
``csrc/tracer.cuh`` under ``build/probe_grad_kernel/<probe>/`` and compiled
with the flags of ``ops/_build.py``; no probe reaches the shipped source.
A probe whose edits do not apply to ``--source`` is reported as not
applicable. The probes:

- ``fwd_only``: the forward sweep and the cotangent, with every field of
  the saved state read back into a per-thread sum that is written out;
  no reverse sweep (wrong gradients, timing only);
- ``no_flush``: the full kernel with every warp reduction of a table row
  replaced by a per-lane sum that keeps the row's values alive (wrong
  gradients, timing only);
- ``fwd_alone``: ``fwd_only`` with the reverse sweep compiled out, so
  the forward runs at its own registers;
- ``no_nee``, ``no_scatter``, ``no_chain``: the reverse sweep without its
  next-event adjoint, its scatter adjoint or its hit-point and root
  chain, for the registers each part holds (wrong gradients);
- ``lb5``, ``lb6``: ``__launch_bounds__(128, 5)`` and ``(128, 6)`` for
  every instantiation;
- ``block64``: blocks of 64 threads (the per-block partials sized to
  match);
- ``unroll2``, ``unroll3``: tracer.cuh's nearest-hit and any-hit loops
  over the spheres unrolled by 2 or 3 (same order, same results).

Each library's entry points are called through ctypes with the
arguments that ``ops/pallas_grad.py`` builds (cornell.scn at
``--size``², ``IntegratorConfig()``, sample 0 of the mix32 key of seed 0
with its VPLs; a seeded cotangent, a black target), carrier-off and with
``vis_grad_tau`` 2; the carrier instantiations also on
tests/test_pallas_grad.py's occluder scene (simple.scn plus a sphere of
radius 6 at (0, 40, 0)) with VPLs, where the carrier fires. Timing: CUDA
events over ``--reps`` launches, the real build and the probes in turns
(real, probes, probes reversed, real). For the real build it also counts
SASS opcodes per instantiation (``cuobjdump -sass``: SHFL, MUFU, LDL, STL,
LDS, STS, CALL and all instructions) and names the slow-path
subroutines it calls. Prints one JSON line (also written to ``--out``).
Needs a card and the CUDA toolkit; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PROBE_SINKS = """
// ---- probe: per-lane sinks in place of the warp reductions
template <int kCount, int kGapAt = kCount, int kGap = 0>
__device__ __forceinline__ void probe_sink_row(float* row, const float* g) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kCount; ++i) s += g[i];
  if (s == 1.0e-37f) row[threadIdx.x & 15] += s;
}
template <int kCount, int kGapAt = kCount, int kGap = 0>
__device__ __forceinline__ void probe_sink_by_id(float* tab, bool act, int id,
                                                 const float* g) {
  if (act) probe_sink_row<kCount>(tab + id * kCols, g);
}
"""

FWD_SINK_HEAD = """
  if (p.n >= 0) {   // probe: the forward sweep alone
    float sink = cot[0] + cot[1] + cot[2];
"""
# The saved state read back: an array of `Saved` structs, or of packed
# words at a stride of `stride` a depth.
FWD_READ_STRUCTS = """    for (int k = 0; k < n_saved; ++k) {
      const Saved& sv = saved[k];
      for (int i = 0; i < 3; ++i) sink += sv.o[i] + sv.d[i] + sv.tp[i];
      sink += static_cast<float>(sv.hit + sv.code + sv.specular);
      for (int w = 0; w < kLitWords; ++w) sink += static_cast<float>(sv.lit[w]);
    }
"""
FWD_READ_WORDS = """    for (int k = 0; k < n_saved * stride; ++k)
      sink += __uint_as_float(saved[k]);
"""
FWD_SINK_TAIL = """    if (valid && p.drays_o != nullptr) p.drays_o[3 * idx] = sink;
    if (valid && p.rad_out != nullptr) p.rad_out[3 * idx] = sink;
    if (kFused && threadIdx.x == 0) p.loss_part[blockIdx.x] = wloss[0];
    return;
  }
"""

# name -> alternatives, each a list of (regex, replacement, expected
# count); the first alternative whose every edit matches as expected is
# used, and a probe with none is not applicable.
PROBES = {
    "fwd_only": [
        [(r"Saved saved\[kMaxDepth\];", r"\g<0>", 1),
         (r"(\n  // ---- reverse sweep)",
          FWD_SINK_HEAD + FWD_READ_STRUCTS + FWD_SINK_TAIL + r"\1", 1)],
        [(r"uint32_t saved\[kMaxDepth \* \(kStateWords \+ kLitWords\)\];",
          r"\g<0>", 1),
         (r"(\n  // ---- reverse sweep)",
          FWD_SINK_HEAD + FWD_READ_WORDS + FWD_SINK_TAIL + r"\1", 1)]],
    "no_flush": [[
        (r"\ntemplate <bool kFused, bool kVis>\n__global__",
         PROBE_SINKS + r"\g<0>", 1),
        (r"\bflush_row<([\d, ]+)>\((tab|row)", r"probe_sink_row<\1>(\2",
         None),
        (r"\bflush_by_id<([\d, ]+)>\(tab", r"probe_sink_by_id<\1>(tab",
         None),
    ]],
    # The same sink with the reverse sweep compiled out: the forward sweep
    # at its own registers.
    "fwd_alone": [
        [(r"uint32_t saved\[kMaxDepth \* \(kStateWords \+ kLitWords\)\];",
          r"\g<0>", 1),
         (r"(\n  // ---- reverse sweep)",
          FWD_SINK_HEAD.replace("p.n >= 0", "true") + FWD_READ_WORDS
          + FWD_SINK_TAIL + r"\1", 1)]],
    # Parts of the reverse sweep compiled out, for their registers (wrong
    # gradients, timing only).
    "no_nee": [[(r"if \(__any_sync\(kFull, nee\)\) \{",
                 "if (false && __any_sync(kFull, nee)) {", 1)]],
    "no_scatter": [[(r"mul = scatter_adj\(sv\.glass, x, nd, bd, btp, bdk, bn, "
                     r"bnl\);", "mul = nd[0];", 1)]],
    "no_chain": [[(r"    if \(act\) \{\n      const float\* hs = x\.hs;\n"
                   r"      if \(nee\) \{",
                   "    if (false) {\n      const float* hs = x.hs;\n"
                   "      if (nee) {", 1)]],
    "lb5": [[(r"__launch_bounds__\(kBlock(, [^)]*)?\)",
              "__launch_bounds__(kBlock, 5)", 1)]],
    "lb6": [[(r"__launch_bounds__\(kBlock(, [^)]*)?\)",
              "__launch_bounds__(kBlock, 6)", 1)]],
    "block64": [[(r"constexpr int kBlock = 128;", "constexpr int kBlock = 64;",
                  1)]],
}
# Threads per block of a probe, where it is not the shipped 128.
PROBE_BLOCK = {"block64": 64}
# Probes that edit csrc/tracer.cuh (the copy beside the probe's source):
# the nearest-hit and any-hit loops over the spheres unrolled, which
# keeps their order and so their results.
HEADER_PROBES = {
    f"unroll{k}": [(r"#pragma unroll 1\n(  for \(int i = 0; i < T\.n_spheres; "
                    r"\+\+i\) \{)", rf"#pragma unroll {k}\n\1", 1),
                   (r"#pragma unroll 1\n(  for \(int s = 0; s < n_spheres; "
                    r"\+\+s\) \{)", rf"#pragma unroll {k}\n\1", 1)]
    for k in (2, 3)}

SASS_OPS = ("SHFL", "MUFU", "LDL", "STL", "LDS", "STS", "CALL", "BAR",
            "VOTE", "BSSY")


def _edit(text: str, edits) -> str | None:
    kernel_start = text.find("template <bool kFused, bool kVis>\n__global__")
    for pattern, repl, count in edits:
        head, body = ((text[:kernel_start], text[kernel_start:])
                      if "flush" in pattern and kernel_start >= 0
                      else ("", text))
        new, n = re.subn(pattern, repl, body)
        if n == 0 or (count is not None and n != count):
            return None
        text = head + new
        kernel_start = text.find(
            "template <bool kFused, bool kVis>\n__global__")
    return text


def _nvcc(src_dir: str, out: str) -> str:
    from gpu_bidirectional_raytracer_tpu_torch.ops import _build

    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
         os.path.join(src_dir, "grad_kernel.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed in {src_dir}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return proc.stdout + proc.stderr


def _ptxas(log: str) -> dict:
    out, entry = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '([^']+)'", ln)
        if m:
            entry = _inst_name(m.group(1))
            out[entry] = {}
            continue
        if entry is None:
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[entry]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                      r"stores, (\d+) bytes spill loads", ln)
        if m:
            out[entry].update(stack=int(m.group(1)),
                              spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
    return out


def _inst_name(mangled: str) -> str:
    m = re.search(r"ILb(\d)ELb(\d)E", mangled)
    if not m:
        return mangled
    return (("fused" if m.group(1) == "1" else "grad") + "_kernel"
            + ("_vis" if m.group(2) == "1" else ""))


def _sass(lib: str) -> dict:
    from gpu_bidirectional_raytracer_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        return {"error": proc.stderr.strip()[-400:]}
    out, name, body = {}, None, []

    def close():
        if name is None:
            return
        ops = [m.group(1) for ln in body
               for m in [re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                                   r"([A-Z][A-Z0-9_]*)", ln)] if m]
        counts = {op: sum(1 for o in ops if o == op) for op in SASS_OPS}
        counts["instructions"] = len(ops)
        counts["slow_paths"] = sorted({
            m.group(1) for ln in body
            for m in [re.search(r"(__cuda_sm\w+|__internal_\w+)", ln)] if m})
        out[_inst_name(name)] = counts

    for ln in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            close()
            name, body = m.group(1), []
        elif name is not None:
            body.append(ln)
    close()
    kernels = {k: v for k, v in out.items() if "kernel" in k}
    kernels["subroutines"] = sorted(k for k in out if "kernel" not in k)
    return kernels


def _inputs(size: int, scene_name: str):
    import dataclasses

    import torch

    from gpu_bidirectional_raytracer_tpu_torch import camera as cam_mod
    from gpu_bidirectional_raytracer_tpu_torch import rng
    from gpu_bidirectional_raytracer_tpu_torch.core.types import (
        Camera,
        IntegratorConfig,
    )
    from gpu_bidirectional_raytracer_tpu_torch.integrators import light_tracer
    from gpu_bidirectional_raytracer_tpu_torch.integrators.direct import (
        static_light_indices,
    )
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace as ops
    from gpu_bidirectional_raytracer_tpu_torch.scene.parser import load_scene

    dev = torch.device("cuda", 0)
    scenes = os.path.join(REPO, "assets", "scenes")
    orig, target, scene = load_scene(
        os.path.join(scenes, f"{scene_name}.scn"), device=dev)
    if scene_name == "simple":   # tests/test_pallas_grad.py's occluder
        row = lambda a, v: torch.cat(
            [a, torch.tensor([v], dtype=a.dtype, device=dev)])
        scene = scene.replace(rad=row(scene.rad, 6.0),
                              p=row(scene.p, [0.0, 40.0, 0.0]),
                              e=row(scene.e, [0.0, 0.0, 0.0]),
                              c=row(scene.c, [0.5, 0.5, 0.5]),
                              refl=row(scene.refl, 0))
    cfg = IntegratorConfig()
    n = size * size
    cam = Camera.make(orig, target, size, size, device=dev)
    li = static_light_indices(scene)
    key = rng.make_key(0)
    ju = rng.site_uniforms(key, 0, 0, rng.CAM_JITTER, 2, n, device=dev)
    px, py = cam_mod.pixel_grid(size, size, device=dev)
    rays = cam_mod.primary_rays(cam, size, size, ju[0], ju[1], px, py)
    vpls = light_tracer.trace_light_paths(scene, cfg, li, key, 0)
    tabs = ops.launch_tables(scene, cfg, li, key, 0, vpls, 0, n)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    cot = torch.rand((n, 3), generator=gen, device=dev) * 2.0 - 1.0
    return cfg, dataclasses.replace(cfg, vis_grad_tau=2.0), li, rays, tabs, cot


def _calls(lib, block: int, cases):
    """``{case/entry: fn}``: raw launches of ``lib`` on preallocated
    outputs."""
    import torch

    from gpu_bidirectional_raytracer_tpu_torch.ops import _build
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_grad as pg

    fns = {}
    for entry in ("grad_kernel", "fused_kernel"):
        f = getattr(lib, _build._ENTRIES[entry][1])
        f.argtypes = _build._ENTRIES[entry][2]
        f.restype = ctypes.c_int
        fns[entry] = f
    out = {}
    for case, (cfg, li, rays, tabs, cot) in cases.items():
        scene_tab, vpl_tab, tape = tabs
        n = rays.o.shape[0]
        n_blocks = (n + block - 1) // block
        dtab = torch.empty((n_blocks, scene_tab.shape[0], 16),
                           device=cot.device)
        dvpl = torch.empty((n_blocks, max(vpl_tab.shape[0], 1), 16),
                           device=cot.device)
        d_o = torch.empty((n, 3), device=cot.device)
        d_d = torch.empty((n, 3), device=cot.device)
        loss = torch.empty((n_blocks,), device=cot.device)
        black = torch.zeros((n, 3), device=cot.device)
        common = pg._common_args(scene_tab, vpl_tab, tape, len(li), rays.o,
                                 rays.d, n, cfg, 0, n)
        stream = torch.cuda.current_stream().cuda_stream
        g_args = common + (cot.data_ptr(), dtab.data_ptr(), dvpl.data_ptr(),
                           d_o.data_ptr(), d_d.data_ptr(), stream)
        f_args = common + (black.data_ptr(), 0, 1.0 / (3.0 * n),
                           dtab.data_ptr(), dvpl.data_ptr(), loss.data_ptr(),
                           None, stream)

        def call(f, args, keep=(dtab, dvpl, d_o, d_d, loss, black)):
            rc = f(*args)
            if rc != 0:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        out[f"{case}/grad_kernel"] = (lambda f=fns["grad_kernel"], a=g_args:
                                      call(f, a))
        out[f"{case}/fused_kernel"] = (lambda f=fns["fused_kernel"],
                                       a=f_args: call(f, a))
    return out


def _ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", default=os.path.join(
        REPO, "gpu_bidirectional_raytracer_tpu_torch", "csrc",
        "grad_kernel.cu"))
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--probes", default=",".join([*PROBES, *HEADER_PROBES]))
    ap.add_argument("--out", default=os.path.join(
        REPO, "build", "probe_grad_kernel", "result.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("probe_grad_kernel: no CUDA device", file=sys.stderr)
        return 1
    src = open(args.source).read()
    header = os.path.join(os.path.dirname(os.path.abspath(args.source)),
                          "tracer.cuh")
    root = os.path.join(REPO, "build", "probe_grad_kernel")
    shutil.rmtree(root, ignore_errors=True)
    libs, ptxas, skipped = {}, {}, []
    header_text = open(header).read()
    for name in ["real"] + args.probes.split(","):
        text, htext = src, header_text
        if name in HEADER_PROBES:
            htext = _edit(header_text, HEADER_PROBES[name])
        elif name != "real":
            text = next((t for t in (_edit(src, alt) for alt in PROBES[name])
                         if t is not None), None)
        if text is None or htext is None:
            skipped.append(name)
            continue
        d = os.path.join(root, name)
        os.makedirs(d)
        with open(os.path.join(d, "grad_kernel.cu"), "w") as f:
            f.write(text)
        with open(os.path.join(d, "tracer.cuh"), "w") as f:
            f.write(htext)
        lib = os.path.join(d, "libgrad.so")
        ptxas[name] = _ptxas(_nvcc(d, lib))
        libs[name] = lib
    sass = _sass(libs["real"])

    cfg, vis_cfg, li, rays, tabs, cot = _inputs(args.size, "cornell")
    ocfg, ovis_cfg, oli, orays, otabs, ocot = _inputs(args.size, "simple")
    cases = {"cornell": (cfg, li, rays, tabs, cot),
             "cornell_vis": (vis_cfg, li, rays, tabs, cot),
             "occluder_vis": (ovis_cfg, oli, orays, otabs, ocot)}
    calls = {name: _calls(ctypes.CDLL(lib), PROBE_BLOCK.get(name, 128), cases)
             for name, lib in libs.items()}
    probes = [k for k in libs if k != "real"]
    order = ["real"] + probes + probes[::-1] + ["real"]
    ms: dict = {name: {} for name in libs}
    for name in order:
        for key, fn in calls[name].items():
            ms[name].setdefault(key, []).append(_ms(fn, args.reps))
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    result = {"source": os.path.relpath(os.path.abspath(args.source), REPO),
              "size": [args.size, args.size], "nvidia_smi": smi.strip(),
              "reps": args.reps, "order": order, "ms": ms, "ptxas": ptxas,
              "sass": sass, "not_applicable": skipped}
    line = json.dumps(result)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
