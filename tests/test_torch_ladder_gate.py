"""The port's config ladder (tools/torch_ladder.py) against the JAX
package's (tools/ladder.py).

- The rungs, the heads' tape prefix and the cell size are JAX's.
- `evaluate_rung` gives JAX's verdict and readings, bit for bit, on
  tests/test_ladder_gate.py's cases: the parity regime passes; brightness,
  structural and non-finite regressions fail.
- `evaluate_inverse_rung` gives JAX's verdict: a recovery passes, each
  kind of non-recovery fails; the inverse rung's scene is JAX's.
- One rung's render leg (cornell_mirror.scn, the default config and
  tape) at 16x12, 4 passes, on the CPU against JAX's
  `Renderer(backend="xla")` run op by op, under the radiance protocol
  (tests/test_pallas.py); and a whole rung through ``main`` on the CPU.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from gpu_bidirectional_raytracer_tpu.core.types import IntegratorConfig as JConfig
from gpu_bidirectional_raytracer_tpu.render import progressive as jprog
from gpu_bidirectional_raytracer_tpu.scene import parser as jparser
from torch_parity import assert_protocol, scn

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import ladder as jl  # noqa: E402
import torch_ladder as tl  # noqa: E402


def _fake_pair(seed=0, h=64, w=64):
    """tests/test_ladder_gate.py's pair: float drift and two flips."""
    rng = np.random.default_rng(seed)
    ref = rng.uniform(0.05, 1.0, (h, w, 3)).astype(np.float32)
    head = ref * (1 + rng.normal(0, 1e-6, ref.shape).astype(np.float32))
    head[3, 7] = ref[3, 7] * 1.5
    head[40, 22] = 0.0
    return head, ref


def _case(case):
    """``(full, head, ref, the check that must fail or None)``."""
    head, ref = _fake_pair()
    if case == "parity":
        return head, head, ref, None
    if case == "brightness":
        return head, head * 1.1, ref, "global_mean<=1%"
    if case == "structural":
        shuffled = ref[np.random.default_rng(1).permutation(ref.shape[0])]
        return head, shuffled, ref, "ncc>=0.999"
    bad = head.copy()
    bad[0, 0, 0] = np.nan
    return bad, head, ref, "finite"


def _same(a, b):
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_rungs_are_jax_rungs():
    assert tl.RUNGS == jl.RUNGS
    assert ((tl.REF_DIV, tl.REF_MIN, tl.REF_MAX, tl.CELL)
            == (jl.REF_DIV, jl.REF_MIN, jl.REF_MAX, jl.CELL))
    assert ((tl._INV_POS_OFF, tl._INV_RAD_OFF, tl._INV_ALB_OFF)
            == (jl._INV_POS_OFF, jl._INV_RAD_OFF, jl._INV_ALB_OFF))


@pytest.mark.parametrize("case", ["parity", "brightness", "structural",
                                  "non_finite"])
def test_evaluate_rung_matches_jax(case):
    full, head, ref, failing = _case(case)
    got = tl.evaluate_rung(full, head, ref)
    _same(got, jl.evaluate_rung(full, head, ref))
    res, ok = got
    assert ok == (failing is None), res["checks"]
    if failing:
        assert not res["checks"][failing]


GOOD = {"loss_start": 2.0, "loss_final": 0.05, "pos_err_final": 0.6,
        "rad_err_final": 0.1, "albedo_err_final": 0.05}


@pytest.mark.parametrize("field,value,check", [
    (None, None, None),
    ("loss_final", 1.5, "loss_reduced"),
    ("pos_err_final", 3.0, "pos_err<=1.2"),
    ("rad_err_final", 2.0, "rad_err<=0.6"),
    ("albedo_err_final", 0.3, "albedo_err<=0.10"),
    ("loss_final", float("nan"), "finite"),
])
def test_evaluate_inverse_rung_matches_jax(field, value, check):
    res = dict(GOOD)
    if field:
        res[field] = value
    got = tl.evaluate_inverse_rung(dict(res))
    _same(got, jl.evaluate_inverse_rung(dict(res)))
    assert got[1] == (check is None)
    if check:
        assert not got[0]["checks"][check]


def test_inverse_scene_is_jax_scene():
    js = jl._inverse_scene()
    ts = tl.inverse_scene("cpu")
    for f in ("rad", "p", "e", "c", "refl"):
        assert np.array_equal(getattr(ts, f).numpy(),
                              np.asarray(getattr(js, f))), f


def test_rung_render_leg_matches_jax():
    """cornell_mirror.scn (the mirror rung's scene) at 16x12, 4 passes of
    `IntegratorConfig()` on the mix32 tape of seed 0, as run_rung renders
    its legs: the port's card leg (``"auto"``, the plain tracer on the
    CPU) and its CPU reference leg (``"xla"``) against JAX's op-by-op
    renderer (jitted JAX differs from it on VPL knife edges at this size;
    tests/test_torch_northstar_gate.py)."""
    w, h, spp = 16, 12, 4
    o, t, js = jparser.load_scene(scn("cornell_mirror.scn"))
    jr = jprog.Renderer(js, o, t, w, h, cfg=JConfig(), backend="xla")
    with jax.disable_jit():
        ref = np.asarray(jr.render(spp))
    legs = [tl.render_leg("cornell_mirror.scn", w, h, spp, "cpu", backend)
            for backend in ("auto", "xla")]
    for img, info in legs:
        assert info["backend"] == "xla" and info["spp"] == spp
        assert info["launches"] == dict.fromkeys(tl.COUNTED, 0)
        assert_protocol(img.reshape(-1, 3), ref.reshape(-1, 3))
    assert np.array_equal(legs[0][0], legs[1][0])


def test_main_runs_a_rung_on_the_cpu(tmp_path, capsys):
    """``--device cpu``: every leg on the CPU (so the heads agree bit for
    bit), the JSON and the rung's image written, exit 0."""
    assert tl.main(["--rung", "simple", "--scale", "4", "--device", "cpu",
                    "--out-dir", str(tmp_path)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    res = line["simple"]
    assert res["passed"] and res["spp"] == 4 and res["ref_spp"] == 4
    assert res["ncc_cells"] == 1.0 and res["mean_rel_cell_err"] == 0.0
    with open(tmp_path / "TORCH_LADDER.json") as f:
        assert json.load(f)["simple"]["checks"] == res["checks"]
    assert any(p.name.startswith("torch_ladder_simple.")
               for p in tmp_path.iterdir())
