"""The port's north-star tool (tools/torch_northstar.py) against the JAX
package's (tools/northstar.py).

- Its `evaluate_gate` gives JAX's verdict and readings, bit for bit, on
  tests/test_northstar_gate.py's cases for both families: the committed
  TPU renders pass against the CPU renders; brightness, constant,
  structural and non-finite regressions fail; an image against itself is
  clean.
- `compare` holds an image to the family's committed CPU render, and
  refuses another size; `main --leg compare` exits 1 when the gate
  fails.
- The render leg of each family at 16x12, 4 passes, on the CPU against
  JAX's `Renderer(backend="xla")` with the family's config and tape, run
  op by op (``jax.disable_jit``), under the radiance protocol
  (tests/test_pallas.py). Jitted JAX is no reference for the VPL family
  at this size: it differs from its own op-by-op run on 2.6-3.6% of the
  pixels after 1-4 passes (knife edges of the shadow rays to VPLs on the
  1e4-radius walls), and from the port on 4.2% after 4 passes, where the
  port differs from op-by-op JAX on 1.0-1.6%.
"""

import importlib.util
import json
import os

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
ART = os.path.join(REPO, "artifacts")


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jns = _load("northstar", "northstar.py")
tns = _load("torch_northstar", "torch_northstar.py")

# family -> (the JAX TPU render, the JAX CPU render)
LEGS = {"golden": ("northstar_tpu.npy", "northstar_cpu.npy"),
        "vpl": ("northstar_vpl_tpu.npy", "northstar_vpl_cpu.npy")}


@pytest.fixture(scope="module", params=sorted(LEGS))
def legs(request):
    tpu, cpu = LEGS[request.param]
    return (request.param, np.load(os.path.join(ART, tpu)),
            np.load(os.path.join(ART, cpu)))


def _same(a, b):
    """Two gates' (metrics, ok), compared as JSON (NaN included)."""
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def _regression(a, case):
    """tests/test_northstar_gate.py's regressions of image ``a``, and a
    non-finite pixel."""
    if case == "brightness":
        return a * 1.05
    if case == "constant":
        return a + 0.02
    if case == "structural":
        rng = np.random.default_rng(0)
        return a + rng.normal(0.0, 0.2, size=a.shape).astype(a.dtype)
    nan = a.copy()
    nan[7, 11, 1] = np.nan
    return nan


def test_families_are_the_jax_legs():
    """Config, tape and size of each family as tools/northstar.py renders
    them (render_leg, `--leg tpu` and `--leg vpl-tpu`)."""
    assert tns.FAMILIES["golden"][1:5] == ("threefry", 1024, 768, 1024)
    assert tns.FAMILIES["vpl"][1:5] == ("mix32", 512, 384, 256)
    assert (tns.family_config("golden").__dict__
            == JConfig.cpu_golden().__dict__)
    assert tns.family_config("vpl").__dict__ == JConfig().__dict__
    for family, (_, cpu) in LEGS.items():
        ref = tns.reference(family)
        _, _, w, h, _, name = tns.FAMILIES[family]
        assert name == cpu and ref.shape == (h, w, 3)


def test_committed_artifacts_pass(legs):
    _, a, b = legs
    got = tns.evaluate_gate(a, b)
    assert got[1], got[0]["checks"]
    _same(got, jns.evaluate_gate(a, b))


@pytest.mark.parametrize("case", ["brightness", "constant", "structural",
                                  "non_finite"])
def test_regressions_fail_as_in_jax(legs, case):
    _, a, b = legs
    bad = _regression(a, case)
    got = tns.evaluate_gate(bad, b)
    assert not got[1]
    _same(got, jns.evaluate_gate(bad, b))


def test_self_comparison_is_clean(legs):
    _, a, _ = legs
    metrics, ok = tns.evaluate_gate(a, a)
    assert ok
    assert metrics["offender_pixel_fraction"] == 0.0
    assert metrics["allclose_rtol_1e-3_atol_1e-4"]


def test_compare_holds_the_family_reference(legs):
    family, a, b = legs
    _same(tns.compare(a, family), jns.evaluate_gate(a, b))
    with pytest.raises(ValueError, match="full size"):
        tns.compare(a[:-1], family)


def test_main_compare_exit_codes(tmp_path, capsys):
    a = np.load(os.path.join(ART, LEGS["vpl"][0]))
    good, bad = tmp_path / "good.npy", tmp_path / "bad.npy"
    np.save(good, a)
    np.save(bad, a * 1.05)
    assert tns.main(["--family", "vpl", "--leg", "compare",
                     "--out", str(good)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["gate_passed"] and line["reference"] == LEGS["vpl"][1]
    assert tns.main(["--family", "vpl", "--leg", "compare",
                     "--out", str(bad)]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not line["gate_passed"]
    assert not line["checks"]["mean_abs<=0.5%_mean"]


@pytest.mark.parametrize("family", ["golden", "vpl"])
def test_render_leg_matches_jax(family):
    """The family's render at 16x12, 4 passes: the port's on the CPU (the
    plain tracer, as ``--backend xla``) against JAX's `Renderer` with
    ``backend="xla"`` and the same config, tape and seed, as
    tools/northstar.py's render_leg runs it, op by op."""
    w, h, spp = 16, 12, 4
    o, t, js = jparser.load_scene(scn("cornell.scn"))
    cfg = JConfig.cpu_golden() if family == "golden" else JConfig()
    jr = jprog.Renderer(js, o, t, w, h, cfg=cfg, backend="xla",
                        rng_impl=tns.FAMILIES[family][1])
    with jax.disable_jit():
        for _ in range(spp):
            jr.step()
    ref = np.asarray(jax.device_get(jr.state.colors))
    for backend in ("auto", "xla"):
        got, info = tns.render(family, device="cpu", backend=backend,
                               width=w, height=h, spp=spp)
        assert info["backend"] == "xla" and info["launches"] == {}
        assert got.shape == (h, w, 3)
        assert_protocol(got.reshape(-1, 3), ref.reshape(-1, 3))
