"""The port's utils against the JAX package's: checkpoint and resume
(bit for bit, the latest two steps kept, a resume under another tape
refused with JAX's message and exit code), the numerical-health checks,
the throughput meter's line and the profiler trace."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_bidirectional_raytracer_tpu.utils import debug as jdebug
from gpu_bidirectional_raytracer_tpu.utils.profiling import (
    ThroughputMeter as JMeter,
)
from gpu_bidirectional_raytracer_tpu_torch import cli
from gpu_bidirectional_raytracer_tpu_torch import rng
from gpu_bidirectional_raytracer_tpu_torch.core.types import IntegratorConfig
from gpu_bidirectional_raytracer_tpu_torch.render import progressive
from gpu_bidirectional_raytracer_tpu_torch.scene import builtin
from gpu_bidirectional_raytracer_tpu_torch.utils import checkpoint as ckpt
from gpu_bidirectional_raytracer_tpu_torch.utils import debug
from gpu_bidirectional_raytracer_tpu_torch.utils.profiling import (
    ThroughputMeter,
    torch_trace,
)
from torch_parity import scn

torch.set_num_threads(2)


def _renderer(rng_impl=None):
    return progressive.Renderer(
        builtin.test_scene(device="cpu"), [20, 80, 300], [0, 15, 0], 16, 12,
        cfg=IntegratorConfig(), device="cpu", rng_impl=rng_impl)


@pytest.mark.parametrize("rng_impl", [None, "threefry"])
def test_roundtrip_and_bitwise_resume(tmp_path, rng_impl):
    d = str(tmp_path / "ck")
    r1 = _renderer(rng_impl)
    r1.render(3)
    at_3 = r1.state
    ckpt.save(d, r1.state)
    r1.render(2)

    r2 = _renderer(rng_impl)
    restored = ckpt.restore(d, r2.state)
    assert restored.sample == 3 and restored.key == at_3.key
    assert rng.key_impl(restored.key) == rng.key_impl(at_3.key)
    for f in ("colors", "counter"):
        assert torch.equal(getattr(restored, f), getattr(at_3, f))
    for f in ("hp", "rad", "nl", "valid", "sid"):
        assert torch.equal(getattr(restored.vpls, f), getattr(at_3.vpls, f))
    assert restored.vlp_index == at_3.vlp_index
    r2.state = restored
    r2.render(2)
    assert torch.equal(r2.state.colors, r1.state.colors)
    assert r2.state.sample == 5


def test_keeps_the_latest_two_steps(tmp_path):
    d = str(tmp_path / "ck")
    r = _renderer()
    for _ in range(4):
        r.step()
        ckpt.save(d, r.state)
    assert sorted(os.listdir(d)) == ["step_0000000003.pt",
                                     "step_0000000004.pt"]
    assert ckpt.restore(d, r.state).sample == 4


def test_restore_missing_returns_none(tmp_path):
    assert ckpt.restore(str(tmp_path / "nope"), None) is None
    os.makedirs(tmp_path / "empty")
    assert ckpt.restore(str(tmp_path / "empty"), None) is None


def test_restore_names_the_stored_tape(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, _renderer("threefry").state)
    with pytest.raises(ckpt.TapeMismatch, match="threefry") as err:
        ckpt.restore(d, _renderer("rbg").state)
    assert (err.value.stored, err.value.requested) == ("threefry", "rbg")


@pytest.mark.parametrize("first,second,hint", [
    ([], ["--fast-rng"], "without --rng/--fast-rng"),
    (["--rng", "threefry"], [], "--rng threefry"),
    (["--rng", "rbg"], [], "--fast-rng (or --rng rbg)"),
])
def test_cross_tape_resume_is_rejected_clearly(tmp_path, capsys, first,
                                               second, hint):
    """As tests/test_checkpoint.py: exit code 2, JAX's message, and the
    flag that matches the stored tape."""
    ckdir, out = str(tmp_path / "ck"), str(tmp_path / "a.ppm")
    base = ["--device", "cpu", "render", scn("simple.scn"), "--width", "16",
            "--height", "12", "--mode", "cpu", "--checkpoint", ckdir,
            "--out", out]
    assert cli.main(base + ["--spp", "2"] + first) == 0
    assert cli.main(base + ["--spp", "4", "--resume"] + second) == 2
    err = capsys.readouterr().err
    assert "different --rng/--fast-rng setting" in err
    assert hint in err


def test_check_state_finite_or_zero_and_image_stats_match_jax():
    state = progressive.init_state(4, 4, IntegratorConfig(), device="cpu")
    debug.check_state(state)
    bad = state.colors.clone()
    bad[0, 0, 0] = float("nan")
    bad[1, 2, 1] = float("inf")
    with pytest.raises(FloatingPointError) as got:
        debug.check_state(dataclasses.replace(state, colors=bad), "test")
    with pytest.raises(FloatingPointError) as ref:
        jdebug.check_state(dataclasses.replace(state, colors=jnp.asarray(
            bad.numpy())), "test")
    assert str(got.value) == str(ref.value)

    x = np.array([1.0, np.nan, np.inf, -2.0, -np.inf], np.float32)
    assert np.array_equal(debug.finite_or_zero(torch.as_tensor(x)).numpy(),
                          np.asarray(jdebug.finite_or_zero(jnp.asarray(x))))
    img = np.random.default_rng(0).normal(size=(5, 6, 3)).astype(np.float32)
    img[2, 3, 1] = np.inf
    assert (debug.image_stats(torch.as_tensor(img))
            == jdebug.image_stats(jnp.asarray(img)))
    with debug.nan_debugging():
        assert torch.is_anomaly_enabled()
    assert not torch.is_anomaly_enabled()


@pytest.mark.parametrize("pixels,total,passes", [
    (1000, 0.0, 0), (512 * 512, 1.2345, 16), (24 * 18, 0.0217, 3)])
def test_throughput_meter_report_is_jax(pixels, total, passes):
    got = ThroughputMeter(pixels, total_time=total, passes=passes)
    ref = JMeter(pixels, total_time=total, passes=passes)
    assert got.report() == ref.report()
    assert got.samples_per_sec == ref.samples_per_sec
    with got:
        pass
    assert got.passes == passes + 1 and "Sample/sec" in got.report()


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    path = tmp_path / "trace.json"
    with torch_trace(str(path), device="cpu") as prof:
        torch.ones(64).cumsum(0)
    assert prof.key_averages()
    assert "traceEvents" in json.loads(path.read_text())
