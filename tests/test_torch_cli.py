"""The port's command line (`gpu_bidirectional_raytracer_tpu_torch.cli`)
and its native scene parser: JAX's argument tree with ``--device`` for
``--platform``, and each subcommand on the CPU (render, resume, the light
integrator, optimize), in process."""

import argparse
import glob
import os
import re
import shutil

import numpy as np
import pytest
import torch

from gpu_bidirectional_raytracer_tpu import cli as jcli
from gpu_bidirectional_raytracer_tpu_torch import cli, native
from gpu_bidirectional_raytracer_tpu_torch.render import film
from gpu_bidirectional_raytracer_tpu_torch.scene import parser
from torch_parity import SCENES_DIR, scn

torch.set_num_threads(2)


class _Captured(Exception):
    pass


def _jax_parser(monkeypatch):
    """JAX's parser, caught as its `main` parses (it builds it inline)."""
    def grab(self, args=None, namespace=None):
        raise _Captured(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Captured) as caught:
        jcli.main(["render"])
    return caught.value.args[0]


def _tree(ap):
    """``{command: {option strings: (default, choices)}}`` of a parser."""
    out = {"": {}}
    for a in ap._actions:
        if isinstance(a, argparse._SubParsersAction):
            for name, sub in a.choices.items():
                out[name] = _tree(sub)[""]
        elif not isinstance(a, argparse._HelpAction):
            key = tuple(a.option_strings) or (a.dest,)
            out[""][key] = (a.default, tuple(a.choices or ()))
    return out


def test_argument_tree_is_jax_with_device_for_platform(monkeypatch):
    want = _tree(_jax_parser(monkeypatch))
    got = _tree(cli.build_parser())
    assert want[""].pop(("--platform",)) == (None, ())
    assert got[""].pop(("--device",)) == ("cuda", ())
    assert got == want


def _run(tmp_path, *args):
    return cli.main(["--device", "cpu", *args])


def test_render_writes_a_p3_ppm(tmp_path, capsys):
    out = tmp_path / "a.ppm"
    assert _run(tmp_path, "render", scn("cornell.scn"), "--width", "24",
                "--height", "18", "--spp", "3", "--out", str(out)) == 0
    assert out.read_text().split()[:4] == ["P3", "24", "18", "255"]
    img = film.read_ppm(out)
    assert img.shape == (18, 24, 3) and img.mean() > 0
    err = capsys.readouterr().err
    assert re.search(r"Rendering time [\d.]+ sec \(pass 3\) Total:[\d.]+ "
                     r"Sample/sec [\d.]+K", err)


def test_resume_renders_only_the_rest(tmp_path, capsys):
    ck, a, b = tmp_path / "ck", tmp_path / "a.ppm", tmp_path / "b.ppm"
    common = ["render", scn("cornell.scn"), "--width", "24", "--height",
              "18", "--chunk", "4"]
    assert _run(tmp_path, *common, "--spp", "5", "--checkpoint", str(ck),
                "--out", str(a)) == 0
    capsys.readouterr()
    assert _run(tmp_path, *common, "--spp", "8", "--checkpoint", str(ck),
                "--resume", "--out", str(b)) == 0
    err = capsys.readouterr().err
    assert "resumed at sample 5" in err and "(pass 3)" in err
    assert _run(tmp_path, *common, "--spp", "8", "--out", str(a)) == 0
    assert a.read_bytes() == b.read_bytes()


def test_light_mode_and_rbg_tape(tmp_path):
    out = tmp_path / "l.ppm"
    assert _run(tmp_path, "render", scn("cornell.scn"), "--width", "20",
                "--height", "14", "--spp", "3", "--mode", "light",
                "--out", str(out)) == 0
    img = film.read_ppm(out)
    assert img.shape == (14, 20, 3) and img.max() > 0
    out_png = tmp_path / "r.png"
    assert _run(tmp_path, "render", scn("cornell.scn"), "--width", "20",
                "--height", "14", "--spp", "2", "--fast-rng",
                "--out", str(out_png)) == 0
    written = out_png if out_png.exists() else tmp_path / "r.ppm"
    assert written.exists()


def test_optimize_writes_a_scene(tmp_path):
    target, out = tmp_path / "t.ppm", tmp_path / "o.scn"
    assert _run(tmp_path, "render", scn("cornell.scn"), "--width", "16",
                "--height", "12", "--spp", "2", "--out", str(target)) == 0
    assert _run(tmp_path, "optimize", str(target), scn("cornell.scn"),
                "--steps", "2", "--spp", "1", "--params", "c",
                "--out", str(out)) == 0
    o, t, arrays = parser.parse_arrays(out.read_text())
    ref_o, _, ref = parser.parse_arrays(open(scn("cornell.scn")).read())
    assert np.allclose(o, ref_o) and arrays["c"].shape == ref["c"].shape
    assert not np.array_equal(arrays["c"], ref["c"])
    assert np.array_equal(arrays["p"], ref["p"])


def _needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native parser cannot be built")
    assert native.available()


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(
    SCENES_DIR, "*.scn"))), ids=os.path.basename)
def test_native_parser_gives_parse_arrays(path):
    _needs_gxx()
    with open(path) as f:
        text = f.read()
    orig, target, arrays = parser.parse_arrays(text)
    cam, flat = native.scn_parse(text)
    assert np.array_equal(cam[:3], orig) and np.array_equal(cam[3:], target)
    for name, cols in (("rad", 0), ("p", slice(1, 4)), ("e", slice(4, 7)),
                       ("c", slice(7, 10))):
        assert np.array_equal(flat[:, cols], arrays[name]), name
    assert np.array_equal(flat[:, 10].astype(np.int32), arrays["refl"])
    no, nt, ns = parser.load_scene(path, device="cpu")
    po, pt, ps = parser.load_scene(path, device="cpu", prefer_native=False)
    assert np.array_equal(no, po) and np.array_equal(nt, pt)
    for f in ("rad", "p", "e", "c", "refl"):
        assert torch.equal(getattr(ns, f), getattr(ps, f))


def test_native_errors_and_ppm(tmp_path):
    _needs_gxx()
    with pytest.raises(parser.SceneParseError, match="sphere needs 11"):
        bad = tmp_path / "bad.scn"
        bad.write_text("camera 1 2 3 4 5 6\nsize 1\nsphere 1 2\n")
        parser.load_scene(bad, device="cpu")
    img = np.random.default_rng(3).uniform(0, 1, (5, 7, 3)).astype(
        np.float32)
    a, b = tmp_path / "n.ppm", tmp_path / "p.ppm"
    film.write_ppm(img, a, prefer_native=True)
    film.write_ppm(img, b, prefer_native=False)
    assert a.read_bytes() == b.read_bytes()
