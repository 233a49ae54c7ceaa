"""The port's scene parser, built-in scenes and camera against the JAX
package: all shipped .scn files parse to equal arrays, and the camera basis
and primary rays agree."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_bidirectional_raytracer_tpu import camera as jcam
from gpu_bidirectional_raytracer_tpu import rng as jrng
from gpu_bidirectional_raytracer_tpu.core.types import Camera as JCamera
from gpu_bidirectional_raytracer_tpu.scene import builtin as jbuiltin
from gpu_bidirectional_raytracer_tpu.scene import parser as jparser
from gpu_bidirectional_raytracer_tpu_torch import camera as tcam
from gpu_bidirectional_raytracer_tpu_torch import rng as trng
from gpu_bidirectional_raytracer_tpu_torch.core.types import Camera as TCamera
from gpu_bidirectional_raytracer_tpu_torch.scene import builtin as tbuiltin
from gpu_bidirectional_raytracer_tpu_torch.scene import parser as tparser
from torch_parity import SCENES_DIR

torch.set_num_threads(2)

SCENES = sorted(os.path.basename(p)
                for p in glob.glob(os.path.join(SCENES_DIR, "*.scn")))


def _assert_scene_equal(tscene, jscene):
    for f in ("rad", "p", "e", "c", "refl"):
        got = getattr(tscene, f).numpy()
        ref = np.asarray(getattr(jscene, f))
        assert got.dtype == ref.dtype, f
        assert np.array_equal(got, ref), f


def test_ships_24_scenes():
    assert len(SCENES) == 24


@pytest.mark.parametrize("name", SCENES)
def test_scene_files_parse_equal(name):
    path = os.path.join(SCENES_DIR, name)
    jo, jt, js = jparser.load_scene(path)
    to, tt, ts = tparser.load_scene(path, device="cpu")
    assert np.array_equal(to, np.asarray(jo))
    assert np.array_equal(tt, np.asarray(jt))
    _assert_scene_equal(ts, js)


def test_builtin_scenes_equal():
    _assert_scene_equal(tbuiltin.cornell_box(device="cpu"),
                        jbuiltin.cornell_box())
    _assert_scene_equal(tbuiltin.test_scene(device="cpu"),
                        jbuiltin.test_scene())


def test_write_and_scale_round_trip():
    o, t, s = tparser.load_scene(os.path.join(SCENES_DIR, "cornell.scn"),
                                 device="cpu")
    o2, t2, s2 = tparser.parse_scene(tparser.dumps_scene(o, t, s),
                                     device="cpu")
    assert np.array_equal(o, o2) and np.array_equal(t, t2)
    _assert_scene_equal(s2, s)
    jo, jt, js = jparser.load_scene(os.path.join(SCENES_DIR, "cornell.scn"))
    jo3, jt3, js3 = jparser.scale_world(jo, jt, js, 100.0)
    to3, tt3, ts3 = tparser.scale_world(o, t, s, 100.0)
    assert np.array_equal(to3, jo3) and np.array_equal(tt3, jt3)
    _assert_scene_equal(ts3, js3)


def test_parse_errors_carry_line_numbers():
    with pytest.raises(tparser.SceneParseError, match="line 3"):
        tparser.parse_arrays("camera 0 0 0 0 0 1\nsize 1\nsphere 1 2 3\n")
    with pytest.raises(tparser.SceneParseError, match="bad material"):
        tparser.parse_arrays("camera 0 0 0 0 0 1\nsize 1\n"
                             "sphere 1 0 0 0 0 0 0 1 1 1 7\n")


@pytest.mark.parametrize("name,w,h", [("cornell.scn", 16, 12),
                                      ("simple.scn", 33, 7),
                                      ("caustic.scn", 64, 48)])
def test_camera_and_primary_rays(name, w, h):
    jo, jt, _ = jparser.load_scene(os.path.join(SCENES_DIR, name))
    jc = JCamera.make(jo, jt, w, h)
    tc = TCamera.make(np.asarray(jo), np.asarray(jt), w, h, device="cpu")
    for f in ("orig", "target", "dir", "x", "y"):
        np.testing.assert_allclose(getattr(tc, f).numpy(),
                                   np.asarray(getattr(jc, f)),
                                   rtol=1e-6, atol=1e-6)
    n = w * h
    key = jrng.make_key(4)
    ju = jrng.site_uniforms(key, 1, 0, jrng.CAM_JITTER, 2, n)
    jpx, jpy = jcam.pixel_grid(w, h)
    jr = jcam.primary_rays(jc, w, h, ju[0], ju[1], jpx, jpy)
    tu = trng.site_uniforms(trng.make_key(4), 1, 0, trng.CAM_JITTER, 2, n,
                            device="cpu")
    tpx, tpy = tcam.pixel_grid(w, h, device="cpu")
    assert np.array_equal(tpx.numpy(), np.asarray(jpx))
    assert np.array_equal(tpy.numpy(), np.asarray(jpy))
    tr = tcam.primary_rays(tc, w, h, tu[0], tu[1], tpx, tpy)
    np.testing.assert_allclose(tr.o.numpy(), np.asarray(jr.o),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tr.d.numpy(), np.asarray(jr.d),
                               rtol=1e-6, atol=1e-6)


def test_stratify_and_camera_motion():
    u = np.linspace(0.0, 0.99, 10, dtype=np.float32)
    v = u[::-1].copy()
    for sample in (0, 5, 13):
        ju, jv = jcam.stratify_jitter(jnp.asarray(u), jnp.asarray(v),
                                      sample, 3)
        tu, tv = tcam.stratify_jitter(torch.as_tensor(u), torch.as_tensor(v),
                                      sample, 3)
        assert np.array_equal(tu.numpy(), np.asarray(ju))
        assert np.array_equal(tv.numpy(), np.asarray(jv))
    w, h = 40, 30
    jc = JCamera.make([50, 45, 205.6], [50, 44.957388, 204.6], w, h)
    tc = TCamera.make([50, 45, 205.6], [50, 44.957388, 204.6], w, h,
                      device="cpu")
    moves = [("translate", "x", 10.0), ("translate", "dir", -10.0),
             ("translate", "y_world", 3.0), ("rotate", "pitch", 0.05),
             ("rotate", "yaw", -0.1)]
    for kind, axis, amount in moves:
        mod_j = getattr(jcam, kind)
        mod_t = getattr(tcam, kind)
        jc = mod_j(jc, axis, amount, w, h)
        tc = mod_t(tc, axis, amount, w, h)
        for f in ("orig", "target", "dir", "x", "y"):
            np.testing.assert_allclose(getattr(tc, f).numpy(),
                                       np.asarray(getattr(jc, f)),
                                       rtol=1e-5, atol=1e-5)
    assert tcam.reference_dims(w, h) == jcam.reference_dims(w, h)
