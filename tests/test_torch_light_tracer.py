"""The port's light pass against the JAX package: emission rays and the
deposited VPL buffer, from the same scene and the same mix32 key.

``valid`` and ``sid`` are equal. ``rad`` and ``nl`` are allclose with
atol 1e-4 and rtol 1e-4. ``hp`` is allclose with the same tolerance on all
but at most 1% of its entries, and within 1e-2 on all of them: a hit on
one of the 1e4-radius wall spheres takes its distance from
``b - sqrt(b^2 - |op|^2 + r^2)`` with ``b`` near 1e4, where float32
cancellation leaves about 1e-3 of absolute error, and the two packages
round that expression in a different order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_bidirectional_raytracer_tpu import rng as jrng
from gpu_bidirectional_raytracer_tpu.core.types import IntegratorConfig as JConfig
from gpu_bidirectional_raytracer_tpu.integrators import light_tracer as jlt
from gpu_bidirectional_raytracer_tpu.integrators.direct import (
    static_light_indices as jlights,
)
from gpu_bidirectional_raytracer_tpu.scene import builtin as jbuiltin
from gpu_bidirectional_raytracer_tpu.scene import parser as jparser
from gpu_bidirectional_raytracer_tpu_torch.integrators import light_tracer as tlt
from torch_parity import key_words, scn, to_torch_config, to_torch_scene

torch.set_num_threads(2)


def _compare(jv, tv):
    assert np.array_equal(tv.valid.numpy(), np.asarray(jv.valid))
    assert np.array_equal(tv.sid.numpy(), np.asarray(jv.sid))
    for f in ("rad", "nl"):
        np.testing.assert_allclose(getattr(tv, f).numpy(),
                                   np.asarray(getattr(jv, f)),
                                   rtol=1e-4, atol=1e-4, err_msg=f)
    got, ref = tv.hp.numpy(), np.asarray(jv.hp)
    far = ~np.isclose(got, ref, rtol=1e-4, atol=1e-4)
    assert far.mean() <= 0.01, f"{far.mean():.3%} hp entries beyond 1e-4"
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2)


@pytest.mark.parametrize("scene_name,seed,sample,vpl_depth", [
    ("builtin", 0, 0, 1),
    ("cornell.scn", 5, 2, 1),
    ("cornell_2luci.scn", 1, 4, 3),
])
def test_vpl_buffer_matches_jax(scene_name, seed, sample, vpl_depth):
    if scene_name == "builtin":
        scene = jbuiltin.cornell_box()
    else:
        _, _, scene = jparser.load_scene(scn(scene_name))
    cfg = JConfig(vpl_depth=vpl_depth, light_points=1024)
    key = jrng.make_key(seed)
    li = jlights(scene)
    jv = jlt.trace_light_paths(scene, cfg, li, key, jnp.int32(sample))
    tv = tlt.trace_light_paths(to_torch_scene(scene), to_torch_config(cfg),
                               li, key_words(key), sample)
    assert tv.hp.shape == (vpl_depth, 1024, 3)
    _compare(jv, tv)
    assert tv.valid.any()


def test_emission_rays_match_and_window():
    scene = jbuiltin.cornell_box()
    cfg = JConfig(light_points=256)
    key = jrng.make_key(2)
    li = jlights(scene)
    jr, jlane, je = jlt.emit_light_rays(scene, cfg, li, key, jnp.int32(1),
                                        lane_offset=jnp.int32(64),
                                        lane_count=128, lane_total=256)
    tr, tlane, te = tlt.emit_light_rays(to_torch_scene(scene),
                                        to_torch_config(cfg), li,
                                        key_words(key), 1, lane_offset=64,
                                        lane_count=128, lane_total=256)
    assert np.array_equal(tlane.numpy(), np.asarray(jlane))
    assert np.array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tr.o.numpy(), np.asarray(jr.o),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tr.d.numpy(), np.asarray(jr.d),
                               rtol=1e-5, atol=1e-5)
