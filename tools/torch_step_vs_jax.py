"""The port's training step against JAX's, jitted and op by op, on the
CPU: the readings behind tests/test_torch_parallel.py's
``test_sharded_step_matches_jax``.

For cornell.scn at 16x16 (``max_depth`` 2, ``vis_grad_tau`` 2, l2, spp 1)
over several keys and two targets (black, and uniform [0, 0.5) from numpy
seed 8), and for the test's 89-sphere case (log loss, mix32 key 5), it
prints one JSON line per case with three comparisons of
``render_loss_grad(backend="xla")`` of JAX and the port's
``render_loss_grad(backend="pallas")`` (its plain versions on the CPU):
the port against JAX op by op (``jax.disable_jit``), the port against
jitted JAX, and jitted JAX against op-by-op JAX. Each gives the loss's
relative difference and, per gradient, tests/test_pallas_grad.py's
``_max_rel``.

    python tools/torch_step_vs_jax.py     # a few minutes on the CPU
"""

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from gpu_bidirectional_raytracer_tpu import rng as jrng  # noqa: E402
from gpu_bidirectional_raytracer_tpu.core.types import (  # noqa: E402
    Camera as JCamera,
    IntegratorConfig as JConfig,
)
from gpu_bidirectional_raytracer_tpu.diff import gradients as JG  # noqa: E402
from gpu_bidirectional_raytracer_tpu.integrators.direct import (  # noqa: E402
    static_light_indices,
)
from gpu_bidirectional_raytracer_tpu.scene import parser  # noqa: E402
from gpu_bidirectional_raytracer_tpu_torch import rng as trng  # noqa: E402
from gpu_bidirectional_raytracer_tpu_torch.diff import (  # noqa: E402
    gradients as TG,
)
from torch_parity import (  # noqa: E402
    key_words,
    many_sphere_scene,
    max_rel,
    scn,
    to_torch_camera,
    to_torch_config,
    to_torch_scene,
)

W = H = 16
PARAMS = ("p", "rad", "e", "c")


def _compare(ref_loss, ref, loss, got) -> dict:
    out = {"loss": abs(float(loss) - float(ref_loss))
           / abs(float(ref_loss))}
    for f in PARAMS:
        out[f] = max_rel(np.asarray(getattr(ref, f)),
                         np.asarray(getattr(got, f)))
    return out


def readings(js, cam, cfg, jkey, impl, target, loss) -> dict:
    li = static_light_indices(js)
    tgt = jnp.asarray(target)
    jit_l, jit_g = JG.render_loss_grad(js, cam, jkey, tgt, cfg, W, H, li, 1,
                                       loss, "xla")
    with jax.disable_jit():
        op_l, op_g = JG.render_loss_grad.__wrapped__(js, cam, jkey, tgt, cfg,
                                                     W, H, li, 1, loss, "xla")
    key = trng.make_typed_key(key_words(jkey), impl)
    t_l, t_g = TG.render_loss_grad(
        to_torch_scene(js), to_torch_camera(cam), key, torch.tensor(target),
        to_torch_config(cfg), W, H, li, 1, loss, "pallas")
    t_g = t_g.replace(**{f: getattr(t_g, f).numpy() for f in PARAMS})
    return {"port_vs_op_by_op": _compare(op_l, op_g, t_l, t_g),
            "port_vs_jit": _compare(jit_l, jit_g, t_l, t_g),
            "jit_vs_op_by_op": _compare(op_l, op_g, jit_l, jit_g)}


def main() -> None:
    torch.set_num_threads(2)
    orig, target, cornell = parser.load_scene(scn("cornell.scn"))
    cam = JCamera.make(np.asarray(orig, np.float32),
                       np.asarray(target, np.float32), W, H)
    targets = {"black": np.zeros((H, W, 3), np.float32),
               "uniform": np.random.default_rng(8).uniform(
                   0.0, 0.5, (H, W, 3)).astype(np.float32)}
    keys = ([(f"threefry{s}", jax.random.key(s), "threefry")
             for s in range(6)]
            + [(f"mix32_{s}", jrng.make_key(s), "mix32") for s in range(4)])
    cfg = JConfig(vis_grad_tau=2.0, max_depth=2)
    for tname, tgt in targets.items():
        for kname, jkey, impl in keys:
            print(json.dumps({"scene": "cornell", "target": tname,
                              "key": kname, **readings(
                                  cornell, cam, cfg, jkey, impl, tgt, "l2")}),
                  flush=True)
    print(json.dumps({"scene": "89 spheres", "target": "uniform",
                      "key": "mix32_5", **readings(
                          many_sphere_scene(), cam, JConfig(max_depth=2),
                          jrng.make_key(5), "mix32", targets["uniform"],
                          "log")}), flush=True)


if __name__ == "__main__":
    main()
