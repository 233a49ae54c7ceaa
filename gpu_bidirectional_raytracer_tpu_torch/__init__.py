"""PyTorch + CUDA port of the bidirectional sphere path tracer.

The JAX package ``gpu_bidirectional_raytracer_tpu`` is the reference; this
package mirrors its layout module for module and never imports it or JAX.
Plain tensor code is PyTorch; the eye-path megakernel
(``csrc/trace_kernel.cu``), its adjoint (``csrc/grad_kernel.cu``: the
backward of the differentiable tracer and the fused loss-and-gradient
step) and the per-depth bounce and fact kernels of scenes above 64
spheres (``csrc/bounce_kernel.cu``) are CUDA C++ for Hopper, built with
nvcc at first use and bound with ctypes (``ops/_build.py``). Entry points take a ``device`` that
defaults to ``"cuda"`` and raise when no card is present; pass
``device="cpu"`` to run the plain versions on the CPU.

The user-facing entry points are the JAX package's: the command line
(``python -m gpu_bidirectional_raytracer_tpu_torch.cli``), the terminal
viewer (``render/viewer.py``), checkpoints, profiling and debug helpers
(``utils/``) and the native ``.scn`` parser (``native/``). ``parallel/``
splits the render, the trace, the light splat and the training step over
the ranks of a ``torch.distributed`` group, each rank running the same
kernels on its window of lanes.
"""

__version__ = "0.1.0"

from gpu_bidirectional_raytracer_tpu_torch.core.types import (
    DIFF,
    LITE,
    REFR,
    SPEC,
    Camera,
    IntegratorConfig,
    Rays,
    RenderState,
    Scene,
    VplBuffer,
)
from gpu_bidirectional_raytracer_tpu_torch.diff.gradients import (
    InverseRenderer,
    render_loss_grad,
    render_radiance,
)
from gpu_bidirectional_raytracer_tpu_torch.render.progressive import (
    Renderer,
    init_state,
    render_image,
)
from gpu_bidirectional_raytracer_tpu_torch.scene.builtin import (
    cornell_box,
    test_scene,
)
from gpu_bidirectional_raytracer_tpu_torch.scene.parser import (
    load_scene,
    parse_scene,
    write_scene,
)

__all__ = [
    "Camera", "IntegratorConfig", "Rays", "RenderState", "Scene",
    "VplBuffer", "DIFF", "SPEC", "REFR", "LITE", "load_scene",
    "parse_scene", "write_scene", "cornell_box", "test_scene", "Renderer",
    "init_state", "render_image", "InverseRenderer", "render_loss_grad",
    "render_radiance",
]
