"""sfvp_tpu_torch — the PyTorch / CUDA port of sfvp_tpu.

Progressive Cornell-Box path tracing with the reference's exact semantics
in parity mode, on one NVIDIA GPU through hand-written CUDA kernels
(kernels/megakernel_regen.py = K1, kernels/megakernel.py = K2), or on the
CPU through their plain PyTorch twins. Imports torch and numpy, never jax.
"""

from .config import CameraConfig, RenderConfig  # noqa: F401
from .scene import Scene, SceneBuffers, load_obj, upload, cornell_box_path  # noqa: F401
from .integrate import RenderState, init_state, make_render_step  # noqa: F401
from .render import Renderer, render, write_png  # noqa: F401

__version__ = "0.1.0"
