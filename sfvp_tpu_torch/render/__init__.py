from .png import write_png, tonemap_srgb_u8, tonemap_unorm_u8  # noqa: F401
from .driver import Renderer, render, write_image  # noqa: F401
from .checkpoint import save_checkpoint, load_checkpoint  # noqa: F401
