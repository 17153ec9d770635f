from .objload import Scene, load_obj, cornell_box_path  # noqa: F401
from .buffers import (  # noqa: F401
    SceneBuffers, from_arrays, from_numpy, to_device, upload)
