from .objload import Scene, load_obj, cornell_box_path  # noqa: F401
from .buffers import SceneBuffers, from_arrays, from_numpy, upload  # noqa: F401
