"""Host BVH builders (NumPy): the threaded binary LBVH and binned-SAH trees
and their 8-wide collapse, the tree the BVH kernels trace."""

from .lbvh import BVH, build_bvh, bvh_from_arrays, check_invariants  # noqa: F401
from .sah import build_sah_bvh, sah_bvh_from_arrays  # noqa: F401
from .wide import WideBVH, build_wide, build_wide_from_buffers  # noqa: F401
