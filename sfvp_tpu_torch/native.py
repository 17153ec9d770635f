"""ctypes bindings for the package's native C++ runtime (csrc/sfvp_native.cpp):
the OBJ/MTL loader and the LBVH and binned-SAH builders, a port of
sfvp_tpu/native.py over the package's own copy of the source.

The reference keeps scene ingest and accel builds in C++ (tinyobjloader,
ref main.cpp:28-58; buildAccelerationStructuresKHR, main.cpp:440-447).
Their outputs equal the Python implementations' byte for byte
(tests/test_torch_native.py).

g++ builds the library at first use into the package's build directory
(``BUILD_DIR``: the environment variable ``SFVP_TPU_TORCH_BUILD_DIR``, by
default ``build/sfvp_tpu_torch/`` beside the package directory), never
beside the JAX package's csrc/: its name carries a hash of the source and
the flags, one process compiles it under a file lock while the others
wait, and it appears by an atomic rename, so no process loads a
half-written file. A build or load that fails leaves ``available()``
False: callers with ``native="auto"`` then take the NumPy (or pure-Python)
implementation, as sfvp_tpu's do, and ``native="require"`` raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "sfvp_native.cpp"
BUILD_DIR = Path(os.environ.get(
    "SFVP_TPU_TORCH_BUILD_DIR",
    Path(__file__).resolve().parents[1] / "build" / "sfvp_tpu_torch"))
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libsfvp_native_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless a build of this source exists; raises
    RuntimeError with the compiler's output when it cannot."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) to build "
                           f"{SOURCE.name}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{out.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while this one waited
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native build failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    vp = ctypes.c_void_p
    sigs = {
        "sfvp_load_obj": (vp, [ctypes.c_char_p, ctypes.c_int]),
        "sfvp_scene_error": (ctypes.c_char_p, [vp]),
        "sfvp_scene_num_tris": (ctypes.c_int, [vp]),
        "sfvp_scene_material_names": (ctypes.c_char_p, [vp]),
        "sfvp_scene_fill": (None, [vp] + [f32p] * 4 + [i32p] * 2),
        "sfvp_scene_fill_rough": (None, [vp, f32p]),
        "sfvp_scene_fill_uv": (None, [vp, f32p, i32p]),
        "sfvp_scene_texture_paths": (ctypes.c_char_p, [vp]),
        "sfvp_scene_free": (None, [vp]),
        "sfvp_build_lbvh": (vp, [f32p, ctypes.c_int, ctypes.c_int]),
        "sfvp_build_sah": (vp, [f32p] + [ctypes.c_int] * 3),
        "sfvp_bvh_num_nodes": (ctypes.c_int, [vp]),
        "sfvp_bvh_fill": (None, [vp] + [f32p] * 2 + [i32p] * 3
                          + [f32p, i32p]),
        "sfvp_bvh_free": (None, [vp]),
        "sfvp_emit_topology": (ctypes.c_int, [u32p, ctypes.c_int,
                                              ctypes.c_int] + [i32p] * 3),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


@functools.lru_cache(maxsize=None)
def _lib_or_error():
    """(library, None) once built and loaded, else (None, the error)."""
    try:
        return _bind(ctypes.CDLL(str(build()))), None
    except (OSError, RuntimeError, AttributeError) as e:
        return None, e


def _get_lib() -> Optional[ctypes.CDLL]:
    return _lib_or_error()[0]


def available() -> bool:
    """Whether the library builds and loads (it is built on first call)."""
    return _get_lib() is not None


def sah_available() -> bool:
    """Whether the native SAH builder is there: the port's library always
    has the symbol, so this is ``available()`` (sfvp_tpu's also checks for
    an older build without it)."""
    return available()


def require(what: str) -> ctypes.CDLL:
    """The library, or RuntimeError naming ``what`` and why it is absent
    (the ``native="require"`` error)."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(f"native {what} requested but the library "
                           f"{library_path().name} cannot be built or "
                           f"loaded: {_lib_or_error()[1]}")
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def load_obj_native(path: str, flip_y: bool = True):
    """Native OBJ/MTL ingest; returns a Scene identical to
    scene.objload.load_obj(native="never"), or None when the library is
    unavailable. A missing file raises FileNotFoundError, a malformed one
    ValueError."""
    lib = _get_lib()
    if lib is None:
        return None
    from .scene.objload import Scene

    h = lib.sfvp_load_obj(str(path).encode(), 1 if flip_y else 0)
    try:
        err = lib.sfvp_scene_error(h).decode()
        if err:
            if "cannot open" in err:
                raise FileNotFoundError(err)
            raise ValueError(err)
        t = lib.sfvp_scene_num_tris(h)
        vertices = np.empty((3 * t, 3), np.float32)
        diffuse, emission, specular = (np.empty((t, 3), np.float32)
                                       for _ in range(3))
        mat_type = np.empty((t,), np.int32)
        mat_id = np.empty((t,), np.int32)
        lib.sfvp_scene_fill(h, _fptr(vertices), _fptr(diffuse),
                            _fptr(emission), _fptr(specular),
                            _iptr(mat_type), _iptr(mat_id))
        rough = np.zeros((t,), np.float32)
        lib.sfvp_scene_fill_rough(h, _fptr(rough))
        face_uv = np.zeros((t, 3, 2), np.float32)
        face_tex = np.full((t,), -1, np.int32)
        lib.sfvp_scene_fill_uv(h, _fptr(face_uv), _iptr(face_tex))
        blob = lib.sfvp_scene_texture_paths(h).decode()
        names = lib.sfvp_scene_material_names(h).decode()
        return Scene(
            vertices=vertices,
            indices=np.arange(3 * t, dtype=np.uint32),
            face_diffuse=diffuse,
            face_emission=emission,
            face_specular=specular,
            face_mat_type=mat_type,
            face_rough=rough,
            face_uv=face_uv,
            face_tex=face_tex,
            texture_paths=blob.split("\n") if blob else [],
            material_names=names.split("\n") if names else [],
            face_material_id=mat_id,
        )
    finally:
        lib.sfvp_scene_free(h)


def emit_topology_native(codes_sorted: np.ndarray, leaf_size: int):
    """Native hierarchy emission from sorted morton codes: (skip, first,
    count) as accel.lbvh.emit_topology gives them, or None when the
    library is unavailable."""
    lib = _get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(np.asarray(codes_sorted, np.uint32))
    t = codes.shape[0]
    cap = max(1, 2 * t)
    skip, first, count = (np.empty(cap, np.int32) for _ in range(3))
    m = lib.sfvp_emit_topology(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), t, leaf_size,
        _iptr(skip), _iptr(first), _iptr(count))
    return skip[:m].copy(), first[:m].copy(), count[:m].copy()


def _bvh_from_handle(lib, h, t: int):
    from .accel.lbvh import BVH

    try:
        m = lib.sfvp_bvh_num_nodes(h)
        bmin = np.empty((m, 3), np.float32)
        bmax = np.empty((m, 3), np.float32)
        skip, first, count = (np.empty((m,), np.int32) for _ in range(3))
        tv = np.empty((9, t), np.float32)
        prim_id = np.empty((t,), np.int32)
        lib.sfvp_bvh_fill(h, _fptr(bmin), _fptr(bmax), _iptr(skip),
                          _iptr(first), _iptr(count), _fptr(tv),
                          _iptr(prim_id))
        return BVH(
            bmin_x=bmin[:, 0].copy(), bmin_y=bmin[:, 1].copy(),
            bmin_z=bmin[:, 2].copy(),
            bmax_x=bmax[:, 0].copy(), bmax_y=bmax[:, 1].copy(),
            bmax_z=bmax[:, 2].copy(),
            skip=skip, first=first, count=count,
            tv=tuple(tv[i].copy() for i in range(9)),
            prim_id=prim_id,
        )
    finally:
        lib.sfvp_bvh_free(h)


def build_lbvh_native(tris: np.ndarray, leaf_size: int = 4):
    """Native LBVH build of (T, 3, 3) float32 triangles: a BVH identical
    to accel.lbvh.bvh_from_arrays, or None when the library is
    unavailable."""
    lib = _get_lib()
    if lib is None:
        return None
    tris = np.ascontiguousarray(np.asarray(tris, np.float32))
    t = tris.shape[0]
    return _bvh_from_handle(lib, lib.sfvp_build_lbvh(_fptr(tris), t,
                                                     leaf_size), t)


def build_sah_native(tris: np.ndarray, leaf_size: int = 8,
                     max_leaf: int = 8):
    """Native binned-SAH build of (T, 3, 3) float32 triangles: a BVH
    identical to accel.sah.sah_bvh_from_arrays(native="never"), or None
    when the library is unavailable."""
    lib = _get_lib()
    if lib is None:
        return None
    tris = np.ascontiguousarray(np.asarray(tris, np.float32))
    t = tris.shape[0]
    return _bvh_from_handle(
        lib, lib.sfvp_build_sah(_fptr(tris), t, leaf_size, max_leaf), t)
