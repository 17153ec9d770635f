"""Build and load the package's CUDA kernels (csrc/*.cu).

nvcc compiles every source into one shared library with a plain C
interface, at first use, from the package's own sources; ctypes loads it.
The library's name carries a hash of the sources and flags, so an edited
source is rebuilt and a finished build is reused. It lands in the
directory named by the environment variable ``SFVP_TPU_TORCH_BUILD_DIR``,
by default ``build/sfvp_tpu_torch/`` beside the package directory (the
repository root in a checkout; an installed copy should set the variable),
next to ptxas's register and shared-memory report (``<lib>.log``).

Flags: sm_90a (Hopper), no fast math, and ``-fmad=false``: without fused
multiply-adds every float op rounds as the plain PyTorch twins' ops do.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..config import RenderConfig
from ..integrate.wavefront import UNIFORM_SCALE
from ..sampling import TWO_PI
from ..utils.vec import f32
from .intersect import _DET_EPS

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(os.environ.get(
    "SFVP_TPU_TORCH_BUILD_DIR",
    Path(__file__).resolve().parents[2] / "build" / "sfvp_tpu_torch"))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)
# 25 rows of float32 per triangle (csrc/common.cuh kSmemRows) in the 48 KB
# of shared memory a block gets without opting in to more
MAX_KERNEL_TRIS = 480


class Params(ctypes.Structure):
    """Mirror of ``sfvp::Params`` in csrc/common.cuh, field for field."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "frame", "row0", "gw", "gh", "npix", "spp", "max_depth", "uniform",
        "use_rr", "rr_start", "chunk", "chunk_idx", "num_tris", "tp")] + [
        (name, ctypes.c_float) for name in (
            "t_min", "t_max", "inv2w", "inv2h", "two_pi", "uniform_scale",
            "det_eps")] + [
        (name, ctypes.c_float * 3) for name in (
            "cam_c", "cam_r", "cam_u", "cam_o", "sky")]


def make_params(cfg: RenderConfig, *, frame: int, row0: int, global_shape,
                npix: int, num_tris: int, tp: int,
                chunk_idx: int = 0) -> Params:
    """Launch parameters; every float is the float32 the twins use."""
    gh, gw = global_shape
    vec3 = ctypes.c_float * 3
    cam = cfg.camera
    return Params(
        frame=frame, row0=row0, gw=gw, gh=gh, npix=npix,
        spp=cfg.spp_per_step, max_depth=cfg.max_depth,
        uniform=int(cfg.sampling == "uniform"), use_rr=int(cfg.use_rr),
        rr_start=cfg.rr_start_depth, chunk=cfg.spp_chunk,
        chunk_idx=chunk_idx, num_tris=num_tris, tp=tp,
        t_min=f32(cfg.t_min), t_max=f32(cfg.t_max),
        inv2w=f32(2.0 / gw), inv2h=f32(2.0 / gh), two_pi=TWO_PI,
        uniform_scale=UNIFORM_SCALE, det_eps=_DET_EPS,
        cam_c=vec3(*map(f32, cam.center)), cam_r=vec3(*map(f32, cam.right)),
        cam_u=vec3(*map(f32, cam.up)), cam_o=vec3(*map(f32, cam.origin)),
        sky=vec3(*map(f32, cfg.sky_emission)),
    )


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {cand} and on PATH); the CUDA "
            "kernels are built on a machine with the CUDA toolkit")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsfvp_kernels_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless a build of these sources exists.
    Raises with nvcc's output when the compile fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *map(str, sorted(CSRC.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    log = out.with_suffix(".log")
    log.write_text(f"# {' '.join(cmd)}\n# {time.perf_counter() - t0:.1f} s\n"
                   + proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process)."""
    lib = ctypes.CDLL(str(build()))
    for fn in (lib.sfvp_regen_render, lib.sfvp_wave_render):
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(Params), ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def launch(fn_name: str, table, params: Params, has_mirrors: bool,
           n_out: int):
    """Launch one kernel of the library on the current stream of the
    table's device. Allocates and returns (colr, colg, colb, segs)."""
    with torch.cuda.device(table.device):
        fn = getattr(library(), fn_name)
        outs = [torch.empty(n_out, dtype=torch.float32, device=table.device)
                for _ in range(3)]
        segs = torch.empty(n_out, dtype=torch.int32, device=table.device)
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), ctypes.byref(params), int(has_mirrors),
                 *(o.data_ptr() for o in outs), segs.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")
    return (*outs, segs)


def check_table(table, num_tris: int) -> None:
    """What the kernels take: a contiguous float32 (20, Tp) scene table on
    a CUDA device, with 0 < num_tris <= MAX_KERNEL_TRIS."""
    if table.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take a CUDA tensor, got "
                         f"{table.device}")
    if table.dtype != torch.float32:
        raise ValueError(f"scene table must be float32, got {table.dtype}")
    if table.dim() != 2 or table.shape[0] != 20 or not table.is_contiguous():
        raise ValueError(f"scene table must be a contiguous (20, Tp) "
                         f"tensor, got {tuple(table.shape)}")
    if not 0 < num_tris <= min(MAX_KERNEL_TRIS, table.shape[1]):
        raise ValueError(
            f"num_tris={num_tris} outside 1..{MAX_KERNEL_TRIS} (the table "
            "lives in 48 KB of shared memory)")
