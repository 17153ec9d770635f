"""Build and load the package's CUDA kernels (csrc/*.cu).

nvcc compiles each source to an object, all sources at once in parallel,
and links the objects into one shared library with a plain C interface,
at first use, from the package's own sources; ctypes loads it.
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
from ..integrate.lights import N_LIGHT_ROWS
from ..integrate.wavefront import UNIFORM_PDF, UNIFORM_SCALE
from ..sampling import INV_PI, TWO_PI
from ..utils.vec import f32
from .intersect import _DET_EPS

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(os.environ.get(
    "SFVP_TPU_TORCH_BUILD_DIR",
    Path(__file__).resolve().parents[2] / "build" / "sfvp_tpu_torch"))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)
# 25 rows of float32 per triangle (csrc/common.cuh kSmemRows) in the 48 KB
# of shared memory a block gets without opting in to more
MAX_KERNEL_TRIS = 480
# a ray's traversal stack in the BVH kernels (csrc/wide_bvh.cuh kMaxStack)
MAX_WIDE_STACK = 256
# K6's packet stack (max_stack + leaf_q entries, csrc/packet_trace2.cu
# kPacketStack) and leaf queue (kMaxLeafQ), in shared memory
MAX_PACKET_STACK = 512
MAX_LEAF_Q = 256
# child refs are stored as float32 in the node rows: exact below 2**24
MAX_WIDE_ROWS = 1 << 24
# K3's and K4's ray count is a C int (their plane offsets are size_t)
MAX_WAVE_RAYS = 1 << 31


class Params(ctypes.Structure):
    """Mirror of ``sfvp::Params`` in csrc/common.cuh, field for field."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "frame", "row0", "gw", "gh", "npix", "spp", "max_depth", "uniform",
        "use_rr", "rr_start", "chunk", "chunk_idx", "num_tris", "tp")] + [
        (name, ctypes.c_float) for name in (
            "t_min", "t_max", "inv2w", "inv2h", "two_pi", "uniform_scale",
            "det_eps")] + [
        (name, ctypes.c_float * 3) for name in (
            "cam_c", "cam_r", "cam_u", "cam_o", "sky")] + [
        (name, ctypes.c_int) for name in (
            "use_nee", "use_mis", "num_lights")] + [
        (name, ctypes.c_float) for name in (
            "total_area", "inv_area", "inv_pi", "uniform_pdf")]


class WideParams(ctypes.Structure):
    """Mirror of ``sfvp::Wide`` in csrc/wide_bvh.cuh, field for field."""

    _fields_ = [("nodes", ctypes.c_void_p), ("tris", ctypes.c_void_p)] + [
        (name, ctypes.c_int) for name in (
            "n_nodes", "n_leaf_rows", "max_stack")] + [
        (name, ctypes.c_float) for name in ("t_min", "det_eps")]


class TwoLevelParams(ctypes.Structure):
    """Mirror of ``sfvp::TwoLevel`` in csrc/two_level.cuh, field for
    field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "nodes", "tris", "inst")] + [
        (name, ctypes.c_int) for name in (
            "n_nodes", "n_leaf_rows", "n_inst", "max_stack")] + [
        (name, ctypes.c_float) for name in ("t_min", "det_eps")]


def make_params(cfg: RenderConfig, *, frame: int, row0: int, global_shape,
                npix: int, num_tris: int, tp: int, chunk_idx: int = 0,
                lights=None) -> Params:
    """Launch parameters; every float is the float32 the twins use.
    ``lights`` (integrate/lights.py LightTable): next-event estimation
    when ``cfg.use_nee``, MIS when ``cfg.use_mis`` too; neither without
    lights."""
    gh, gw = global_shape
    vec3 = ctypes.c_float * 3
    cam = cfg.camera
    use_nee = cfg.use_nee and lights is not None
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
        use_nee=int(use_nee), use_mis=int(use_nee and cfg.use_mis),
        num_lights=lights.num if use_nee else 0,
        total_area=f32(lights.total_area) if use_nee else 1.0,
        inv_area=lights.inv_area if use_nee else 1.0, inv_pi=INV_PI,
        uniform_pdf=UNIFORM_PDF,
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
    """Compile the library unless a build of these sources exists: one
    nvcc per source, all started together, then one link. Raises with
    nvcc's output when a compile or the link fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    failed = []
    for cmd, obj, proc in jobs:
        text = proc.communicate()[0]
        log.append(f"# {' '.join(cmd)}\n{text}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{text}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text(
        f"# {time.perf_counter() - t0:.1f} s\n" + "".join(log))
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process)."""
    lib = ctypes.CDLL(str(build()))
    outs = [ctypes.c_void_p] * 5  # colr, colg, colb, segs, stream
    lib.sfvp_wave_render.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(Params), ctypes.c_int, *outs]
    # K1 and K5 take the light table after the scene
    lib.sfvp_regen_render.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(Params),
        ctypes.c_int, *outs]
    # K5 and K9 differ in their tree: the wide BVH or the two-level one
    for fn, tree in ((lib.sfvp_bvh_regen_render, WideParams),
                     (lib.sfvp_tlas_regen_render, TwoLevelParams)):
        fn.argtypes = [ctypes.POINTER(tree), ctypes.c_void_p,
                       ctypes.POINTER(Params), ctypes.c_int, *outs]
    for fn, tree in ((lib.sfvp_bvh_trace, WideParams),
                     (lib.sfvp_bvh_occlusion, WideParams),
                     (lib.sfvp_tlas_trace, TwoLevelParams),
                     (lib.sfvp_tlas_occlusion, TwoLevelParams)):
        fn.argtypes = [ctypes.POINTER(tree), ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    # K6 takes the leaf queue's capacity after the ray count
    lib.sfvp_packet_trace2.argtypes = [
        ctypes.POINTER(WideParams), ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    for fn in (lib.sfvp_wave_render, lib.sfvp_regen_render,
               lib.sfvp_bvh_regen_render, lib.sfvp_tlas_regen_render,
               lib.sfvp_bvh_trace, lib.sfvp_bvh_occlusion,
               lib.sfvp_tlas_trace, lib.sfvp_tlas_occlusion,
               lib.sfvp_packet_trace2):
        fn.restype = ctypes.c_int
    return lib


def launch(fn_name: str, scene, params: Params, has_mirrors: bool,
           n_out: int, lights=None):
    """Launch one render kernel of the library on the current stream of
    the scene's device; ``scene`` is the brute-force table tensor (K1, K2)
    or the WideParams / TwoLevelParams of a device tree (K5, K9). K1, K5
    and K9 take ``lights``, the (16, L) light table (``check_lights``) when
    ``params.use_nee``. Allocates and returns (colr, colg, colb, segs)."""
    if isinstance(scene, (WideParams, TwoLevelParams)):
        device, scene_arg = scene.device, ctypes.byref(scene)
    else:
        device, scene_arg = scene.device, scene.data_ptr()
    args = [scene_arg]
    if fn_name != "sfvp_wave_render":
        args.append(lights.data_ptr() if params.use_nee else None)
    with torch.cuda.device(device):
        fn = getattr(library(), fn_name)
        outs = [torch.empty(n_out, dtype=torch.float32, device=device)
                for _ in range(3)]
        segs = torch.empty(n_out, dtype=torch.int32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, ctypes.byref(params), int(has_mirrors),
                 *(o.data_ptr() for o in outs), segs.data_ptr(), stream)
    check_launch(fn_name, err)
    return (*outs, segs)


def _launch_wave(fn_name: str, wp, rays, out, *extra):
    """Launch a per-ray BVH kernel (K3, K4 with WideParams; K7, K8 with
    TwoLevelParams), or K6 with ``extra`` = (leaf_q,), over the (7, N) ray
    planes into ``out`` on the current stream of the rays' device. N goes
    to the kernel as a C int, so a wave holds fewer than 2**31 rays."""
    n = rays.shape[1]
    if n >= MAX_WAVE_RAYS:
        raise ValueError(f"a wave holds fewer than {MAX_WAVE_RAYS} rays "
                         f"(a C int), got {n}")
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        err = getattr(library(), fn_name)(
            ctypes.byref(wp), rays.data_ptr(), n, *extra, out.data_ptr(),
            stream)
    check_launch(fn_name, err)
    return out


def launch_bvh_trace(wp: "WideParams", rays):
    """K3: (7, N) ray planes in, (19, N) payload planes out."""
    return _launch_wave("sfvp_bvh_trace", wp, rays, torch.empty(
        (19, rays.shape[1]), dtype=torch.float32, device=rays.device))


def launch_packet_trace2(wp: "WideParams", rays, leaf_q: int):
    """K6: (7, N) ray planes in, (19, N) payload planes out, one block per
    packet of 1024 rays with a leaf queue of ``leaf_q`` entries."""
    return _launch_wave("sfvp_packet_trace2", wp, rays, torch.empty(
        (19, rays.shape[1]), dtype=torch.float32, device=rays.device), leaf_q)


def launch_bvh_occlusion(wp: "WideParams", rays):
    """K4: (7, N) ray planes in, (N,) bool out."""
    return _launch_wave("sfvp_bvh_occlusion", wp, rays, torch.empty(
        rays.shape[1], dtype=torch.bool, device=rays.device))


def launch_tlas_trace(tp: "TwoLevelParams", rays):
    """K7: (7, N) world-space ray planes in, (19, N) payload planes out."""
    return _launch_wave("sfvp_tlas_trace", tp, rays, torch.empty(
        (19, rays.shape[1]), dtype=torch.float32, device=rays.device))


def launch_tlas_occlusion(tp: "TwoLevelParams", rays):
    """K8: (7, N) world-space ray planes in, (N,) bool out."""
    return _launch_wave("sfvp_tlas_occlusion", tp, rays, torch.empty(
        rays.shape[1], dtype=torch.bool, device=rays.device))


def check_launch(fn_name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")


def _check_tables(what: str, max_stack: int, tables,
                  leaf_q: int = 0) -> None:
    """What the BVH kernels take: contiguous float32 (rows, 128) tables on
    a CUDA device, fewer than 2**24 rows each (refs are float32),
    max_stack within the kernels' stack; for K6 (``leaf_q``), max_stack +
    leaf_q within its packet stack."""
    cap = MAX_PACKET_STACK if leaf_q else MAX_WIDE_STACK
    if max_stack + leaf_q > cap:
        spill = f" + leaf_q {leaf_q}" if leaf_q else ""
        raise ValueError(
            f"{what} max_stack {max_stack}{spill} exceeds the kernels' "
            f"traversal stack of {cap} entries")
    for name, t in tables:
        if t.shape[0] >= MAX_WIDE_ROWS:
            raise ValueError(f"{what} {name} has {t.shape[0]} rows; refs "
                             f"are float32, exact below {MAX_WIDE_ROWS}")
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA kernels take a CUDA tensor, got "
                             f"{name} on {t.device}")
        if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 128
                or not t.is_contiguous()):
            raise ValueError(f"{what} {name} must be a contiguous float32 "
                             f"(rows, 128) tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")


def wide_params(dw, t_min: float, leaf_q: int = 0) -> WideParams:
    """WideParams of a device BVH (kernels/bvh_packet.py DeviceWide) on a
    CUDA device, after ``_check_tables`` (for K6 with its ``leaf_q``).
    ``.device`` rides along for the launch."""
    _check_tables("wide BVH", dw.max_stack,
                  (("nodes", dw.nodes), ("tris", dw.tris)), leaf_q)
    wp = WideParams(nodes=dw.nodes.data_ptr(), tris=dw.tris.data_ptr(),
                    n_nodes=dw.nodes.shape[0], n_leaf_rows=dw.tris.shape[0],
                    max_stack=dw.max_stack, t_min=f32(t_min),
                    det_eps=_DET_EPS)
    wp.device = dw.nodes.device
    return wp


def two_level_params(dt, t_min: float) -> TwoLevelParams:
    """TwoLevelParams of a device two-level BVH (kernels/bvh_tlas.py
    DeviceTwoLevel) on a CUDA device, after ``_check_tables`` on its node,
    leaf and instance tables. The 2**24 row cap also keeps every leaf-row
    code -(row + 1) above the instance codes -(2**27 + id + 1)."""
    if dt.inst.shape[0] != dt.num_instances:
        raise ValueError(f"two-level BVH has {dt.inst.shape[0]} instance "
                         f"rows for {dt.num_instances} instances")
    _check_tables("two-level BVH", dt.max_stack,
                  (("nodes", dt.nodes), ("tris", dt.tris),
                   ("inst", dt.inst)))
    tp = TwoLevelParams(
        nodes=dt.nodes.data_ptr(), tris=dt.tris.data_ptr(),
        inst=dt.inst.data_ptr(), n_nodes=dt.nodes.shape[0],
        n_leaf_rows=dt.tris.shape[0], n_inst=dt.inst.shape[0],
        max_stack=dt.max_stack, t_min=f32(t_min), det_eps=_DET_EPS)
    tp.device = dt.nodes.device
    return tp


def check_lights(rows, device) -> None:
    """What K1 and K5 take as the light table: a contiguous float32 (16,
    L) tensor (integrate/lights.py LightTable.rows) on the scene's CUDA
    device."""
    if rows.device != torch.device(device):
        raise ValueError(f"light table on {rows.device}, scene on {device}")
    if (rows.dtype != torch.float32 or rows.dim() != 2
            or rows.shape[0] != N_LIGHT_ROWS or rows.shape[1] < 1
            or not rows.is_contiguous()):
        raise ValueError(f"light table must be a contiguous float32 "
                         f"({N_LIGHT_ROWS}, L) tensor, got {rows.dtype} "
                         f"{tuple(rows.shape)}")


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
