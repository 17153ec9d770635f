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
import math
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..camera import lens_frame
from ..config import RenderConfig
from ..integrate.lights import N_LIGHT_ROWS
from ..native import BUILD_DIR
from ..integrate.wavefront import UNIFORM_PDF, UNIFORM_SCALE
from ..sampling import INV_PI, INV_TWO_PI, TWO_PI
from ..utils.vec import f32
from .intersect import _DET_EPS

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)
# shared memory a block of K1 or K2 may opt in to on an H100 (227 KB);
# the table takes its host rows and 6 edge rows per triangle
# (csrc/common.cuh load_table), a tile 9 rows per triangle (load_tile)
MAX_SMEM_BYTES = 232_448
EDGE_ROWS, TILE_ROWS = 6, 9
# triangles of a tile, when the whole table does not fit: 36 KB, so that
# several blocks share an SM
TILE_TRIS = 1024
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
            "total_area", "inv_area", "inv_pi", "uniform_pdf")] + [
        (name, ctypes.c_int) for name in (
            "use_env", "use_env_nee", "env_w", "env_h", "dist_w", "dist_h",
            "use_tex", "rows", "tile")] + [
        (name, ctypes.c_float) for name in (
            "env_inv_patch", "env_pi_over_h", "env_two_pi_over_w",
            "env_h_over_pi", "inv_two_pi", "pi")] + [
        (name, ctypes.c_void_p) for name in (
            "env_r", "env_g", "env_b", "env_cdf", "env_pdf", "tex_r", "tex_g",
            "tex_b", "tex_off", "tex_w", "tex_h")] + [
        (name, ctypes.c_int) for name in ("use_mat", "use_dof")] + [
        (name, ctypes.c_float) for name in ("lens_r", "focus_d")] + [
        (name, ctypes.c_float * 3) for name in (
            "lens_rn", "lens_un", "lens_fwd")]


class WideParams(ctypes.Structure):
    """Mirror of ``sfvp::Wide`` in csrc/wide_bvh.cuh, field for field."""

    _fields_ = [("nodes", ctypes.c_void_p), ("tris", ctypes.c_void_p)] + [
        (name, ctypes.c_int) for name in (
            "n_nodes", "n_leaf_rows", "max_stack")] + [
        (name, ctypes.c_float) for name in ("t_min", "det_eps")] + [
        ("aux", ctypes.c_void_p)]


class TwoLevelParams(ctypes.Structure):
    """Mirror of ``sfvp::TwoLevel`` in csrc/two_level.cuh, field for
    field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "nodes", "tris", "inst")] + [
        (name, ctypes.c_int) for name in (
            "n_nodes", "n_leaf_rows", "n_inst", "max_stack")] + [
        (name, ctypes.c_float) for name in ("t_min", "det_eps")]


def table_plan(num_tris: int, rows: int):
    """(tile, shared-memory bytes) of K1 or K2 over a brute-force table of
    ``rows`` host rows: the whole table and its edges in shared memory
    (tile 0) when they fit MAX_SMEM_BYTES, else tiles of TILE_TRIS
    triangles (csrc/common.cuh tiled_closest)."""
    whole = 4 * (rows + EDGE_ROWS) * num_tris
    if whole <= MAX_SMEM_BYTES:
        return 0, whole
    return TILE_TRIS, 4 * TILE_ROWS * TILE_TRIS


def make_params(cfg: RenderConfig, *, frame: int, row0: int, global_shape,
                npix: int, num_tris: int, tp: int, chunk_idx: int = 0,
                lights=None, env=None, env_dist=None, textures=None,
                rows: int = 20, has_glossy: bool = False,
                has_diel: bool = False) -> Params:
    """Launch parameters; every float is the float32 the twins use.
    ``lights`` (integrate/lights.py LightTable): next-event estimation
    when ``cfg.use_nee``, MIS when ``cfg.use_mis`` too (also with the
    environment's NEE); neither without lights or ``env_dist``. ``env``
    (scene/textures.py TextureTable): the sky of a miss; ``env_dist``
    (lights.env_distribution_for): its NEE under ``cfg.use_nee``;
    ``textures``: the map_Kd pool; ``rows``: the brute-force table's host
    rows; ``has_glossy``, ``has_diel``: the scene has GGX or dielectric
    faces (the kernels built with their shading take it, ``use_mat``);
    an open lens (``cfg.camera.lens_radius > 0``): the kernels built with
    the thin lens take it (``use_dof``) and its float32 frame
    (camera.lens_frame). The tensors must stay alive while the kernel
    runs."""
    gh, gw = global_shape
    vec3 = ctypes.c_float * 3
    cam = cfg.camera
    use_nee = cfg.use_nee and lights is not None
    use_env_nee = cfg.use_nee and env is not None and env_dist is not None
    params = Params(
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
        use_nee=int(use_nee), num_lights=lights.num if use_nee else 0,
        total_area=f32(lights.total_area) if use_nee else 1.0,
        inv_area=lights.inv_area if use_nee else 1.0, inv_pi=INV_PI,
        uniform_pdf=UNIFORM_PDF,
        use_mis=int((use_nee or use_env_nee) and cfg.use_mis),
        use_env_nee=int(use_env_nee), use_tex=int(textures is not None),
        rows=rows, tile=table_plan(num_tris, rows)[0],
        inv_two_pi=INV_TWO_PI, pi=f32(math.pi),
    )
    params.use_mat = int(has_glossy or has_diel)
    if cam.lens_radius > 0.0:
        params.use_dof = 1
        params.lens_r, params.focus_d, rn, un, fwd = lens_frame(cam)
        params.lens_rn, params.lens_un, params.lens_fwd = (
            vec3(*rn), vec3(*un), vec3(*fwd))
    if env is not None:
        set_env(params, env)
    if use_env_nee:
        params.dist_w, params.dist_h = env_dist.width, env_dist.height
        params.env_inv_patch = env_dist.inv_patch
        params.env_pi_over_h = f32(math.pi / env_dist.height)
        params.env_two_pi_over_w = f32(2 * math.pi / env_dist.width)
        params.env_h_over_pi = f32(env_dist.height / math.pi)
        params.env_cdf = env_dist.cdf.data_ptr()
        params.env_pdf = env_dist.pdf_flat.data_ptr()
    if textures is not None:
        for k in ("r", "g", "b"):
            setattr(params, f"tex_{k}", getattr(textures, f"t{k}").data_ptr())
        params.tex_off = textures.off.data_ptr()
        params.tex_w = textures.width.data_ptr()
        params.tex_h = textures.height.data_ptr()
    return params


def set_env(params: Params, env) -> None:
    """The environment map's pool and size in ``params`` (a TextureTable
    on the kernels' device, its texture 0)."""
    params.use_env = 1
    params.env_h, params.env_w = env.shape0()
    params.env_r, params.env_g, params.env_b = (
        c.data_ptr() for c in (env.tr, env.tg, env.tb))


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
    # K2 and K1 take their shared memory after has_mirrors
    lib.sfvp_wave_render.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(Params), ctypes.c_int, ctypes.c_int,
        *outs]
    # K1 and K5 take the light table after the scene
    lib.sfvp_regen_render.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(Params),
        ctypes.c_int, ctypes.c_int, *outs]
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
    # P3 and P4: params, directions, n, mode, float16 map, out, stream
    lib.sfvp_env_fetch.argtypes = [
        ctypes.POINTER(Params), ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    # P2: table, rows, iterations, mode, out, stream; P5: x, out, stream
    lib.sfvp_leaf_probe.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.sfvp_smem_dma.argtypes = [ctypes.c_void_p] * 3
    # P1: tree, rays, n, variant, counts, out, stream
    lib.sfvp_stripped_trace.argtypes = [
        ctypes.POINTER(WideParams), ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    # P6: table, M, iterations, variant, acc0, out, stream
    lib.sfvp_iter_cost.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    for fn in (lib.sfvp_wave_render, lib.sfvp_regen_render,
               lib.sfvp_bvh_regen_render, lib.sfvp_tlas_regen_render,
               lib.sfvp_bvh_trace, lib.sfvp_bvh_occlusion,
               lib.sfvp_tlas_trace, lib.sfvp_tlas_occlusion,
               lib.sfvp_packet_trace2, lib.sfvp_env_fetch,
               lib.sfvp_leaf_probe, lib.sfvp_smem_dma,
               lib.sfvp_stripped_trace, lib.sfvp_iter_cost):
        fn.restype = ctypes.c_int
    return lib


def launch(fn_name: str, scene, params: Params, has_mirrors: bool,
           n_out: int, lights=None):
    """Launch one render kernel of the library on the current stream of
    the scene's device; ``scene`` is the brute-force table tensor (K1, K2)
    or the WideParams / TwoLevelParams of a device tree (K5, K9). K1, K5
    and K9 take ``lights``, the (16, L) light table (``check_lights``) when
    ``params.use_nee``; K1 and K2 their table's shared memory
    (``table_plan``). Allocates and returns (colr, colg, colb, segs)."""
    if isinstance(scene, (WideParams, TwoLevelParams)):
        device, scene_arg = scene.device, ctypes.byref(scene)
    else:
        device, scene_arg = scene.device, scene.data_ptr()
    args = [scene_arg]
    if fn_name != "sfvp_wave_render":
        args.append(lights.data_ptr() if params.use_nee else None)
    args += [ctypes.byref(params), int(has_mirrors)]
    if fn_name in ("sfvp_wave_render", "sfvp_regen_render"):
        args.append(table_plan(params.num_tris, params.rows)[1])
    with torch.cuda.device(device):
        fn = getattr(library(), fn_name)
        outs = [torch.empty(n_out, dtype=torch.float32, device=device)
                for _ in range(3)]
        segs = torch.empty(n_out, dtype=torch.int32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, *(o.data_ptr() for o in outs), segs.data_ptr(),
                 stream)
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


def _payload_planes(wp: "WideParams", rays) -> int:
    """The payload's plane count, after the wave's size check (a wave too
    large raises before anything is allocated)."""
    if rays.shape[1] >= MAX_WAVE_RAYS:
        raise ValueError(f"a wave holds fewer than {MAX_WAVE_RAYS} rays "
                         f"(a C int), got {rays.shape[1]}")
    return wp.n_payload


def launch_bvh_trace(wp: "WideParams", rays):
    """K3: (7, N) ray planes in, (19, N) payload planes out, or (22, N)
    on a textured tree."""
    return _launch_wave("sfvp_bvh_trace", wp, rays, torch.empty(
        (_payload_planes(wp, rays), rays.shape[1]), dtype=torch.float32,
        device=rays.device))


def launch_packet_trace2(wp: "WideParams", rays, leaf_q: int):
    """K6: (7, N) ray planes in, (19, N) payload planes out ((22, N) on a
    textured tree), one block per packet of 1024 rays with a leaf queue of
    ``leaf_q`` entries."""
    return _launch_wave("sfvp_packet_trace2", wp, rays, torch.empty(
        (_payload_planes(wp, rays), rays.shape[1]), dtype=torch.float32,
        device=rays.device), leaf_q)


def launch_stripped_trace(wp: "WideParams", rays, variant: int):
    """P1: (7, N) ray planes in; (3, N) planes t, u, v and the (packets,)
    int32 pops of each packet of 1024 rays out."""
    n = rays.shape[1]
    out = torch.empty((3, n), dtype=torch.float32, device=rays.device)
    counts = torch.empty(-(-n // 1024), dtype=torch.int32,
                         device=rays.device)
    _launch_wave("sfvp_stripped_trace", wp, rays, out, variant,
                 counts.data_ptr())
    return out, counts


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
    CUDA device, after ``_check_tables`` (for K6 with its ``leaf_q``; a
    textured tree's ``tris_aux`` rows with its leaf rows). ``.device`` and
    the payload's plane count ``.n_payload`` ride along for the launch."""
    tables = [("nodes", dw.nodes), ("tris", dw.tris)]
    if dw.tris_aux is not None:
        if dw.tris_aux.shape != dw.tris.shape:
            raise ValueError(f"tris_aux {tuple(dw.tris_aux.shape)} beside "
                             f"tris {tuple(dw.tris.shape)}")
        tables.append(("tris_aux", dw.tris_aux))
    _check_tables("wide BVH", dw.max_stack, tables, leaf_q)
    wp = WideParams(nodes=dw.nodes.data_ptr(), tris=dw.tris.data_ptr(),
                    n_nodes=dw.nodes.shape[0], n_leaf_rows=dw.tris.shape[0],
                    max_stack=dw.max_stack, t_min=f32(t_min),
                    det_eps=_DET_EPS,
                    aux=None if dw.tris_aux is None
                    else dw.tris_aux.data_ptr())
    wp.device = dw.nodes.device
    wp.n_payload = dw.n_payload
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
    """What K1 and K2 take: a contiguous float32 (20, Tp) scene table, or
    (27, Tp) with the texture rows, on a CUDA device, with 0 < num_tris <=
    Tp. A table past the shared memory a block may hold goes through it in
    tiles (``table_plan``)."""
    if table.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take a CUDA tensor, got "
                         f"{table.device}")
    if table.dtype != torch.float32:
        raise ValueError(f"scene table must be float32, got {table.dtype}")
    if (table.dim() != 2 or table.shape[0] not in (20, 27)
            or not table.is_contiguous()):
        raise ValueError(f"scene table must be a contiguous (20, Tp) or "
                         f"(27, Tp) tensor, got {tuple(table.shape)}")
    if not 0 < num_tris <= table.shape[1]:
        raise ValueError(f"num_tris={num_tris} outside 1..{table.shape[1]}")


def check_env(env, device) -> None:
    """What the kernels take as an environment map or texture pool: its
    float32 planes and int32 descriptors contiguous on ``device``."""
    for name, t, dtype in (("tr", env.tr, torch.float32),
                           ("tg", env.tg, torch.float32),
                           ("tb", env.tb, torch.float32),
                           ("off", env.off, torch.int32),
                           ("width", env.width, torch.int32),
                           ("height", env.height, torch.int32)):
        if (t.device != torch.device(device) or t.dtype != dtype
                or not t.is_contiguous()):
            raise ValueError(f"texture table {name}: {t.dtype} on "
                             f"{t.device}, the kernels take contiguous "
                             f"{dtype} on {device}")


def launch_env_fetch(params: Params, dirs, mode: int, half_map=None):
    """P3 (mode 0) or a P4 variant (1 trig, 2 noread, 3 half, with the
    (3, H*W) float16 ``half_map``): (3, N) direction planes in, (3, N)
    planes out, on the current stream of the directions' device."""
    n = dirs.shape[1]
    if n >= MAX_WAVE_RAYS:
        raise ValueError(f"a wave holds fewer than {MAX_WAVE_RAYS} rays")
    out = torch.empty((3, n), dtype=torch.float32, device=dirs.device)
    with torch.cuda.device(dirs.device):
        stream = torch.cuda.current_stream(dirs.device).cuda_stream
        err = library().sfvp_env_fetch(
            ctypes.byref(params), dirs.data_ptr(), n, mode,
            None if half_map is None else half_map.data_ptr(),
            out.data_ptr(), stream)
    check_launch("sfvp_env_fetch", err)
    return out
