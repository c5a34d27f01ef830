"""Multi-GPU image-space parallelism through torch.distributed.

Counterpart of `linevis_tpu/parallel/mesh.py`, which shards over a JAX
device mesh under `shard_map`. Here a sharded call runs on every rank of a
process group (NCCL on the cards, gloo on the CPU), which it is handed as a
`ProcessGroup` or a 1-D `DeviceMesh` (`make_device_mesh`); it reads its rank
and size from that group and passes the group to every collective. Every
rank holds the whole scene and returns the whole result:
- `render_opaque_sharded` (triangle tubes) and `render_tubes_mlab_sharded`
  (capsules, MLAB) render band r of n horizontal bands of the frame on rank
  r and gather the bands along the rows; geometry is replicated, and each
  band bins what overlaps it, so no fragment crosses ranks. The opaque
  bands take the depth-cue range as the MIN / MAX over the ranks;
- `render_tubes_rtao_sharded` traces num_samples AO rays a pixel on every
  rank, drawn under `fold_in(key, rank)`, and averages the occlusion over
  the ranks (`render/rtao.py`, `psum_axis`);
- `opacity_solve_sharded` gathers importance over band r of the half-res
  frame on rank r and reduces the per-segment minimum and visibility over
  the ranks (`render/opacity_optimization.py`, `band_axis`);
- `render_vpt_sharded` traces `spp` paths a pixel on every rank under
  `fold_in(key, rank)` and averages the radiance over the ranks.

A band body takes its band as plain ints (`band`, `n_bands`), as the JAX
body takes `axis_index`, so band r of n also runs without a group, on one
card, and the bands can be combined there as the collectives would.
`run_ranks` runs a function on n ranks as threads of one process, each with
a process group of its own on one in-memory store (no network port).

Nothing falls back: a sharded call without a group, with a group whose size
differs from the mesh's, or whose backend does not serve the tensors'
device (NCCL for CUDA, gloo for the CPU) raises.
"""

from __future__ import annotations

import dataclasses
import threading
from datetime import timedelta
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from linevis_tpu_torch.geometry.tubes import TubeMesh
from linevis_tpu_torch.kernels import raster_pallas
from linevis_tpu_torch.kernels.raster_pallas import build_csr_binning
from linevis_tpu_torch.kernels.volume_common import vdiv
from linevis_tpu_torch.ops import threefry
from linevis_tpu_torch.render.opaque import _ray_basis_from_view_proj, untile_gbuffer
from linevis_tpu_torch.render.pipeline import (
    GBUFFER_PLANES,
    RasterSettings,
    build_payload,
    shade_gbuffer,
    tube_vertex_stage,
)

__all__ = [
    "BACKENDS",
    "make_device_mesh",
    "group_rank_size",
    "all_reduce",
    "pmean",
    "gather_rows",
    "run_ranks",
    "render_opaque_sharded",
    "render_tubes_mlab_sharded",
    "render_tubes_rtao_sharded",
    "opacity_solve_sharded",
    "render_vpt_sharded",
]

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}  # the backend that serves each device type
RANK_TIMEOUT = timedelta(seconds=300)  # a collective of `run_ranks` waits this long
_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def make_device_mesh(n_devices: Optional[int] = None, axis: str = "y",
                     device_type: str = "cuda"):
    """A 1-D DeviceMesh named `axis` over the `n_devices` ranks of the
    default process group (all of them by default), which must be
    initialised already (torchrun and `init_process_group`) with NCCL for
    "cuda" or gloo for "cpu"."""
    from torch.distributed.device_mesh import init_device_mesh

    if device_type not in BACKENDS:
        raise ValueError(f"make_device_mesh: device_type {device_type!r}, not cuda or cpu")
    if not dist.is_initialized():
        raise RuntimeError("make_device_mesh needs an initialised default process group "
                           "(torchrun, or torch.distributed.init_process_group)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"make_device_mesh: {n} devices on a world of {world} ranks")
    backend = dist.get_backend()
    if backend != BACKENDS[device_type]:
        raise RuntimeError(f"make_device_mesh: {device_type} needs the "
                           f"{BACKENDS[device_type]} backend, the world runs {backend}")
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis,))


def group_rank_size(group, device):
    """The group of a sharded call on tensors of `device`: a ProcessGroup
    (or a bare gloo / NCCL backend) or a 1-D DeviceMesh -> (process group,
    rank, size). Raises on None, a mesh whose group is not its size, or a
    backend that does not serve the device."""
    from torch.distributed.device_mesh import DeviceMesh

    if group is None:
        raise ValueError("a sharded call needs its process group or device mesh")
    if isinstance(group, DeviceMesh):
        if group.ndim != 1:
            raise ValueError(f"a sharded call takes a 1-D device mesh, not {group.ndim}-D")
        pg = group.get_group(0)
        if pg.size() != group.size():
            raise ValueError(f"the mesh holds {group.size()} devices, its group "
                             f"{pg.size()} ranks")
    elif isinstance(group, (dist.ProcessGroup, torch._C._distributed_c10d.Backend)):
        pg = group
    else:
        raise TypeError(f"a sharded call takes a ProcessGroup or DeviceMesh, not "
                        f"{type(group).__name__} (the JAX package's axis names have no "
                        "counterpart here)")
    dev_type = torch.device(device).type
    want = BACKENDS.get(dev_type)
    got = pg.name().lower()
    if got != want:
        raise RuntimeError(f"tensors on {dev_type} need the {want} backend, the group "
                           f"runs {got}")
    return pg, pg.rank(), pg.size()


def all_reduce(x: torch.Tensor, op: str, pg) -> torch.Tensor:
    """x reduced over the group's ranks ("sum", "min" or "max"), a new
    tensor of x's shape on x's device."""
    y = x.detach().clone().contiguous().reshape(-1)
    dist.all_reduce(y, op=_OPS[op], group=pg)
    return y.reshape(x.shape)


def pmean(x: torch.Tensor, pg) -> torch.Tensor:
    """The mean over the group's ranks (`jax.lax.pmean`): their SUM, then one
    float32 division by the group's size, an IEEE one on every device."""
    return vdiv(all_reduce(x, "sum", pg), pg.size())


def gather_rows(band: torch.Tensor, pg) -> torch.Tensor:
    """Each rank's band [C, h, W] -> the frame [C, n h, W], band r at rows
    [r h, (r + 1) h), on every rank."""
    band = band.contiguous()
    parts = [torch.empty_like(band) for _ in range(pg.size())]
    dist.all_gather(parts, band, group=pg)
    return torch.cat(parts, dim=1)


def run_ranks(n: int, fn: Callable, device_type: str = "cpu") -> List:
    """fn(group, device) on n ranks as threads of this process -> [rank r's
    result]. Each rank has a process group of its own on one in-memory
    store: gloo on "cpu"; on "cuda" NCCL with rank r on card r (n at most
    the number of cards). An exception on a rank is raised here once every
    rank has ended (a rank that waits on it in a collective times out
    after RANK_TIMEOUT)."""
    if device_type not in BACKENDS:
        raise ValueError(f"run_ranks: device_type {device_type!r}, not cuda or cpu")
    if device_type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"run_ranks: {n} ranks on {torch.cuda.device_count()} cards; "
                         "NCCL puts one rank on a card")
    store = dist.HashStore()
    out: List = [None] * n
    err: List = [None] * n

    groups: List = [None] * n

    def rank(r):
        try:
            prefixed = dist.PrefixStore("run_ranks/", store)
            if device_type == "cpu":
                pg = dist.ProcessGroupGloo(prefixed, r, n, RANK_TIMEOUT)
                dev = torch.device("cpu")
            else:
                dev = torch.device("cuda", r)
                torch.cuda.set_device(dev)
                opts = dist.ProcessGroupNCCL.Options()
                opts._timeout = RANK_TIMEOUT
                pg = dist.ProcessGroupNCCL(prefixed, r, n, opts)
            groups[r] = pg
            out[r] = fn(pg, dev)
        except BaseException as e:  # handed to the caller below
            err[r] = e

    threads = [threading.Thread(target=rank, args=(r,), name=f"rank{r}") for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for pg in groups:  # every rank has ended: release the groups' connections
        if pg is not None:
            pg.shutdown()
    for e in err:
        if e is not None:
            raise e
    return out


def _check_bands(settings: RasterSettings, n: int) -> None:
    if settings.height % (n * settings.tile_h) != 0:
        raise ValueError(f"height {settings.height} must be divisible by n_devices * tile_h "
                         f"= {n * settings.tile_h}")


def _band_binning(mesh: TubeMesh, view_proj, band_settings: RasterSettings, band: int,
                  n_bands: int):
    """Band `band` of the triangle frame: the vertex stage in full-frame
    pixels, shifted into the band's rows, its payload and CSR binning ->
    (batch, csr)."""
    band_h = band_settings.height
    batch = tube_vertex_stage(mesh, view_proj, band_settings.width, band_h * n_bands)
    batch = dataclasses.replace(batch, tri_y=batch.tri_y - float(band * band_h))
    payload = build_payload(batch)
    csr = build_csr_binning(
        batch.tri_x, batch.tri_y, payload, batch.tri_valid,
        band_settings.width, band_h, band_settings.tile_w, band_settings.tile_h,
        band_settings.chunk, band_settings.span_x, band_settings.span_y,
        band_settings.pairs_capacity,
    )
    return batch, csr


def _render_band(mesh: TubeMesh, view_proj, camera_position, tf_table,
                 band_settings: RasterSettings, band: int, n_bands: int, group=None):
    """Band `band` of `n_bands` of the opaque triangle frame -> [4, band_h,
    W]: binning, the triangle kernel (B3), untile, shading with full-frame
    rays. With `group`, the depth-cue range is the MIN / MAX over its ranks
    (the same on every band of a replicated mesh)."""
    batch, csr = _band_binning(mesh, view_proj, band_settings, band, n_bands)
    raster = raster_pallas.rasterize_gbuffer(
        csr, GBUFFER_PLANES, band_settings.tile_w, band_settings.tile_h
    )
    gbuf, _ = untile_gbuffer(csr, raster, band_settings)
    dmin, dmax = batch.view_z_min, batch.view_z_max
    if group is not None:
        dmin, dmax = all_reduce(dmin, "min", group), all_reduce(dmax, "max", group)
    ray_basis = _ray_basis_from_view_proj(view_proj)
    return _shade_band(gbuf, tf_table, camera_position, ray_basis, dmin, dmax,
                       band_settings, band, n_bands)


def _shade_band(gbuf, tf_table, camera_position, ray_basis, dmin, dmax,
                settings: RasterSettings, band: int, n_bands: int):
    """`shade_gbuffer` of a band: its pixel rows offset to the band's rows
    of the full frame."""
    H = gbuf["id"].shape[0]
    return shade_gbuffer(gbuf, tf_table, camera_position, ray_basis, dmin, dmax, settings,
                         row0=band * H, full_height=H * n_bands)


def render_opaque_sharded(
    mesh: TubeMesh,
    view_proj: torch.Tensor,
    camera_position: torch.Tensor,
    tf_table: torch.Tensor,
    settings: RasterSettings,
    device_mesh,
) -> torch.Tensor:
    """Full-frame render of the tube mesh sharded image-space over
    `device_mesh` (a ProcessGroup or 1-D DeviceMesh) -> [4, H, W] on every
    rank. settings.height must divide evenly by n_devices * tile_h."""
    pg, band, n = group_rank_size(device_mesh, mesh.positions.device)
    _check_bands(settings, n)
    band_settings = dataclasses.replace(settings, height=settings.height // n)
    img = _render_band(mesh, view_proj, camera_position, tf_table, band_settings, band, n,
                       group=pg)
    return gather_rows(img, pg)


def render_tubes_mlab_sharded(
    scene,
    view_proj: torch.Tensor,
    camera_position: torch.Tensor,
    proj_ab: torch.Tensor,
    settings: RasterSettings,
    device_mesh,
    K: int = 8,
    opacity: float = 0.3,
) -> torch.Tensor:
    """Transparent (MLAB) full-frame render sharded image-space: every rank
    bins, renders and composites its own horizontal band of the capsule
    scene (per-pixel OIT needs no exchange between ranks) through
    `render_tubes_mlab`, the band window folded into the kernel's ray basis
    -> [4, H, W] on every rank."""
    from linevis_tpu_torch.render.oit import render_tubes_mlab

    pg, band, n = group_rank_size(device_mesh, scene.a.device)
    _check_bands(settings, n)
    band_settings = dataclasses.replace(settings, height=settings.height // n)
    img = render_tubes_mlab(scene, view_proj, camera_position, proj_ab, band_settings, K=K,
                            opacity=opacity, y_offset=band * band_settings.height,
                            full_height=settings.height)
    return gather_rows(img, pg)


def render_tubes_rtao_sharded(
    scene,
    view_proj: torch.Tensor,
    camera_position: torch.Tensor,
    proj_ab: torch.Tensor,
    settings: RasterSettings,
    device_mesh,
    rtao=None,
    grid=None,
) -> torch.Tensor:
    """Ray-sharded RTAO: n ranks x rtao.num_samples AO rays a pixel, the
    occlusion averaged over the ranks -> [4, H, W] on every rank. The
    G-buffer raster runs on every rank (cheap next to the rays)."""
    from linevis_tpu_torch.kernels.ao_grid import build_segment_grid
    from linevis_tpu_torch.render.rtao import RtaoSettings, render_tubes_rtao

    rtao = rtao or RtaoSettings()
    if grid is None:
        grid = build_segment_grid(scene.a, scene.ba, scene.radius, scene.mask,
                                  resolution=rtao.grid_resolution)
    return render_tubes_rtao(scene, view_proj, camera_position, proj_ab, settings, rtao,
                             grid=grid, psum_axis=device_mesh)


def opacity_solve_sharded(
    scene,
    view_proj: torch.Tensor,
    camera_position: torch.Tensor,
    proj_ab: torch.Tensor,
    prev_vertex_opacity: torch.Tensor,
    settings: RasterSettings,
    oo,
    num_lines: int,
    pts_per_line: int,
    device_mesh,
) -> torch.Tensor:
    """Opacity-optimization steps 1-5 with the importance gather sharded
    image-space and the per-segment reductions as MIN / MAX over the ranks
    -> per-vertex opacities [L, P] on every rank (feed `final_render` or
    `render_tubes_mlab_sharded` with the alpha rows)."""
    from linevis_tpu_torch.render.opacity_optimization import opacity_solve

    return opacity_solve(scene, view_proj, camera_position, proj_ab, prev_vertex_opacity,
                         settings, oo, num_lines, pts_per_line, band_axis=device_mesh)


def render_vpt_sharded(
    key: torch.Tensor,
    grid,  # [Z, Y, X] density
    ray_origin: torch.Tensor,
    ray_basis: torch.Tensor,
    width: int,
    height: int,
    device_mesh,
    settings=None,
    spp: int = 1,
) -> torch.Tensor:
    """Sample-sharded volumetric path tracing: each rank traces `spp`
    jittered paths a pixel under `fold_in(key, rank)` and the radiance is
    averaged over the ranks -> [H, W, 3] on every rank. The estimator is
    unbiased, so n ranks x spp equal one rank x n spp in expectation; the
    grid is replicated."""
    from linevis_tpu_torch.render.vpt import VptSettings, render_vpt

    settings = settings or VptSettings()
    pg, rank, _ = group_rank_size(device_mesh, ray_origin.device)
    img = render_vpt(threefry.fold_in(key, rank), grid, ray_origin, ray_basis, width, height,
                     settings, spp=spp)
    return pmean(img, pg)
