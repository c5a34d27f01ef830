"""Prism frame against triangle frame, pixel by pixel, with float64 oracles.

The prism raster (`kernels/raster_prism.py`) and the triangle raster
(`kernels/raster_pallas.py`) draw the same tube surface. Where their
coverage differs, this module says which of the two is off, and why, by
holding every disputed pixel against oracles evaluated in float64:

- `mesh`: Moller-Trumbore of the pixel's ray (from the camera's float64
  matrices) against the world-space triangles of the mesh;
- `screen`: the pixel centre inside a triangle of the float32 screen
  vertices that the vertex stage produced, edge functions relative to the
  pixel centre;
- `prism`: the plain prism clip (`raster_prism._planes`, `_clip`) on the
  scene's segment and frame data in float64 (`prism_f32`: the same in
  float32, so without the binning that precedes the raster);
and against the triangle raster's own float32 formulation on the payload
rows (`(a*gx + b*gy) + c` for the three edges, and for the depth plane with
its `0 <= z <= 1` test), evaluated apart from binning and kernel.

The candidates of a pixel are the triangles (or prisms) of the segment that
either raster drew there and of its `neighbours` segments on either side of
the same line.

A pixel that the prism frame covers and the triangle frame does not falls in
one class:
- `lost_to_edges`: the mesh covers the centre, the float32 edge functions
  reject it;
- `lost_to_depth_plane`: the mesh covers it, the float32 edges accept it,
  the float32 depth plane puts z outside [0, 1];
- `lost_to_cull`: the mesh covers it and the float32 formulation accepts it,
  but only for triangles that the binning keeps from the pixel's tile: the
  centre lies outside their bounding box, their acceptance is the float32
  rounding's, and the bounding-box culls rightly leave them out;
- `lost_after_binning`: the float32 formulation accepts it for a triangle
  that the binning puts into the pixel's tile, so the CSR fill or the
  kernel dropped it (a fault of the port);
- `prism_wider`: the mesh does not cover it, the float64 prism does (the
  planarized prism reaches beyond the mesh);
- `prism_rounding`: neither the mesh nor the float64 prism covers it.

    python -m linevis_tpu_torch.automation.parity [OUT_JSON]

runs the tornado at 1920x1080 (8 sides, tile 32x16, the first orbit camera of
`chip_smoke.py`) on the card and prints one JSON line.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from linevis_tpu_torch.geometry.tubes import build_tube_triangle_mesh
from linevis_tpu_torch.kernels import raster_pallas
from linevis_tpu_torch.kernels.raster_prism import (
    ROW_FRAME0,
    _clip,
    _planes,
    rasterize_prisms,
    ring_table,
)
from linevis_tpu_torch.kernels.tiles import unpack_tiles
from linevis_tpu_torch.render.pipeline import build_payload, tube_vertex_stage
from linevis_tpu_torch.render.tube_raster import (
    _proj_constants,
    _ray_basis,
    build_prism_scene,
    prepare_prism_frame,
)

__all__ = ["prism_triangle_parity"]


def _candidate_segments(seg, points, neighbours):
    """Segments seg + d, |d| <= neighbours, on the same line -> ([N, D]
    ids, [N, D] bool in range). A line has points - 1 segments."""
    d = torch.arange(-neighbours, neighbours + 1, device=seg.device)
    p = (seg % (points - 1))[:, None] + d[None, :]
    ok = (p >= 0) & (p < points - 1)
    return torch.where(ok, seg[:, None] + d[None, :], seg[:, None]), ok


def _pixel_rays64(xs, ys, basis64, width, height):
    """Unit ray directions [3, N] float64 through the pixel centres."""
    u = (xs.double() + 0.5) * (2.0 / width) - 1.0
    v = 1.0 - (ys.double() + 0.5) * (2.0 / height)
    d = basis64[:, 0:1] * u + basis64[:, 1:2] * v + basis64[:, 2:3]
    return d / torch.linalg.norm(d, dim=0, keepdim=True)


def _mesh_covers(mesh, tris, ok, origin64, dn):
    """float64 Moller-Trumbore: does ray n hit any of its triangles `tris`
    [N, K] in front of the camera?"""
    verts = mesh.vertices.double()
    corner = [verts[:, mesh.triangles[c].long()[tris]] for c in range(3)]  # [3, N, K]
    e1, e2 = corner[1] - corner[0], corner[2] - corner[0]
    d = dn[:, :, None].expand_as(e1)
    pvec = torch.linalg.cross(d, e2, dim=0)
    det = (e1 * pvec).sum(0)
    nz = det.abs() > 1e-300
    inv = 1.0 / torch.where(nz, det, torch.ones_like(det))
    tvec = origin64[:, None, None] - corner[0]
    uu = (tvec * pvec).sum(0) * inv
    qvec = torch.linalg.cross(tvec, e1, dim=0)
    vv = (d * qvec).sum(0) * inv
    tt = (e2 * qvec).sum(0) * inv
    hit = nz & (uu >= 0) & (vv >= 0) & (uu + vv <= 1) & (tt > 0)
    return (hit & ok).any(dim=1)


def _screen_covers(batch, tris, ok, xs, ys):
    """float64 point-in-triangle on the float32 screen vertices."""
    x = batch.tri_x[:, tris].double() - (xs.double() + 0.5)[None, :, None]
    y = batch.tri_y[:, tris].double() - (ys.double() + 0.5)[None, :, None]
    # Edge functions with the pixel centre as the origin: no large constant.
    e = [x[i] * y[j] - x[j] * y[i] for i, j in ((1, 2), (2, 0), (0, 1))]
    area = e[0] + e[1] + e[2]
    pos = (e[0] >= 0) & (e[1] >= 0) & (e[2] >= 0) & (area > 0)
    neg = (e[0] <= 0) & (e[1] <= 0) & (e[2] <= 0) & (area < 0)
    return ((pos | neg) & ok).any(dim=1)


def _binned(batch, tris, xs, ys, settings):
    """Does `build_csr_binning_bbox` put triangle `tris` [N, K] into the
    tile of pixel n? Its on-screen and sub-pixel culls and its span window,
    restated on the triangles' bounding boxes."""
    W, H, tw, th = settings.width, settings.height, settings.tile_w, settings.tile_h
    tiles_x, tiles_y = -(-W // tw), -(-H // th)
    x, y = batch.tri_x[:, tris], batch.tri_y[:, tris]
    xmin, xmax = x.min(dim=0).values, x.max(dim=0).values
    ymin, ymax = y.min(dim=0).values, y.max(dim=0).values
    keep = (xmax >= 0) & (ymax >= 0) & (xmin < W) & (ymin < H)
    keep = keep & (torch.floor(xmax - 0.5) >= torch.ceil(xmin - 0.5))
    keep = keep & (torch.floor(ymax - 0.5) >= torch.ceil(ymin - 0.5))
    tx, ty = (xs // tw)[:, None], (ys // th)[:, None]
    tx0 = raster_pallas._tile_index(xmin, tw, tiles_x)
    tx1 = raster_pallas._tile_index(xmax, tw, tiles_x)
    ty0 = raster_pallas._tile_index(ymin, th, tiles_y)
    ty1 = raster_pallas._tile_index(ymax, th, tiles_y)
    in_x = (tx >= tx0) & (tx <= tx1) & (tx < tx0 + settings.span_x)
    in_y = (ty >= ty0) & (ty <= ty1) & (ty < ty0 + settings.span_y)
    return keep & in_x & in_y


def _formulation_accepts(payload, tris, ok, binned, xs, ys):
    """The triangle raster's float32 tests on the payload rows of `tris`:
    (edges accept, edges and depth plane accept, the same for a triangle
    binned to the pixel's tile), each [N]."""
    gx = (xs.float() + 0.5)[:, None]
    gy = (ys.float() + 0.5)[:, None]

    def functional(r):
        return (payload[r][tris] * gx + payload[r + 1][tris] * gy) + payload[r + 2][tris]

    edges = (functional(0) >= 0.0) & (functional(3) >= 0.0) & (functional(6) >= 0.0) & ok
    z = functional(9)
    accept = edges & (z >= 0.0) & (z <= 1.0)
    return edges.any(dim=1), accept.any(dim=1), (accept & binned).any(dim=1)


def _prism_covers(scene, segs, ok, origin64, dn, dtype=torch.float64):
    """The plain prism clip in `dtype` on segments `segs` [N, D], without
    the binning in front of it."""
    cap = scene.capsule
    flat = segs.reshape(-1)
    rows = [None] * (ROW_FRAME0 + 12)
    oa = origin64.to(dtype)[:, None] - cap.a[:, flat].to(dtype)
    ba = cap.ba[:, flat].to(dtype)
    rows[0:3] = list(oa)
    rows[3:6] = list(ba)
    rows[6] = torch.full_like(oa[0], cap.radius)
    rows[ROW_FRAME0:] = list(scene.frames[:, flat].to(dtype))
    cs = ring_table(scene.n_sides, flat.device).to(dtype)
    D = segs.shape[1]
    rays = tuple(c.to(dtype)[:, None].expand(-1, D).reshape(-1, 1) for c in dn)
    hit, _ = _clip(_planes(rows, scene.n_sides, cs), scene.n_sides, rays)
    return (hit.reshape(segs.shape) & ok & cap.mask[segs]).any(dim=1)


def prism_triangle_parity(
    positions, mask, attrs, radius, camera, settings, n_sides=8, device="cuda",
    neighbours=2, sample=50_000,
) -> dict:
    """Render the lines as prisms and as triangle tubes with `camera`, and
    classify the pixels on which the two frames' coverage differs (module
    docstring). Pixels covered by both (a sample of at most `sample`) are
    the control group: every oracle should accept nearly all of them."""
    W, H = settings.width, settings.height
    tile = (settings.tile_w, settings.tile_h)
    scene = build_prism_scene(positions, mask, attrs, radius, n_sides=n_sides, device=device)
    mesh = build_tube_triangle_mesh(positions, mask, attrs, radius=radius,
                                    num_subdivisions=n_sides, device=device)
    S, L, P = mesh.grid_shape
    vp64 = torch.as_tensor(np.asarray(camera.view_projection_matrix(), np.float64),
                           device=device)
    origin64 = torch.as_tensor(np.asarray(camera.position, np.float64), device=device)
    vp, cp = vp64.float(), origin64.float()
    ab = torch.as_tensor(_proj_constants(camera), device=device)

    csr, params, _ = prepare_prism_frame(scene, vp, cp, ab, settings)
    pz, pid, _ = rasterize_prisms(csr, params, W, H, *tile, n_sides=n_sides)
    batch = tube_vertex_stage(mesh, vp, W, H)
    payload = build_payload(batch)[:16]
    tcsr = raster_pallas.build_csr_binning(
        batch.tri_x, batch.tri_y, payload, batch.tri_valid, W, H, *tile,
        settings.chunk, settings.span_x, settings.span_y, settings.pairs_capacity,
    )
    tz, tid = raster_pallas.rasterize_depth(tcsr, *tile)

    def image(x, c):
        return unpack_tiles(x, c.tiles_x, c.tiles_y, *tile, W, H)

    pid, pz = image(pid, csr), image(pz, csr)
    tid, tz = image(tid, tcsr), image(tz, tcsr)
    p_cov, t_cov = pid >= 0, tid >= 0
    basis64 = _ray_basis(vp64)
    segs_per_tri = L * (P - 1)
    ring = (torch.arange(S, device=device)[:, None] * 2
            + torch.arange(2, device=device)[None, :]).reshape(-1) * segs_per_tri

    def oracles(where, seg_image, limit=None):
        ys, xs = torch.nonzero(where, as_tuple=True)
        if limit is not None and ys.numel() > limit:
            pick = torch.randperm(ys.numel(), device=device,
                                  generator=torch.Generator(device).manual_seed(0))[:limit]
            ys, xs = ys[pick], xs[pick]
        seg = seg_image[ys, xs].long()
        segs, seg_ok = _candidate_segments(seg, P, neighbours)
        tris = (segs[:, :, None] + ring[None, None, :]).reshape(
            seg.shape[0], segs.shape[1] * ring.numel())
        ok = seg_ok[:, :, None].expand(-1, -1, ring.numel()).reshape(tris.shape)
        ok = ok & batch.tri_valid[tris]
        dn = _pixel_rays64(xs, ys, basis64, W, H)
        edges, edges_z, edges_z_binned = _formulation_accepts(
            payload, tris, ok, _binned(batch, tris, xs, ys, settings), xs, ys
        )
        return {
            "ys": ys, "xs": xs,
            "mesh": _mesh_covers(mesh, tris, ok, origin64, dn),
            "screen": _screen_covers(batch, tris, ok, xs, ys),
            "edges": edges, "edges_z": edges_z, "edges_z_binned": edges_z_binned,
            "prism": _prism_covers(scene, segs, seg_ok, origin64, dn),
            "prism_f32": _prism_covers(scene, segs, seg_ok, origin64, dn, torch.float32),
        }

    def shares(o):
        n = int(o["ys"].numel())
        out = {"pixels": n}
        for k in ("mesh", "screen", "edges", "edges_z", "edges_z_binned", "prism",
                  "prism_f32"):
            out[k] = int(o[k].sum())
        return out

    prism_only = oracles(p_cov & ~t_cov, pid)
    # A triangle's segment: tri = ((s * 2 + a) * L + l) * (P - 1) + p.
    tri_only = oracles(t_cov & ~p_cov, tid % segs_per_tri)
    both = oracles(p_cov & t_cov, pid, limit=sample)

    m, e, ez, ezb, pr = (prism_only[k] for k in
                         ("mesh", "edges", "edges_z", "edges_z_binned", "prism"))
    classes = {
        "lost_to_edges": int((m & ~e).sum()),
        "lost_to_depth_plane": int((m & e & ~ez).sum()),
        "lost_to_cull": int((m & ez & ~ezb).sum()),
        "lost_after_binning": int((m & ezb).sum()),
        "prism_wider": int((~m & pr).sum()),
        "prism_rounding": int((~m & ~pr).sum()),
    }
    dz = (tz - pz)[p_cov & t_cov].abs().sort().values

    def dz_at(q):
        return float(dz[int(q * (dz.numel() - 1))]) if dz.numel() else None

    return {
        "width": W, "height": H, "n_sides": n_sides, "neighbours": neighbours,
        "pixels": W * H,
        "prism_covered": int(p_cov.sum()), "triangle_covered": int(t_cov.sum()),
        "prism_only": shares(prism_only), "triangle_only": shares(tri_only),
        "both_sample": shares(both),
        "prism_only_classes": classes,
        # Depth of the two frames where both cover: the triangle raster's
        # float32 depth plane against the prism's ray depth.
        "both_abs_dz_median": dz_at(0.5), "both_abs_dz_p99": dz_at(0.99),
        "both_abs_dz_max": dz_at(1.0),
        "prism_z_median": float(pz[p_cov].median()) if bool(p_cov.any()) else None,
    }


def main(out_json: str = None) -> int:
    import subprocess

    from linevis_tpu_torch.entry import TORNADO_RADIUS, tornado_trajectories
    from linevis_tpu_torch.render.camera import Camera
    from linevis_tpu_torch.render.pipeline import RasterSettings

    if not torch.cuda.is_available():
        raise SystemExit("parity: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    W, H = 1920, 1080
    traj = tornado_trajectories("cuda")
    camera = Camera(position=(0.0, 0.1, 1.2), width=W, height=H).orbit(0.002, 0.1, 1.2)
    result = prism_triangle_parity(
        traj.positions, traj.mask, traj.attributes[:, 0], TORNADO_RADIUS, camera,
        RasterSettings(width=W, height=H, tile_w=32, tile_h=16), device="cuda",
    )
    result["gpu"] = gpu
    line = json.dumps(result)
    if out_json:
        with open(out_json, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(*sys.argv[1:2]))
