"""Primary tube renderer: screen-binned analytic capsule and prism
rasterization.

Counterpart of `linevis_tpu/render/tube_raster.py`: segments render as
pixel-exact capsules (the reference's linear-swept-sphere RT geometry,
`VulkanRayTracer.hpp:53-63`) or as N-gon prisms (its triangle-tube raster
geometry, `Tubes.hpp:40`), driven by the same tile binning. A frame is three
steps: `prepare_capsule_frame` / `prepare_prism_frame` (projection, payload,
binning, params), `rasterize_capsules` / `rasterize_prisms` (the kernel) and
`resolve_capsule_frame` (untile, depth-cue range, shading).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from linevis_tpu_torch.automation.profiling import span
from linevis_tpu_torch.kernels.raster_capsule import rasterize_capsules
from linevis_tpu_torch.kernels.raster_pallas import build_sorted_binning
from linevis_tpu_torch.kernels.raster_prism import ROW_FRAME0, rasterize_prisms
from linevis_tpu_torch.kernels.tiles import unpack_tiles
from linevis_tpu_torch.kernels.volume_common import vdiv
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.handback import hand_back
from linevis_tpu_torch.render.lighting import (
    apply_depth_cue,
    blinn_phong_shade_tube,
    normalize3,
)
from linevis_tpu_torch.render.pipeline import RasterSettings
from linevis_tpu_torch.render.transfer_function import TransferFunction, tf_eval_points

__all__ = [
    "CapsuleScene", "build_capsule_scene", "prepare_capsule_frame",
    "resolve_capsule_frame", "render_tubes", "shade_capsules",
    "camera_tensors", "render_tubes_image",
    "PrismScene", "build_prism_scene", "prepare_prism_frame",
    "render_tubes_prism", "render_tubes_prism_image",
]


@dataclasses.dataclass
class CapsuleScene:
    """Per-segment SoA for the capsule renderer (channels-first tensors).

    a:     [3, S] segment start points
    ba:    [3, S] segment vectors (b - a)
    attr0: [S] attribute at a;  dattr: [S] attr(b) - attr(a)
    mask:  [S] bool, valid segments
    cap_a: [S] 1.0 where the start cap renders (chain starts only: interior
           joint spheres are drawn once, by the previous segment's b-cap)
    radius: float — tube radius
    """

    a: torch.Tensor
    ba: torch.Tensor
    attr0: torch.Tensor
    dattr: torch.Tensor
    mask: torch.Tensor
    cap_a: torch.Tensor
    radius: float

    @property
    def num_segments(self) -> int:
        return int(self.a.shape[1])


def build_capsule_scene(positions, mask, attrs, radius: float, device="cuda") -> CapsuleScene:
    """positions [L, P, 3], mask [L, P], attrs [L, P] -> CapsuleScene on `device`."""
    pos = torch.tensor(np.asarray(positions, np.float32), device=device)
    L, P = pos.shape[0], pos.shape[1]
    cf = pos.reshape(L * P, 3).T.reshape(3, L, P)
    a = cf[:, :, :-1].reshape(3, -1)
    b = cf[:, :, 1:].reshape(3, -1)
    m = torch.tensor(np.asarray(mask, bool), device=device)
    seg2 = m[:, :-1] & m[:, 1:]
    at = torch.tensor(np.asarray(attrs, np.float32), device=device)
    a0 = at[:, :-1].reshape(-1)
    a1 = at[:, 1:].reshape(-1)
    prev_valid = torch.cat(
        [torch.zeros((L, 1), dtype=torch.bool, device=device), seg2[:, :-1]], dim=1
    )
    return CapsuleScene(
        a=a, ba=b - a, attr0=a0, dattr=a1 - a0, mask=seg2.reshape(-1),
        cap_a=(~prev_valid).reshape(-1).float(), radius=float(radius),
    )


def _proj_constants(camera: Camera) -> np.ndarray:
    """[A, Bc] of z_ndc = A - Bc / view_z for the camera's projection."""
    n, f = camera.z_near, camera.z_far
    return np.array([f / (f - n), f * n / (f - n)], np.float32)


def _ray_basis(view_proj: torch.Tensor) -> torch.Tensor:
    """[3, 3] columns (right/tan_x, up/tan_y, forward)."""
    fwd = view_proj[3, :3]
    r = view_proj[0, :3]
    u = view_proj[1, :3]
    tx = torch.linalg.norm(r)
    ty = torch.linalg.norm(u)
    return torch.stack(
        [
            r / torch.clamp(tx * tx, min=1e-12),
            u / torch.clamp(ty * ty, min=1e-12),
            fwd / torch.clamp(torch.linalg.norm(fwd), min=1e-12),
        ],
        dim=1,
    )


def prepare_capsule_frame(
    scene: CapsuleScene,
    view_proj: torch.Tensor,
    camera_position: torch.Tensor,
    proj_ab: torch.Tensor,  # [2] = (A, Bc)
    settings: RasterSettings,
    z_near: float = 1e-3,
    seg_alpha: torch.Tensor = None,
    y_offset=None,
    full_height: int = None,
    aa_margin: float = 0.0,  # extra px of cull slack (coverage-AA callers)
):
    """Project segments, build the sorted tile binning + kernel params.

    Returns (csr, params [32], basis [3, 3]); csr.payload is [24, Np + chunk]
    (16 sorted rows + 8 derived rows). `seg_alpha` [2, S] (alpha0, dalpha)
    fills payload rows 11-12 (the OIT kernel's per-segment alpha).

    With `y_offset` (the full-frame row of band row 0) and `full_height`,
    the segments are projected in full-frame pixels and shifted into the
    band's rows, and `settings.height` is the band's height: the band layout
    of `parallel/mesh.py`. The params' ray basis then carries the band window
    (`up' = up a`, `fwd' = fwd + up c`), so the kernels, which read rows 0-8,
    reconstruct full-frame rays from band-local pixels.
    """
    if (y_offset is None) != (full_height is None):
        raise ValueError("band-local prep takes both y_offset and full_height")
    dev = scene.a.device
    o = camera_position
    a = scene.a
    b = scene.a + scene.ba
    r = scene.radius
    width, height = settings.width, settings.height
    proj_h = height if full_height is None else int(full_height)

    def project(p):  # p [3, S] -> (sx, sy, w)
        clip = view_proj[:3, :3] @ p + view_proj[:3, 3][:, None]
        w = view_proj[3, :3] @ p + view_proj[3, 3]
        iw = 1.0 / torch.where(torch.abs(w) < z_near, torch.full_like(w, z_near), w)
        sx = (clip[0] * iw * 0.5 + 0.5) * width
        sy = (0.5 - clip[1] * iw * 0.5) * proj_h
        if y_offset is not None:
            sy = sy - float(y_offset)
        return sx, sy, w

    with span("capsule.project"):
        sxa, sya, wa = project(a)
    with span("capsule.project"):
        sxb, syb, wb = project(b)
    with span("capsule.payload"):
        wmin = torch.minimum(wa, wb)
        valid = scene.mask & (wmin > z_near)

        # Conservative screen-space radius: r scaled by pixels-per-world-unit
        # at the segment's nearest depth; aa_margin adds the half pixel the
        # coverage AA accepts outside the geometric radius.
        px_per_unit = torch.maximum(
            0.5 * width * torch.linalg.norm(view_proj[0, :3]),
            0.5 * height * torch.linalg.norm(view_proj[1, :3]),
        )
        sr = r * px_per_unit / torch.clamp(wmin - r, min=z_near) + aa_margin
        xmin = torch.minimum(sxa, sxb) - sr
        xmax = torch.maximum(sxa, sxb) + sr
        ymin = torch.minimum(sya, syb) - sr
        ymax = torch.maximum(sya, syb) + sr

        # Payload rows 0-15.
        oa = o[:, None] - a
        ba = scene.ba
        baba = torch.sum(ba * ba, dim=0)
        ob = oa - ba
        obob = torch.sum(ob * ob, dim=0)
        rr = r * r
        Cb = obob - rr
        S = scene.num_segments
        vz_min = torch.clamp(wmin - r, min=z_near)
        zndc_min = proj_ab[0] - proj_ab[1] / vz_min
        zq = torch.floor(torch.clamp(zndc_min, 0.0, 1.0) * 1023.0) / 1023.0
        ones = torch.ones(S, dtype=torch.float32, device=dev)
        if seg_alpha is None:
            alpha0, dalpha = ones, torch.zeros_like(ones)
        else:
            alpha0, dalpha = seg_alpha[0], seg_alpha[1]
        payload = torch.stack(
            [
                oa[0], oa[1], oa[2],
                ba[0], ba[1], ba[2],
                ones * r,
                scene.attr0,
                scene.dattr,
                torch.arange(S, dtype=torch.float32, device=dev),  # row 9: id
                baba,
                alpha0,  # row 11: per-segment alpha (opacity optimization)
                dalpha,  # row 12
                scene.cap_a,  # row 13: render the start cap (chain starts only)
                Cb,
                zq,
            ],
            dim=0,
        ).float()

    csr = build_sorted_binning(
        xmin, xmax, ymin, ymax, payload, valid,
        width, height, settings.tile_w, settings.tile_h, settings.chunk,
        settings.span_x, settings.span_y,
        seg2d=(sxa, sya, sxb, syb, sr),
    )

    with span("capsule.derive"):
        # Derived per-candidate rows 16-23, appended after the sort (pure
        # functions of the sorted geometry rows; the OIT kernels read them).
        p = csr.payload
        poa = p[0:3]
        pba = p[3:6]
        pr = p[6]
        pbaba = p[10]
        baoa0 = pba[0] * poa[0] + pba[1] * poa[1] + pba[2] * poa[2]
        oaoa0 = poa[0] * poa[0] + poa[1] * poa[1] + poa[2] * poa[2]
        inv_baba = 1.0 / torch.clamp(pbaba, min=1e-20)
        prr = pr * pr
        tnorm = torch.rsqrt(torch.clamp(pbaba, min=1e-20))
        inv_r = 1.0 / torch.clamp(pr, min=1e-12)
        derived = torch.stack(
            [baoa0, oaoa0, inv_baba, prr * pbaba, tnorm, inv_r, prr,
             torch.zeros_like(pr)],
            dim=0,
        )
        csr = dataclasses.replace(csr, payload=torch.cat([p, derived], dim=0))

        basis = _ray_basis(view_proj)  # columns right, up, fwd
        if y_offset is not None:
            # Band window: the kernel computes v_band = 1 - y_local (2 / band_h);
            # the full-frame v = a v_band + c with a = band_h / full_h and
            # c = 1 - a - 2 y_offset / full_h, folded into the basis columns. Both
            # in float32, the division an IEEE one on every device.
            f32 = np.float32
            a_win = float(f32(height / proj_h))
            c_win = float(f32(1.0 - height / proj_h)) - vdiv(
                torch.full((), 2.0 * float(f32(y_offset)), dtype=torch.float32, device=dev), proj_h)
            basis = torch.stack(
                [basis[:, 0], basis[:, 1] * a_win, basis[:, 2] + basis[:, 1] * c_win], dim=1)
        # params rows 0-8: B row-major where dir_i = B[i,0]*u + B[i,1]*v + B[i,2].
        # 9 zA, 10 zB, 11 dmin, 12 dmax, 13 depth-cue, 14 opacity scale,
        # 15-18 MBOIT uniforms, 19 px scale: world units per pixel at view
        # depth 1 (coverage AA), 20-22 MBOIT wrapping zone, 23 spare,
        # 24-27 background RGBA (OIT composite mode), 28-31 spare.
        params = torch.zeros(32, dtype=torch.float32, device=dev)
        params[:9] = basis.reshape(-1)
        params[9:11] = proj_ab
        params[19] = (2.0 / height) * torch.linalg.norm(basis[:, 1])
    return csr, params, basis


def resolve_capsule_frame(
    scene: CapsuleScene,
    csr,
    raster,
    view_proj: torch.Tensor,
    camera_position: torch.Tensor,
    proj_ab: torch.Tensor,
    basis: torch.Tensor,
    settings: RasterSettings,
    use_coverage: bool = True,
) -> torch.Tensor:
    """Untile the kernel's output, take the depth-cue range and shade ->
    [4, H, W] linear RGBA. `scene` is a CapsuleScene or a PrismScene; the
    prism raster's binary coverage is not blended (`use_coverage=False`)."""
    depth_t, id_t, gbuf_t = raster

    def unp(x):
        return unpack_tiles(
            x, csr.tiles_x, csr.tiles_y, settings.tile_w, settings.tile_h,
            settings.width, settings.height,
        )

    zndc = unp(depth_t)
    seg_id = unp(id_t)
    attr, nx, ny, nz, tx, ty, tz, cov = (unp(g) for g in gbuf_t)

    # Depth-cue range over segment endpoints (reference DepthCues.hpp).
    w_all = view_proj[3, :3] @ scene.a + view_proj[3, 3]
    big = torch.full_like(w_all, 3e38)
    dmin = torch.min(torch.where(scene.mask, w_all, big))
    dmax = torch.max(torch.where(scene.mask, w_all, -big))

    return shade_capsules(
        zndc, seg_id, attr,
        torch.stack([nx, ny, nz], dim=0), torch.stack([tx, ty, tz], dim=0),
        camera_position, basis, proj_ab, dmin, dmax, settings,
        coverage=cov if use_coverage else None,
    )


def render_tubes(
    scene: CapsuleScene,
    view_proj: torch.Tensor,
    camera_position: torch.Tensor,
    proj_ab: torch.Tensor,  # [2]
    settings: RasterSettings,
) -> torch.Tensor:
    """Render capsules -> [4, H, W] linear RGBA on the scene's device."""
    csr, params, basis = prepare_capsule_frame(
        scene, view_proj, camera_position, proj_ab, settings,
        aa_margin=0.5 if settings.aa else 0.0,
    )
    raster = rasterize_capsules(
        csr, params, settings.width, settings.height,
        settings.tile_w, settings.tile_h, use_aa=settings.aa,
    )
    return resolve_capsule_frame(
        scene, csr, raster, view_proj, camera_position, proj_ab, basis, settings
    )


def shade_capsules(
    zndc, seg_id, attr, normal_raw, tangent_raw, camera_position,
    ray_basis, proj_ab, depth_min, depth_max, settings: RasterSettings,
    coverage=None,
):
    """Elementwise shading from the kernel's G-buffer (no gathers)."""
    H, W = seg_id.shape
    dev = zndc.device
    fg = seg_id >= 0

    # Ray reconstruction for the fragment position.
    u = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5)[None, :] * (2.0 / W) - 1.0
    v = 1.0 - (torch.arange(H, dtype=torch.float32, device=dev) + 0.5)[:, None] * (2.0 / H)
    u = u.expand(H, W)
    v = v.expand(H, W)
    d = (
        ray_basis[:, 0][:, None, None] * u[None]
        + ray_basis[:, 1][:, None, None] * v[None]
        + ray_basis[:, 2][:, None, None]
    )
    view_z = proj_ab[1] / torch.clamp(proj_ab[0] - zndc, min=1e-9)
    # d has unit forward component -> pos = o + d * view_z.
    pos = camera_position[:, None, None] + d * view_z[None]

    normal = normalize3(normal_raw)
    tangent = normalize3(tangent_raw)
    rgb, alpha = tf_eval_points(settings.tf_color, settings.tf_opacity, attr)

    color = blinn_phong_shade_tube(rgb, pos, normal, tangent, camera_position)
    if settings.depth_cue_strength > 0.0:
        color = apply_depth_cue(
            color, view_z, depth_min, depth_max, settings.depth_cue_strength
        )
    bg = torch.tensor(settings.background_color, dtype=torch.float32, device=dev)
    if coverage is not None:
        # Analytic edge AA: blend the fragment over the background by its
        # pixel coverage (interior pixels have coverage 1).
        c = torch.where(fg, coverage, torch.zeros_like(coverage))
        out_rgb = color * c[None] + bg[:3, None, None] * (1.0 - c[None])
        out_a = alpha * c + bg[3] * (1.0 - c)
    else:
        out_rgb = torch.where(fg[None], color, bg[:3, None, None])
        out_a = torch.where(fg, alpha, bg[3])
    return torch.cat([out_rgb, out_a[None]], dim=0)


def camera_tensors(camera: Camera, device):
    """(view_proj [4, 4], position [3], proj_ab [2]) tensors of `camera`."""
    return (
        torch.as_tensor(camera.view_projection_matrix(), device=device),
        torch.as_tensor(np.asarray(camera.position, np.float32), device=device),
        torch.as_tensor(_proj_constants(camera), device=device),
    )


def _render_image(render, scene, device, camera, tf, settings, supersample):
    """Shared host wrapper of the capsule and prism frames: supersampled
    render at k x the resolution and box downsample -> [H, W, 4]."""
    settings = settings or RasterSettings(width=camera.width, height=camera.height)
    cam = camera
    s = settings
    if supersample > 1:
        s = dataclasses.replace(
            settings, width=settings.width * supersample,
            height=settings.height * supersample,
        )
        cam = dataclasses.replace(camera, width=s.width, height=s.height)
    if tf is not None:
        c_pts, o_pts = tf.as_static_points()
        s = dataclasses.replace(s, tf_color=c_pts, tf_opacity=o_pts)
    return hand_back(render(scene, *camera_tensors(cam, device), s), supersample)


def render_tubes_image(
    scene: CapsuleScene,
    camera: Camera,
    tf: Optional[TransferFunction] = None,
    settings: Optional[RasterSettings] = None,
    supersample: int = 1,
) -> np.ndarray:
    """Host convenience wrapper -> numpy [H, W, 4] linear RGBA."""
    return _render_image(
        render_tubes, scene, scene.a.device, camera, tf, settings, supersample
    )


@dataclasses.dataclass
class PrismScene:
    """Per-segment SoA for the N-gon prism renderer: the reference's
    triangle-tube raster geometry (`Tubes.hpp:40`, `LineData.hpp:374-386`)
    rendered analytically (`kernels/raster_prism.py`).

    capsule: the shared segment SoA (binning and payload rows 0-15 reuse
             the capsule pipeline byte for byte; cap_a is forced to 0: the
             triangle tube is open-ended, no cap geometry).
    frames:  [12, S] parallel-transport frames per segment: rows 0-2 normal
             at a, 3-5 binormal at a, 6-8 normal at b, 9-11 binormal at b
             (`geometry/frames.py`, the frames `geometry/tubes.py` places
             ring vertices with).
    """

    capsule: CapsuleScene
    frames: torch.Tensor
    n_sides: int

    @property
    def num_segments(self) -> int:
        return self.capsule.num_segments

    @property
    def radius(self) -> float:
        return self.capsule.radius

    # The fields shared paths read off a scene (depth-cue range).
    @property
    def a(self):
        return self.capsule.a

    @property
    def ba(self):
        return self.capsule.ba

    @property
    def mask(self):
        return self.capsule.mask


def build_prism_scene(
    positions, mask, attrs, radius: float, n_sides: int = 8, device="cuda"
) -> PrismScene:
    """positions [L, P, 3], mask [L, P], attrs [L, P] -> PrismScene on
    `device`. The ring vertices implied by (frames, n_sides, radius) are
    those of `geometry/tubes.py:build_tube_triangle_mesh`."""
    from linevis_tpu_torch.geometry.frames import parallel_transport_frames

    cap = build_capsule_scene(positions, mask, attrs, radius, device=device)
    cap = dataclasses.replace(cap, cap_a=torch.zeros_like(cap.cap_a))
    pos = torch.tensor(np.asarray(positions, np.float32), device=device)
    m = torch.tensor(np.asarray(mask, bool), device=device)
    _, normals, binormals = parallel_transport_frames(pos, m)  # [L, P, 3] each

    def seg_rows(g):  # [L, P, 3] -> a-end [3, S], b-end [3, S]
        L, P = g.shape[0], g.shape[1]
        cf = g.reshape(L * P, 3).T.reshape(3, L, P)
        return cf[:, :, :-1].reshape(3, -1), cf[:, :, 1:].reshape(3, -1)

    na, nb = seg_rows(normals)
    bna, bnb = seg_rows(binormals)
    frames = torch.cat([na, bna, nb, bnb], dim=0).float().contiguous()
    return PrismScene(capsule=cap, frames=frames, n_sides=int(n_sides))


def prepare_prism_frame(
    scene: PrismScene,
    view_proj: torch.Tensor,
    camera_position: torch.Tensor,
    proj_ab: torch.Tensor,
    settings: RasterSettings,
):
    """Capsule binning (the N-gon is inscribed in the capsule, so the
    conservative screen bbox and the exact 2D capsule-vs-tile cull stay
    valid) plus the frame rows, gathered by sorted segment id after the
    sort, so the sort carries the capsule's 16 rows only.

    Returns (csr, params [32], basis [3, 3]); csr.payload is [36, Np + chunk].
    """
    csr, params, basis = prepare_capsule_frame(
        scene.capsule, view_proj, camera_position, proj_ab, settings
    )
    p = csr.payload  # [24, Np + chunk] (16 sorted + 8 derived)
    ids = torch.clamp(p[9].long(), 0, scene.num_segments - 1)
    frame_rows = scene.frames[:, ids]  # [12, Np + chunk]
    csr = dataclasses.replace(
        csr, payload=torch.cat([p[:ROW_FRAME0], frame_rows], dim=0)
    )
    return csr, params, basis


def render_tubes_prism(
    scene: PrismScene,
    view_proj: torch.Tensor,
    camera_position: torch.Tensor,
    proj_ab: torch.Tensor,  # [2]
    settings: RasterSettings,
) -> torch.Tensor:
    """Render N-gon prism tubes -> [4, H, W] linear RGBA on the scene's
    device: the reference's `tubeNumSubdivisions`-gon triangle tube
    silhouette and shading through the capsule binning."""
    csr, params, basis = prepare_prism_frame(
        scene, view_proj, camera_position, proj_ab, settings
    )
    raster = rasterize_prisms(
        csr, params, settings.width, settings.height,
        settings.tile_w, settings.tile_h, n_sides=scene.n_sides,
    )
    return resolve_capsule_frame(
        scene, csr, raster, view_proj, camera_position, proj_ab, basis, settings,
        use_coverage=False,
    )


def render_tubes_prism_image(
    scene: PrismScene,
    camera: Camera,
    tf: Optional[TransferFunction] = None,
    settings: Optional[RasterSettings] = None,
    supersample: int = 1,
) -> np.ndarray:
    """Host convenience wrapper for the prism path -> [H, W, 4] linear.

    The prism raster has binary coverage (the faceted silhouette's edges
    are straight lines, as in the reference's triangle raster + MSAA), so
    `supersample=2` plays the MSAA role."""
    return _render_image(
        render_tubes_prism, scene, scene.a.device, camera, tf, settings, supersample
    )
