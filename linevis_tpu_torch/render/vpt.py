"""Volumetric path tracer over density grids.

Counterpart of `linevis_tpu/render/vpt.py` (reference
`src/Renderers/Scattering/PathTracer/VolumetricPathTracingPass.hpp:59-65`,
`Data/Shaders/Scattering/Clouds/{DeltaTracking,RatioTracking}.glsl`):
free-flight sampling against the majorant with null collisions, the
estimators Delta tracking, Spectral Delta tracking (Kutz et al. 2017,
path-history average probabilities), Ratio tracking, Decomposition tracking
and Residual Ratio tracking, the procedural sky and Phong sun
(`VptUtils.glsl:156-191`) or an environment map, frame accumulation and
the reference's sun defaults (`VolumetricPathTracingPass.hpp:159-161`).

Each mode is one kernel: the three scan modes (Delta, Spectral Delta, Ratio
tracking) R3 (`kernels/vpt_tracking.py`), on a dense grid or a block-sparse
`SparseGrid`; Decomposition tracking R7 (`kernels/vpt_decomposition.py`);
Residual Ratio tracking R8 (`kernels/vpt_residual_ratio.py`). On the card
one launch traces all rays of a sample; on the CPU each kernel's plain
version runs. Every sample comes from jax.random's stream
(`ops/threefry.py`): frame f of the renderer is keyed `PRNGKey(f)`, as in
the JAX renderer, so the port traces the JAX package's paths up to float
rounding.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from linevis_tpu_torch.kernels.volume_common import sky, sun_light, vdiv
from linevis_tpu_torch.kernels.vpt_decomposition import decomposition_params, vpt_decomposition
from linevis_tpu_torch.kernels.vpt_residual_ratio import rr_params, vpt_residual_ratio
from linevis_tpu_torch.kernels.vpt_tracking import SCAN_MODES, vpt_params, vpt_tracking
from linevis_tpu_torch.ops import threefry
from linevis_tpu_torch.render.handback import hand_back
from linevis_tpu_torch.render.super_voxel import super_voxel_grid_of, super_voxel_minmax_of
from linevis_tpu_torch.scene.sparse_grid import SparseGrid

__all__ = ["VptSettings", "vpt_trace_rays", "render_vpt", "VPT_MODES", "sample_skybox",
           "sample_light", "sun_constants", "primary_rays", "VolumetricPathTracerRenderer"]

VPT_MODES = ("Delta Tracking", "Spectral Delta Tracking", "Ratio Tracking",
             "Decomposition Tracking", "Residual Ratio Tracking")


@dataclasses.dataclass(frozen=True)
class VptSettings:
    """Reference defaults (VolumetricPathTracingPass.hpp:155-165)."""

    mode: str = "Delta Tracking"
    extinction: Tuple[float, float, float] = (1024.0, 1024.0, 1024.0)
    scattering_albedo: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    phase_g: float = 0.0
    sun_intensity: float = 2.6
    sun_color: Tuple[float, float, float] = (1.0, 0.961538462, 0.884615385)
    sun_direction: Tuple[float, float, float] = (0.5826, 0.7660, 0.2717)
    max_events: int = 512
    samples_per_frame: int = 2  # VulkanRayTracer-style accumulation
    # Grid interpolation (VolumetricPathTracingPass.hpp:67-74): "Trilinear" |
    # "Nearest" | "Stochastic" (jittered nearest, a box filter in
    # expectation).
    interpolation: str = "Trilinear"
    super_voxel_size: int = 8  # residual ratio tracking (SuperVoxelGrid)


def sample_skybox(w: torch.Tensor) -> torch.Tensor:
    """Procedural sky gradient (VptUtils.glsl:156-186). w: [..., 3]."""
    return torch.stack(sky(w.unbind(-1)), dim=-1)


def sample_light(w: torch.Tensor, sun_dir, sun_intensity_color) -> torch.Tensor:
    """Phong sun lobe, N = 10 (VptUtils.glsl:187-191). w: [..., 3]."""
    return torch.stack(sun_light(w.unbind(-1), _f3(sun_dir), _f3(sun_intensity_color)), dim=-1)


def _f3(v) -> Tuple[float, float, float]:
    return tuple(float(x) for x in np.asarray(v, np.float32).reshape(3))


def vpt_trace_rays(
    key: torch.Tensor,  # int64 [2] threefry key
    grid,  # [Z, Y, X] tensor or SparseGrid
    origins: torch.Tensor,  # [N, 3]
    directions: torch.Tensor,  # [N, 3]
    extinction,  # [3]
    albedo,  # [3]
    sun_dir,  # [3]
    sun_ic,  # [3] intensity * color
    phase_g: float = 0.0,
    mode: str = "Delta Tracking",
    max_events: int = 512,
    interpolation: str = "Trilinear",
    super_voxel_size: int = 8,
    env_map: torch.Tensor = None,  # [He, We, 3] equirectangular radiance
    env_intensity: float = 1.0,
    events: torch.Tensor = None,
):
    """-> (radiance [N, 3], first_scatter_pos [N, 3], first_has [N]) on the
    rays' device. Ray i takes the key `split(key, N)[i]`. With `env_map`,
    escaping rays sample the environment map scaled by `env_intensity`
    (VolumetricPathTracingPass.hpp:169-174) instead of the procedural sky
    and sun. `events` (int32 [N]; not for Residual Ratio tracking) receives
    each ray's events. Decomposition and Residual Ratio tracking build the
    grid's super voxels once (`super_voxel_minmax_of`,
    `super_voxel_grid_of`)."""
    if mode not in VPT_MODES:
        raise ValueError(f"unknown VPT mode {mode!r}")
    dev = origins.device
    key = key.to(dev)
    sparse = isinstance(grid, SparseGrid)
    if sparse and mode not in SCAN_MODES:
        raise NotImplementedError(f"{mode} needs the dense grid (min/max reductions)")
    ext = np.asarray(extinction, np.float32)
    alb = np.asarray(albedo, np.float32)
    env = None if env_map is None else env_map.float()
    o, d = origins.float(), directions.float()
    if mode in SCAN_MODES:
        p = vpt_params(grid.shape, ext, alb, sun_dir, sun_ic, phase_g, mode, max_events,
                       interpolation, env_intensity)
        return vpt_tracking(grid if sparse else grid.float(), o, d, key, p, env, events)
    grid = grid.float()
    if mode == "Decomposition Tracking":
        dmin_g, dmax_g = super_voxel_minmax_of(grid, super_voxel_size)
        p = decomposition_params(grid.shape, dmin_g.shape, ext, alb, _f3(sun_dir), _f3(sun_ic),
                                 phase_g, max_events, env_intensity)
        return vpt_decomposition(grid, dmin_g, dmax_g, o, d, key, p, env, events)
    if events is not None:
        raise ValueError("Residual Ratio tracking counts steps, not events (`vpt_residual_ratio`)")
    sv = super_voxel_grid_of(grid, ext[0], super_voxel_size)
    p = rr_params(grid.shape, sv.mu_c.shape, ext, alb, _f3(sun_dir), _f3(sun_ic), phase_g,
                  env_intensity)
    return vpt_residual_ratio(grid, sv, o, d, key, p, env)


def primary_rays(key: torch.Tensor, ray_origin: torch.Tensor, ray_basis: torch.Tensor,
                 width: int, height: int):
    """One sample's jittered pixel rays (`render_vpt`'s loop body): -> (next
    key, trace key kt, origins [H W, 3], dirs [H W, 3]), the key split
    (key, kj, kt) and the jitter uniform(kj, (2,))."""
    dev = ray_origin.device
    ks = threefry.split(key.to(dev), 3)
    jit_xy = threefry.uniform(ks[1], (2,))
    u = (torch.arange(width, dtype=torch.float32, device=dev) + jit_xy[0]) * (2.0 / width) - 1.0
    v = 1.0 - (torch.arange(height, dtype=torch.float32, device=dev) + jit_xy[1]) * (
        2.0 / height)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    d = [ray_basis[i, 0] * uu + ray_basis[i, 1] * vv + ray_basis[i, 2] for i in range(3)]
    n = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    dirs = torch.stack([(c / n).reshape(-1) for c in d], 1)
    origins = ray_origin.float().reshape(1, 3).expand(dirs.shape[0], 3).contiguous()
    return ks[0], ks[2], origins, dirs


def sun_constants(settings: VptSettings):
    """(sun direction normalised, sun intensity x colour), float32 [3] each,
    as `render_vpt` rounds them."""
    f = np.float32
    sun = np.asarray(settings.sun_direction, f)
    sun_dir = sun / f(np.sqrt(np.sum(sun * sun, dtype=f)))
    return sun_dir, f(settings.sun_intensity) * np.asarray(settings.sun_color, f)


def render_vpt(
    key: torch.Tensor,  # int64 [2] threefry key
    grid,  # [Z, Y, X] tensor or SparseGrid, on the rays' device
    ray_origin: torch.Tensor,  # [3]
    ray_basis: torch.Tensor,  # [3, 3] columns right/up/fwd
    width: int,
    height: int,
    settings: VptSettings = VptSettings(),
    spp: int = 2,
    return_features: bool = False,
    env_map: torch.Tensor = None,  # [He, We, 3] equirectangular radiance
    env_intensity: float = 1.0,
):
    """-> [H, W, 3] linear radiance (the mean of spp jittered samples) on
    the device of `ray_origin`.

    With return_features, also returns (first_scatter_position [H, W, 3],
    first_scatter_valid [H, W]) of the first sample: the reference's
    ScatterEvent feature maps feeding the denoisers."""
    sun_dir, sun_ic = sun_constants(settings)
    acc = None
    for s in range(spp):
        key, kt, origins, dirs = primary_rays(key, ray_origin, ray_basis, width, height)
        radiance, first_x, first_has = vpt_trace_rays(
            kt, grid, origins, dirs, settings.extinction, settings.scattering_albedo, sun_dir,
            sun_ic, phase_g=settings.phase_g, mode=settings.mode,
            max_events=settings.max_events, interpolation=settings.interpolation,
            super_voxel_size=settings.super_voxel_size, env_map=env_map,
            env_intensity=env_intensity)
        acc = radiance if acc is None else acc + radiance
        if s == 0:
            feat_x, feat_has = first_x, first_has
    img = vdiv(acc, spp).reshape(height, width, 3)
    if return_features:
        return img, (feat_x.reshape(height, width, 3), feat_has.reshape(height, width))
    return img


class VolumetricPathTracerRenderer:
    """Registry renderer for RENDERING_MODE_VOLUMETRIC_PATH_TRACER: draws the
    cloud grid of a LineDataScattering scene (or a file-loaded cloud) on
    `device` with frame accumulation (the reference's <= 32 accumulated
    frames, 2 spp a frame); frame f is keyed PRNGKey(f). The settings keys
    `vpt_mode`, `extinction`, `denoiser` (None | EAW | SVGF | SVGF
    (Temporal)), `cloud_file`, `environment_map` and
    `environment_map_intensity` act as in the JAX renderer."""

    name = "Volumetric Path Tracer"

    def __init__(self, settings=None, device="cuda"):
        self.device = torch.device(device)
        self.line_data = None
        self.vpt = VptSettings()
        self.frame = 0
        self._accum = None
        self._features = None
        self.denoiser = "None"
        self._cloud = None  # file-loaded cloud grid (CloudData role)
        self._env_map = None
        self.env_intensity = 1.0
        self._svgf_state = None
        self._prev_vp = None
        if settings is not None:
            self.set_new_settings(settings)

    def _reset(self):
        self._accum = None
        self.frame = 0

    def set_line_data(self, line_data) -> None:
        self.line_data = line_data
        self._reset()

    def set_cloud_data(self, cloud) -> None:
        """Draw a file-loaded cloud grid (`loaders/cloud_loader.py`
        CloudData or a raw [Z, Y, X] array) instead of the line data's."""
        grid = np.asarray(getattr(cloud, "density", cloud), np.float32)
        self._cloud = torch.as_tensor(grid, device=self.device)
        self._reset()

    def set_environment_map(self, env, intensity: float = None) -> None:
        """[He, We, 3] linear equirectangular radiance (None: the procedural
        sky and sun again); VolumetricPathTracingPass.hpp:169-174."""
        self._env_map = (None if env is None
                         else torch.as_tensor(np.asarray(env, np.float32), device=self.device))
        if intensity is not None:
            self.env_intensity = float(intensity)
        self._reset()

    def set_transfer_function(self, tf) -> None:
        pass

    def set_new_settings(self, settings) -> None:
        changed = False
        if settings.has_key("vpt_mode"):
            self.vpt = dataclasses.replace(self.vpt, mode=settings.get_value("vpt_mode"))
            changed = True
        if settings.has_key("extinction"):
            e = settings.get_float("extinction")
            self.vpt = dataclasses.replace(self.vpt, extinction=(e, e, e))
            changed = True
        if settings.has_key("denoiser"):
            self.denoiser = settings.get_value("denoiser")
        if settings.has_key("cloud_file"):
            from linevis_tpu_torch.loaders.cloud_loader import load_cloud_file

            self.set_cloud_data(load_cloud_file(settings.get_value("cloud_file")))
            changed = True
        if settings.has_key("environment_map"):
            from linevis_tpu_torch.render.env_map import load_environment_map

            self.set_environment_map(load_environment_map(settings.get_value("environment_map")))
            changed = True
        if settings.has_key("environment_map_intensity"):
            self.env_intensity = settings.get_float("environment_map_intensity")
            changed = True
        if changed:
            self._reset()

    def _grid(self):
        if self._cloud is not None:
            return self._cloud
        return self.line_data.get_cloud_grid(device=self.device)

    def render(self, camera) -> np.ndarray:
        from linevis_tpu_torch.render.tube_raster import _ray_basis

        dev = self.device
        vp = torch.as_tensor(camera.view_projection_matrix(), device=dev)
        img, (first_x, first_has) = render_vpt(
            threefry.prng_key(self.frame, dev), self._grid(),
            torch.as_tensor(np.asarray(camera.position, np.float32), device=dev),
            _ray_basis(vp), camera.width, camera.height, settings=self.vpt,
            spp=self.vpt.samples_per_frame, return_features=True, env_map=self._env_map,
            env_intensity=self.env_intensity)
        if self.denoiser == "SVGF (Temporal)":
            # Full SVGF (history reprojection and variance accumulation,
            # SVGF.hpp:46,92): converges under a moving camera, the
            # first-scatter positions standing for the geometry.
            from linevis_tpu_torch.render.deferred import motion_vectors
            from linevis_tpu_torch.render.denoiser import svgf_temporal_denoise

            color = img.permute(2, 0, 1)
            pos = torch.where(first_has[None], first_x.permute(2, 0, 1),
                              torch.full_like(color, 1e3))
            if self._prev_vp is None:
                motion = torch.zeros((2,) + tuple(first_has.shape), dtype=torch.float32,
                                     device=dev)
            else:
                motion = motion_vectors(pos, first_has, self._prev_vp)
            out_c, self._svgf_state = svgf_temporal_denoise(color, motion, pos, self._svgf_state)
            self._prev_vp = vp
            self.frame += 1
            out = out_c.permute(1, 2, 0)
            return hand_back(torch.cat([out, torch.ones_like(out[..., :1])], dim=-1),
                             channels_first=False)

        if self._accum is None:
            self._accum = img
        else:
            n = min(self.frame, 31)
            self._accum = vdiv(self._accum * n + img, n + 1)
        if self._features is None:
            self._features = (first_x, first_has)
        self.frame += 1
        out = self._accum
        if self.denoiser != "None":
            out = self._denoise(self._accum)
        return hand_back(torch.cat([out, torch.ones_like(out[..., :1])], dim=-1),
                         channels_first=False)

    def _denoise(self, img_hw3):
        """Feature-guided denoise of the accumulator: the first-scatter
        positions are the position feature map; pixels without a scatter
        get a far-away sentinel, so the position edge-stop separates them
        from the cloud."""
        from linevis_tpu_torch.render.denoiser import eaw_denoise, svgf_denoise

        color = img_hw3.permute(2, 0, 1)
        first_x, first_has = self._features
        pos = torch.where(first_has[None], first_x.permute(2, 0, 1), torch.full_like(color, 1e3))
        fn = svgf_denoise if self.denoiser == "SVGF" else eaw_denoise
        return fn(color, position=pos).permute(1, 2, 0)
