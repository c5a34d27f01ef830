"""Renderer base class + rendering-mode registry: the port's user entry point.

Counterpart of `linevis_tpu/render/renderer.py` (reference abstract
`LineRenderer`, `src/Renderers/LineRenderer.hpp:66`, the mode enum
`RenderingModes.hpp:32-52` and the factory switch of `MainApp::setRenderer`,
`MainApp.cpp:732-862`):

    r = create_renderer("Opacity Optimization", settings, device="cuda")
    r.set_line_data(line_data)
    img = r.render(camera)  # numpy [H, W, 4] linear RGBA

Every renderer draws on `device` (the card unless the caller asks for the
CPU), from the line data's representations built there; the port draws
every mode the JAX package registers (`UNPORTED_MODES`, the modes it could
not draw yet, is empty). Unknown modes fall back to Opaque with a warning
(`MainApp.cpp:864-874`). The scattering modes ("Line Density Map
Renderer", "Spherical Heat Map Renderer", "Volumetric Path Tracer") draw a
`scene/line_data_scattering.py:LineDataScattering`; "Voxel Ray Casting"
any line data. "Deferred Opaque" lives in
`render/deferred.py`, which imports this module, so it is resolved on first
use, as in the JAX registry. "Opaque (Triangle Mesh)" draws a
`scene/triangle_mesh_data.py:TriangleMeshData` (its renderer lives there).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional, Type

import numpy as np
import torch

from linevis_tpu_torch.core.settings import SettingsMap
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.line_density_map import LineDensityMapRenderer
from linevis_tpu_torch.render.pipeline import RasterSettings
from linevis_tpu_torch.render.spherical_heatmap import SphericalHeatMapRenderer
from linevis_tpu_torch.render.transfer_function import TransferFunction
from linevis_tpu_torch.render.tube_raster import camera_tensors
from linevis_tpu_torch.render.vpt import VolumetricPathTracerRenderer
from linevis_tpu_torch.render.vrc import VoxelRayCastingRenderer
from linevis_tpu_torch.scene.line_data import LineData
from linevis_tpu_torch.scene.triangle_mesh_data import TriangleMeshRenderer

__all__ = [
    "LineRenderer",
    "RENDERING_MODE_ALL",
    "UNPORTED_MODES",
    "create_renderer",
    "register_renderer",
]


def _image(img: torch.Tensor) -> np.ndarray:
    """[4, H, W] tensor -> numpy [H, W, 4]."""
    return np.moveaxis(img.cpu().numpy(), 0, -1)


class LineRenderer:
    """Base renderer: owns settings, caches per-scene state."""

    name = "Base"

    def __init__(self, settings: Optional[SettingsMap] = None, device="cuda"):
        self.device = torch.device(device)
        self.line_data: Optional[LineData] = None
        self.transfer_function = TransferFunction.standard()
        self.transfer_function_range = None  # (vmin, vmax) in attr space
        self.depth_cue_strength = 0.0
        self.opacity = 0.3
        self.settings = SettingsMap()
        if settings:
            self.set_new_settings(settings)

    # -- lifecycle (LineRenderer.hpp) ---------------------------------------
    def set_line_data(self, line_data: LineData) -> None:
        self.line_data = line_data

    def set_transfer_function(self, tf: TransferFunction) -> None:
        self.transfer_function = tf

    def set_new_settings(self, settings: SettingsMap) -> None:
        self.settings.update(settings)
        if settings.has_key("depth_cue_strength"):
            self.depth_cue_strength = settings.get_float("depth_cue_strength")
        if settings.has_key("opacity"):
            self.opacity = settings.get_float("opacity")

    # Tile shape: the opaque kernels take 32x16 tiles, the OIT kernels 16x8
    # (the JAX package's choice; the port keeps its tiles).
    TILE_W, TILE_H = 32, 16

    def _raster_settings(self, camera: Camera) -> RasterSettings:
        c_pts, o_pts = self.transfer_function.as_static_points()
        if self.transfer_function_range is not None:
            # Remap TF control points into [vmin, vmax] of the normalized
            # attribute (reference set_transfer_functions_range,
            # ReplayWidget.cpp:576-624 -> TransferFunctionWindow range).
            vmin, vmax = self.transfer_function_range
            span = vmax - vmin

            def remap(pts):
                inner = tuple((vmin + p[0] * span,) + tuple(p[1:]) for p in pts)
                # Clamp outside [vmin, vmax] to the edge values.
                return ((0.0,) + tuple(pts[0][1:]),) + inner + ((1.0,) + tuple(pts[-1][1:]),)

            c_pts, o_pts = remap(c_pts), remap(o_pts)
        return RasterSettings(
            width=camera.width,
            height=camera.height,
            tile_w=self.TILE_W,
            tile_h=self.TILE_H,
            depth_cue_strength=self.depth_cue_strength,
            tf_color=c_pts,
            tf_opacity=o_pts,
        )

    def _capsules(self):
        return self.line_data.get_capsule_scene(device=self.device)

    def render(self, camera: Camera) -> np.ndarray:
        """Render a frame -> [H, W, 4] linear RGBA numpy array."""
        raise NotImplementedError


class OpaqueLineRenderer(LineRenderer):
    """Reference RENDERING_MODE_OPAQUE (`OpaqueLineRenderer.hpp:40`).

    The `tubeGeometry` setting selects the raster geometry: 'capsule' (the
    default; analytic linear-swept spheres with coverage AA), 'prism' (the
    reference's `tubeNumSubdivisions`-gon triangle tube rendered by the
    prism kernel, 2x supersampled) or 'triangle' (the same geometry through
    the triangle G-buffer raster, 2x supersampled)."""

    name = "Opaque"

    def set_new_settings(self, settings: SettingsMap) -> None:
        super().set_new_settings(settings)
        if settings.has_key("tubeGeometry"):
            v = settings.get_value("tubeGeometry")
            if v not in ("capsule", "prism", "triangle"):
                raise ValueError(f"tubeGeometry {v!r}")

    @property
    def tube_geometry(self) -> str:
        return self.settings.get_value("tubeGeometry", "capsule")

    def render(self, camera: Camera) -> np.ndarray:
        subdiv = int(self.settings.get_float("tubeNumSubdivisions", 8))
        if self.tube_geometry == "prism":
            from linevis_tpu_torch.render.tube_raster import render_tubes_prism_image

            scene = self.line_data.get_prism_scene(num_subdivisions=subdiv, device=self.device)
            return render_tubes_prism_image(
                scene, camera, tf=self.transfer_function,
                settings=self._raster_settings(camera), supersample=2,
            )
        if self.tube_geometry == "triangle":
            from linevis_tpu_torch.render.opaque import render_opaque_image

            mesh = self.line_data.get_tube_mesh(num_subdivisions=subdiv, device=self.device)
            s = dataclasses.replace(self._raster_settings(camera), tile_w=32, tile_h=16)
            return render_opaque_image(mesh, camera, tf=self.transfer_function, settings=s,
                                       supersample=2)
        from linevis_tpu_torch.render.tube_raster import render_tubes_image

        return render_tubes_image(self._capsules(), camera,
                                  settings=self._raster_settings(camera))


class _OitBase(LineRenderer):
    """The transparent renderers of `render/oit.py`, each called with the
    scene, the camera's tensors on the device and the raster settings."""

    TILE_W, TILE_H = 16, 8

    def _frame(self, camera: Camera, fn, **kw) -> torch.Tensor:
        return fn(self._capsules(), *camera_tensors(camera, self.device),
                  self._raster_settings(camera), **kw)


class MLABRenderer(_OitBase):
    """Reference RENDERING_MODE_MLAB (8 nodes default)."""

    name = "Multi-Layer Alpha Blending"
    K = 8

    def render(self, camera: Camera) -> np.ndarray:
        from linevis_tpu_torch.render.oit import render_tubes_mlab

        return _image(self._frame(camera, render_tubes_mlab, K=self.K, opacity=self.opacity))


class PerPixelLinkedListRenderer(MLABRenderer):
    """Reference RENDERING_MODE_PER_PIXEL_LINKED_LIST: the exact K-nearest
    sorted blend with K=32 (a bounded-memory stand-in for the unbounded
    linked list, equal for depth complexity <= K)."""

    name = "Per-Pixel Linked Lists"
    K = 32


class WBOITRenderer(_OitBase):
    """Reference RENDERING_MODE_WBOIT (WBOITRenderer.cpp:195)."""

    name = "Weighted Blended Order Independent Transparency"

    def render(self, camera: Camera) -> np.ndarray:
        from linevis_tpu_torch.render.oit import render_tubes_wboit

        return _image(self._frame(camera, render_tubes_wboit, opacity=self.opacity))


class AtomicLoop64Renderer(_OitBase):
    """Reference RENDERING_MODE_ATOMIC_LOOP_64 (AtomicLoop64Renderer.cpp:283):
    exact K-nearest fragments, no overflow merge."""

    name = "Atomic Loop 64-Bit"
    K = 16

    def render(self, camera: Camera) -> np.ndarray:
        from linevis_tpu_torch.render.oit import render_tubes_atomic_loop

        return _image(self._frame(camera, render_tubes_atomic_loop, K=self.K,
                                  opacity=self.opacity))


class DepthPeelingRenderer(_OitBase):
    """Reference RENDERING_MODE_DEPTH_PEELING (DepthPeelingRenderer.cpp:423):
    exact front-to-back peeling, K layers per pass x 4 passes."""

    name = "Depth Peeling"

    def render(self, camera: Camera) -> np.ndarray:
        from linevis_tpu_torch.render.oit import render_tubes_depth_peeling

        return _image(self._frame(camera, render_tubes_depth_peeling, opacity=self.opacity))


class MLABBucketRenderer(_OitBase):
    """Reference RENDERING_MODE_MLAB_BUCKETS: exact near bucket + MLAB-merged
    far bucket."""

    name = "MLAB (Buckets)"

    def render(self, camera: Camera) -> np.ndarray:
        from linevis_tpu_torch.render.oit import render_tubes_mlab_buckets

        return _image(self._frame(camera, render_tubes_mlab_buckets, opacity=self.opacity))


class MBOITRenderer(_OitBase):
    """Reference RENDERING_MODE_MBOIT (MBOITRenderer.cpp:688): 4 moments,
    float32, power moments by default; `usePowerMoments = false` switches to
    trigonometric moments."""

    name = "Moment-Based OIT"
    n_mom = 4
    use_power_moments = True
    pixel_format = "float32"

    def set_new_settings(self, settings: SettingsMap) -> None:
        super().set_new_settings(settings)
        if settings.has_key("numMoments"):
            self.n_mom = settings.get_int("numMoments")
        if settings.has_key("usePowerMoments"):
            self.use_power_moments = settings.get_bool("usePowerMoments")
        if settings.has_key("pixelFormat"):
            # Reference values: "Float" -> FLOAT_32, else UNORM_16
            # (MBOITRenderer.cpp:286).
            fmt = str(settings.get_value("pixelFormat"))
            self.pixel_format = "float32" if fmt.lower().startswith("float") else "unorm16"

    def render(self, camera: Camera) -> np.ndarray:
        from linevis_tpu_torch.render.oit import render_tubes_mboit

        return _image(self._frame(
            camera, render_tubes_mboit, n_mom=self.n_mom, opacity=self.opacity,
            trigonometric=not self.use_power_moments, pixel_format=self.pixel_format))


class DepthComplexityRenderer(_OitBase):
    """Reference RENDERING_MODE_DEPTH_COMPLEXITY: fragment counts mapped to
    a color ramp (DepthComplexityRenderer.cpp:346)."""

    name = "Depth Complexity"
    TILE_W, TILE_H = 32, 16  # the base's tiles, as in the JAX registry

    def render(self, camera: Camera) -> np.ndarray:
        from linevis_tpu_torch.render.oit import render_depth_complexity

        counts = self._frame(camera, render_depth_complexity)
        t = counts / torch.clamp(counts.max(), min=1.0)
        img = self.transfer_function.lookup(t)
        img[..., 3] = 1.0
        bg = torch.tensor(self._raster_settings(camera).background_color,
                          dtype=torch.float32, device=img.device)
        img = torch.where((counts == 0)[..., None], bg, img)
        return img.cpu().numpy()


def _halton(index: int, base: int) -> float:
    """Low-discrepancy sequence of the jittered sampling offsets (reference
    VulkanRayTracer.hpp:135-143 jittered accumulation)."""
    f, r = 1.0, 0.0
    while index > 0:
        f /= base
        r += f * (index % base)
        index //= base
    return r


class VulkanRayTracerRenderer(LineRenderer):
    """Reference RENDERING_MODE_VULKAN_RAY_TRACER (VulkanRayTracer.*):
    analytic capsules over a binary BVH (`bvhBuildAlgorithm`: "linear",
    "binned_sah", "sweep_sah" or "ploc"; built once per scene) with the
    iterative re-cast loop (`render_tubes_raytraced`, up to
    `max_depth_complexity` surfaces, default 32) or, with `use_mlat`, MLAT
    (`render_tubes_mlat`, `num_nodes` nodes, default 8). Frame 0 is
    unjittered; later frames take Halton(2, 3) subpixel offsets and
    accumulate over up to 32 frames; the accumulator resets on a camera or
    scene change."""

    name = "Vulkan Ray Tracer"
    MAX_ACCUM_FRAMES = 32

    def __init__(self, settings=None, device="cuda"):
        super().__init__(settings, device)
        self._accum = None
        self._frame = 0
        self._last_vp = None
        self._bvh = None

    def set_line_data(self, line_data: LineData) -> None:
        super().set_line_data(line_data)
        self._accum = None
        self._frame = 0
        self._bvh = None

    def render(self, camera: Camera) -> np.ndarray:
        from linevis_tpu_torch.ops.lbvh import lbvh_on
        from linevis_tpu_torch.render.ray_tracer import (
            build_capsule_bvh,
            render_tubes_mlat,
            render_tubes_raytraced,
        )

        scene = self._capsules()
        vp_np = np.asarray(camera.view_projection_matrix())
        if self._last_vp is None or not np.array_equal(self._last_vp, vp_np):
            self._accum = None
            self._frame = 0
            self._last_vp = vp_np
        if self._bvh is None:
            builder = str(self.settings.get_value("bvhBuildAlgorithm", "linear"))
            self._bvh = lbvh_on(build_capsule_bvh(scene, builder=builder), self.device)
        if self._frame == 0:
            jitter = torch.zeros(2, dtype=torch.float32, device=self.device)
        else:
            jitter = torch.tensor([_halton(self._frame, 2) - 0.5, _halton(self._frame, 3) - 0.5],
                                  dtype=torch.float32, device=self.device)
        common = dict(settings=self._raster_settings(camera), opacity=self.opacity,
                      bvh=self._bvh, jitter=jitter)
        cam = camera_tensors(camera, self.device)
        if self.settings.get_bool("use_mlat", False):
            img = render_tubes_mlat(scene, *cam, K=self.settings.get_int("num_nodes", 8),
                                    **common)
        else:
            img = render_tubes_raytraced(
                scene, *cam,
                max_depth_complexity=self.settings.get_int("max_depth_complexity", 32),
                **common)
        if self._accum is None:
            self._accum = img
        else:
            n = min(self._frame, self.MAX_ACCUM_FRAMES - 1)
            self._accum = (self._accum * n + img) / (n + 1)
        self._frame += 1
        return _image(self._accum)


class RtaoRenderer(LineRenderer):
    """Ray-traced ambient occlusion (reference
    VulkanRayTracedAmbientOcclusion.cpp:743) with per-frame sample
    accumulation (<= 32 frames), reset on camera or scene changes. Frame f
    draws the JAX registry's samples, jax.random's stream under
    PRNGKey(RtaoSettings.seed + f) (`render_tubes_rtao`), on the renderer's
    device: the same rays on the card, on the CPU and in the JAX package.

    The settings key `denoiser` = "SVGF (Temporal)" replaces the
    static-camera accumulator with temporal SVGF (history reprojection by
    the deferred path's motion vectors and variance-guided filtering,
    SVGF.hpp:46,92), whose state stays on the device: a camera move neither
    resets it nor restarts the frame count, so the noise keeps converging
    while the camera moves. As in the JAX registry, no other value of the
    key changes the frame ("EAW" and "Spatial Hashing" are
    `RtaoSettings.denoiser` options of `render_tubes_rtao`)."""

    name = "RTAO"
    MAX_ACCUM_FRAMES = 32

    def __init__(self, settings=None, device="cuda"):
        super().__init__(settings, device)
        self._reset()

    def _reset(self):
        self._accum = None
        self._frame = 0
        self._last_vp = None
        self._grid = None
        self._svgf_state = None
        self._prev_vp = None

    def set_line_data(self, line_data: LineData) -> None:
        super().set_line_data(line_data)
        self._reset()

    def render(self, camera: Camera) -> np.ndarray:
        from linevis_tpu_torch.kernels.ao_grid import build_segment_grid
        from linevis_tpu_torch.render.rtao import RtaoSettings, render_tubes_rtao

        scene = self._capsules()
        vp_np = np.asarray(camera.view_projection_matrix())
        use_temporal = self.settings.get_value("denoiser", "") == "SVGF (Temporal)"
        if self._last_vp is None or not np.array_equal(self._last_vp, vp_np):
            self._accum = None
            if not use_temporal:
                self._frame = 0  # temporal SVGF survives camera motion
            self._last_vp = vp_np
        rtao = RtaoSettings()
        if self._grid is None:
            self._grid = build_segment_grid(scene.a, scene.ba, scene.radius, scene.mask,
                                            resolution=rtao.grid_resolution)
        cam = camera_tensors(camera, self.device)
        if use_temporal:
            from linevis_tpu_torch.render.deferred import motion_vectors
            from linevis_tpu_torch.render.denoiser import svgf_temporal_denoise

            img, (pos, normal, fg) = render_tubes_rtao(
                scene, *cam, self._raster_settings(camera), rtao, frame=self._frame,
                grid=self._grid, return_features=True)
            if self._prev_vp is None:
                motion = torch.zeros((2,) + tuple(fg.shape), dtype=torch.float32,
                                     device=self.device)
            else:
                motion = motion_vectors(pos, fg, self._prev_vp)
            out, self._svgf_state = svgf_temporal_denoise(img[:3], motion, pos,
                                                          self._svgf_state, normal=normal)
            self._prev_vp = cam[0]
            self._frame += 1
            return _image(torch.cat([out, img[3:4]]))
        img = render_tubes_rtao(scene, *cam, self._raster_settings(camera), rtao,
                                frame=self._frame, grid=self._grid)
        if self._accum is None:
            self._accum = img
        else:
            n = min(self._frame, self.MAX_ACCUM_FRAMES - 1)
            self._accum = (self._accum * n + img) / (n + 1)
        self._frame += 1
        return _image(self._accum)


class OpacityOptimizationRendererMode(LineRenderer):
    """Reference RENDERING_MODE_OPACITY_OPTIMIZATION: the stateful
    `render/opacity_optimization.py` renderer on the line data's capsules."""

    name = "Opacity Optimization"

    def __init__(self, settings=None, device="cuda"):
        super().__init__(settings, device)
        self._impl = None

    def set_line_data(self, line_data: LineData) -> None:
        super().set_line_data(line_data)
        self._impl = None

    def render(self, camera: Camera) -> np.ndarray:
        from linevis_tpu_torch.render.opacity_optimization import (
            OpacityOptimizationRenderer as Impl,
        )

        if self._impl is None:
            traj = self.line_data.trajectories
            self._impl = Impl(self._capsules(), traj.num_lines, traj.max_points,
                              self._raster_settings(camera))
        return _image(self._impl.render(camera))


_REGISTRY: Dict[str, Type[LineRenderer]] = {}


def register_renderer(mode_name: str, cls: Type[LineRenderer]) -> None:
    _REGISTRY[mode_name] = cls


# Mode names follow RenderingModes.hpp:32-52, in the JAX registry's order.
register_renderer("Opaque", OpaqueLineRenderer)
register_renderer("Per-Pixel Linked Lists", PerPixelLinkedListRenderer)
register_renderer("Multi-Layer Alpha Blending", MLABRenderer)
register_renderer("Weighted Blended Order Independent Transparency", WBOITRenderer)
register_renderer("WBOIT", WBOITRenderer)  # RENDERING_MODE_NAMES[8]
register_renderer("Moment-Based OIT", MBOITRenderer)
register_renderer("Depth Peeling", DepthPeelingRenderer)
register_renderer("Atomic Loop 64-Bit", AtomicLoop64Renderer)
register_renderer("MLAB (Buckets)", MLABBucketRenderer)
register_renderer("Depth Complexity", DepthComplexityRenderer)
register_renderer("Opacity Optimization", OpacityOptimizationRendererMode)
register_renderer("Vulkan Ray Tracer", VulkanRayTracerRenderer)
register_renderer("RTAO", RtaoRenderer)
register_renderer("Line Density Map Renderer", LineDensityMapRenderer)
register_renderer("Spherical Heat Map Renderer", SphericalHeatMapRenderer)
register_renderer("Voxel Ray Casting", VoxelRayCastingRenderer)
register_renderer("Volumetric Path Tracer", VolumetricPathTracerRenderer)
register_renderer("Opaque (Triangle Mesh)", TriangleMeshRenderer)

# Modes whose module imports this one: resolved on first use.
_LAZY_REGISTRY: Dict[str, tuple] = {
    "Deferred Opaque": ("linevis_tpu_torch.render.deferred", "DeferredOpaqueRenderer"),
}

# Modes of the JAX registry the port cannot draw yet -> their ROADMAP queue
# A item (none left).
UNPORTED_MODES: Dict[str, str] = {}

RENDERING_MODE_ALL = tuple(_REGISTRY) + tuple(_LAZY_REGISTRY) + tuple(UNPORTED_MODES)


def create_renderer(mode_name: str, settings: Optional[SettingsMap] = None,
                    device="cuda") -> LineRenderer:
    """Factory (MainApp::setRenderer) of a renderer drawing on `device`.
    Modes not ported yet raise NotImplementedError naming their queue item;
    unknown modes fall back to Opaque with a warning (MainApp.cpp:864-874)."""
    if mode_name in UNPORTED_MODES:
        raise NotImplementedError(
            f"rendering mode {mode_name!r} is not ported yet: ROADMAP queue "
            f"{UNPORTED_MODES[mode_name]}")
    cls = _REGISTRY.get(mode_name)
    if cls is None and mode_name in _LAZY_REGISTRY:
        import importlib

        module, attr = _LAZY_REGISTRY[mode_name]
        cls = getattr(importlib.import_module(module), attr)
        _REGISTRY[mode_name] = cls
    if cls is None:
        warnings.warn(
            f"Rendering mode {mode_name!r} is not supported yet; "
            f"falling back to Opaque (available: {sorted(_REGISTRY)})"
        )
        cls = OpaqueLineRenderer
    return cls(settings, device=device)
