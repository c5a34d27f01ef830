"""Entry points: the tube frame step with example arguments (opaque
capsules, transparent MLAB capsules, opaque prisms, opaque triangle tubes,
ray-traced ambient occlusion, the wavefront ray tracer), and the tornado
benchmark scene in each geometry with its acceleration structures.

`entry` is the counterpart of `__graft_entry__.entry()` in the JAX package,
`entry_mlab` its transparent (MLAB, K=8) counterpart on the same scene,
`entry_prism` and `entry_triangle` the same lines through the Opaque
renderer's `prism` and `triangle` tube geometries (8 subdivisions);
`entry_rtao` the capsules shaded with ray-traced ambient occlusion,
`entry_wavefront` the transparent capsules through the wavefront BVH ray
tracer, and `entry_wboit`, `entry_depth_peeling`, `entry_mlab_buckets`,
`entry_mboit` and `entry_depth_complexity` the rest of the transparent
(OIT) family on the same scene, `entry_opacity_optimization` one frame of
the opacity-optimization renderer on it; `dryrun_multichip` the five
multi-GPU paths of `parallel/mesh.py` on n ranks; `tornado_scene`, `tornado_prism_scene` and `tornado_tube_mesh` build
the scene of the JAX package's primary benchmark (`bench.py`: 512 seeds x 400
RK4 steps, dt 1/150, tube radius 0.0015) from one traced line set
(`tornado_trajectories`); `tornado_segment_grid` and `tornado_wide_bvh` build
the AO grid and the packed 8-wide BVH of a capsule scene.

`BASELINE_CONFIGS` is the counterpart of `tests/baseline_scenes.py`: the
repo's five reference configs (`BASELINE.md`, six images), each a builder
`(device="cuda", scale=1.0, frames=None, line_data=None)` that sets up the
registry's renderer of the config on `device` and returns a `BaselineRun`
whose `render()` draws the config's frames and returns the last image.
`scale` shrinks every resolution as `LINEVIS_BASELINE_SCALE` does for the JAX
builders; `frames` replaces the config's frame sequence by an orbit of that
many cameras (config 3: that many accumulating frames; config 5: the first
frames of its circle path); `line_data` hands in the config's line data (for
example one traced once and shared by several configs or devices).
`tornado_line_data`, `convection_line_data` and `femur_line_data` build it:
the tornado and the convection rolls (`convection_velocity`) traced on a
device, the Femur-like stress lines (`synth_v3_blocks`) written to a v3
`.dat` file of its own and read back.

Scattering: `procedural_cloud` builds a cloud density grid on a device (a
clipped sum of Gaussian blobs from a numpy seed) and `scattering_line_data`
traces it with `LineDataScattering.trace` (`SCATTERING_TRACE`: the
reference's tracing settings but the resolution, 40,960 paths).

Datasets from files: `displaced_icosphere` (a closed surface of 20 * 4^k
triangles) and `write_binary_stl` write the surface that
`sphere_mesh_data` loads as `TriangleMeshData` through the STL loader;
`femur_hex_mesh` and `write_hex_mesh_vtk` write a bent hexahedral
simulation mesh around the Femur-like lines, whose boundary
(`loaders/hex_mesh.py`) is their hull.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from functools import partial
from typing import List

import numpy as np

__all__ = [
    "entry", "entry_mlab", "entry_prism", "entry_triangle", "entry_rtao",
    "entry_wavefront", "entry_wboit", "entry_depth_peeling", "entry_mlab_buckets",
    "entry_mboit", "entry_depth_complexity", "entry_opacity_optimization",
    "dryrun_multichip", "tornado_trajectories", "tornado_scene", "tornado_prism_scene",
    "tornado_tube_mesh", "tornado_segment_grid", "tornado_wide_bvh",
    "BASELINE_CONFIGS", "BaselineRun", "tornado_line_data", "convection_line_data",
    "femur_line_data", "convection_velocity", "synth_v3_blocks",
    "displaced_icosphere", "write_binary_stl", "sphere_mesh_data", "femur_hex_mesh",
    "write_hex_mesh_vtk",
]

TORNADO_RADIUS = 0.0015


def _small_lines():
    """The entry points' lines: 8 helical lines of 24 points ->
    (positions [8, 24, 3], mask, attrs)."""
    num_lines, num_points = 8, 24
    t = np.linspace(0, 2 * np.pi, num_points, dtype=np.float32)
    pos = np.zeros((num_lines, num_points, 3), np.float32)
    for i in range(num_lines):
        r = 0.15 + 0.03 * i
        pos[i, :, 0] = r * np.cos(t + i)
        pos[i, :, 1] = (i - num_lines / 2) * 0.05
        pos[i, :, 2] = r * np.sin(t + i)
    mask = np.ones((num_lines, num_points), bool)
    attrs = np.linspace(0, 1, num_points, dtype=np.float32)[None].repeat(
        num_lines, 0
    )
    return pos, mask, attrs


def _small_camera(device):
    """The entry points' camera, (0, 0.3, 1.2) at 256x128, as tensors."""
    from linevis_tpu_torch.render.camera import Camera
    from linevis_tpu_torch.render.tube_raster import camera_tensors

    return camera_tensors(Camera(position=(0.0, 0.3, 1.2), width=256, height=128), device)


def _small_scene(device):
    """`_small_lines` as capsules of radius 0.02 -> (scene, camera tensors)."""
    from linevis_tpu_torch.render.tube_raster import build_capsule_scene

    scene = build_capsule_scene(*_small_lines(), radius=0.02, device=device)
    return scene, _small_camera(device)


def entry(device="cuda"):
    """(fn, args): `fn(*args)` renders one opaque capsule tube frame ->
    [4, H, W] linear RGBA on `device`."""
    from linevis_tpu_torch.render.pipeline import RasterSettings
    from linevis_tpu_torch.render.tube_raster import render_tubes

    scene, cam = _small_scene(device)
    settings = RasterSettings(width=256, height=128, tile_w=32, tile_h=16)
    fn = partial(render_tubes, settings=settings)
    return fn, (scene, *cam)


def entry_mlab(device="cuda"):
    """(fn, args): `fn(*args)` renders one transparent (MLAB, K=8, opacity
    0.3) capsule tube frame of `entry`'s scene -> [4, H, W] linear RGBA on
    `device`, at the transparent path's 16x8 tiles."""
    from linevis_tpu_torch.render.oit import render_tubes_mlab
    from linevis_tpu_torch.render.pipeline import RasterSettings

    scene, cam = _small_scene(device)
    settings = RasterSettings(width=256, height=128, tile_w=16, tile_h=8)
    fn = partial(render_tubes_mlab, settings=settings, K=8, opacity=0.3)
    return fn, (scene, *cam)


def entry_prism(device="cuda"):
    """(fn, args): `fn(*args)` renders one opaque 8-gon prism tube frame of
    `entry`'s lines -> [4, H, W] linear RGBA on `device`."""
    from linevis_tpu_torch.render.pipeline import RasterSettings
    from linevis_tpu_torch.render.tube_raster import build_prism_scene, render_tubes_prism

    scene = build_prism_scene(*_small_lines(), radius=0.02, n_sides=8, device=device)
    settings = RasterSettings(width=256, height=128, tile_w=32, tile_h=16)
    fn = partial(render_tubes_prism, settings=settings)
    return fn, (scene, *_small_camera(device))


def entry_triangle(device="cuda"):
    """(fn, args): `fn(*args)` renders one opaque triangle-tube frame (8
    subdivisions, G-buffer raster) of `entry`'s lines -> [4, H, W] linear
    RGBA on `device`."""
    import torch

    from linevis_tpu_torch.geometry.tubes import build_tube_triangle_mesh
    from linevis_tpu_torch.render.opaque import render_opaque
    from linevis_tpu_torch.render.pipeline import RasterSettings
    from linevis_tpu_torch.render.transfer_function import TransferFunction

    mesh = build_tube_triangle_mesh(
        *_small_lines(), radius=0.02, num_subdivisions=8, device=device
    )
    view_proj, position, _ = _small_camera(device)
    table = torch.as_tensor(TransferFunction.standard().table, device=device)
    settings = RasterSettings(width=256, height=128, tile_w=32, tile_h=16)
    fn = partial(render_opaque, settings=settings)
    return fn, (mesh, view_proj, position, table)


def entry_rtao(device="cuda"):
    """(fn, args): `fn(*args)` renders one frame of `entry`'s scene shaded
    with ray-traced ambient occlusion (4 rays per pixel, radius 0.1, grid
    32^3, samples drawn from seed 0) -> [4, H, W] linear RGBA on `device`."""
    from linevis_tpu_torch.kernels.ao_grid import build_segment_grid
    from linevis_tpu_torch.render.pipeline import RasterSettings
    from linevis_tpu_torch.render.rtao import RtaoSettings, render_tubes_rtao

    scene, cam = _small_scene(device)
    settings = RasterSettings(width=256, height=128, tile_w=32, tile_h=16)
    rtao = RtaoSettings(grid_resolution=32)
    grid = build_segment_grid(scene.a, scene.ba, scene.radius, scene.mask,
                              resolution=rtao.grid_resolution)
    # The samples are jax.random's under PRNGKey(seed + frame): the same rays on every device.
    fn = partial(render_tubes_rtao, settings=settings, rtao=rtao, grid=grid)
    return fn, (scene, *cam)


def entry_wavefront(device="cuda"):
    """(fn, args): `fn(*args)` renders one transparent frame of `entry`'s
    scene through the wavefront BVH ray tracer (linear builder, K=8, opacity
    0.3, 16x8 ray tiles) -> [4, H, W] linear RGBA on `device`."""
    from linevis_tpu_torch.render.pipeline import RasterSettings
    from linevis_tpu_torch.render.ray_tracer import (
        build_wide_capsule_bvh,
        render_tubes_raytraced_wavefront,
    )

    scene, cam = _small_scene(device)
    settings = RasterSettings(width=256, height=128, tile_w=16, tile_h=8)
    fn = partial(render_tubes_raytraced_wavefront, settings=settings, K=8, opacity=0.3,
                 wide_groups=build_wide_capsule_bvh(scene))
    return fn, (scene, *cam)


def _oit_entry(device, name, **kw):
    """(fn, args) of the `render/oit.py` renderer `name` on `entry`'s scene
    at the transparent path's 16x8 tiles."""
    from linevis_tpu_torch.render import oit
    from linevis_tpu_torch.render.pipeline import RasterSettings

    scene, cam = _small_scene(device)
    settings = RasterSettings(width=256, height=128, tile_w=16, tile_h=8)
    return partial(getattr(oit, name), settings=settings, **kw), (scene, *cam)


def entry_wboit(device="cuda"):
    """(fn, args): `fn(*args)` renders one weighted blended OIT frame
    (opacity 0.3) of `entry`'s scene -> [4, H, W] linear RGBA on `device`."""
    return _oit_entry(device, "render_tubes_wboit", opacity=0.3)


def entry_depth_peeling(device="cuda"):
    """(fn, args): one depth-peeling frame (K=8, 4 passes, opacity 0.3) of
    `entry`'s scene -> [4, H, W] linear RGBA on `device`."""
    return _oit_entry(device, "render_tubes_depth_peeling", K=8, passes=4, opacity=0.3)


def entry_mlab_buckets(device="cuda"):
    """(fn, args): one MLAB (Buckets) frame (K=8, opacity 0.3) of `entry`'s
    scene -> [4, H, W] linear RGBA on `device`."""
    return _oit_entry(device, "render_tubes_mlab_buckets", K=8, opacity=0.3)


def entry_mboit(device="cuda"):
    """(fn, args): one moment-based OIT frame (4 power moments, float32,
    opacity 0.3) of `entry`'s scene -> [4, H, W] linear RGBA on `device`."""
    return _oit_entry(device, "render_tubes_mboit", n_mom=4, opacity=0.3)


def entry_depth_complexity(device="cuda"):
    """(fn, args): the depth complexity (front-face fragments per pixel) of
    `entry`'s scene -> [H, W] float32 on `device`."""
    return _oit_entry(device, "render_depth_complexity")


def entry_opacity_optimization(device="cuda"):
    """(fn, args): `fn(*args)` renders one opacity-optimization frame (the
    importance gather at half resolution, the opacity solve and the final
    MLAB render; default settings, tile 16x8) of `entry`'s scene -> [4, H,
    W] linear RGBA on `device`. `fn` is the renderer's `render`: a second
    call continues its temporal smoothing."""
    from linevis_tpu_torch.render.camera import Camera
    from linevis_tpu_torch.render.opacity_optimization import OpacityOptimizationRenderer
    from linevis_tpu_torch.render.pipeline import RasterSettings
    from linevis_tpu_torch.render.tube_raster import build_capsule_scene

    pos, mask, attrs = _small_lines()
    scene = build_capsule_scene(pos, mask, attrs, radius=0.02, device=device)
    settings = RasterSettings(width=256, height=128, tile_w=16, tile_h=8)
    r = OpacityOptimizationRenderer(scene, pos.shape[0], pos.shape[1], settings)
    return r.render, (Camera(position=(0.0, 0.3, 1.2), width=256, height=128),)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The five sharded paths of `parallel/mesh.py`, one step each, on
    `n_devices` ranks, the port's counterpart of
    `__graft_entry__.dryrun_multichip` on the same tiny scenes: the opaque
    triangle tubes (4 subdivisions) and MLAB (K=4) over bands of 2 tile
    rows, ray-sharded RTAO (2 samples a rank, grid 16^3), the banded
    opacity solve and its final MLAB render, and sample-sharded VPT on a
    16^3 Gaussian density (32x16, 4 events, 1 spp). The ranks are threads
    of this process (`parallel/mesh.py:run_ranks`): gloo on "cpu", NCCL on
    "cuda" with one card a rank, so `n_devices` may not exceed the cards.
    Checks every rank's result (shape, finite, the same on every rank) and
    returns {path: shape}."""
    import torch

    from linevis_tpu_torch.geometry.tubes import build_tube_triangle_mesh
    from linevis_tpu_torch.kernels.ao_grid import build_segment_grid
    from linevis_tpu_torch.ops import threefry
    from linevis_tpu_torch.parallel import mesh as pm
    from linevis_tpu_torch.render.camera import Camera
    from linevis_tpu_torch.render.opacity_optimization import (
        OpacityOptimizationSettings,
        final_render,
    )
    from linevis_tpu_torch.render.pipeline import RasterSettings
    from linevis_tpu_torch.render.rtao import RtaoSettings
    from linevis_tpu_torch.render.transfer_function import TransferFunction
    from linevis_tpu_torch.render.tube_raster import build_capsule_scene, camera_tensors
    from linevis_tpu_torch.render.vpt import VptSettings

    device_type = torch.device(device).type
    height = 8 * n_devices * 2  # 2 tile rows a band
    lines = _small_lines()
    num_lines, num_points = lines[0].shape[:2]
    z = np.linspace(0.0, 1.0, 16, dtype=np.float32)
    dens = np.exp(-8.0 * ((z[:, None, None] - 0.5) ** 2 + (z[None, :, None] - 0.5) ** 2
                          + (z[None, None, :] - 0.5) ** 2)).astype(np.float32)
    basis = np.stack([[0.6, 0, 0], [0, 0.35, 0], [0, 0, -1.0]], axis=1).astype(np.float32)

    def rank(group, dev):
        cam = camera_tensors(Camera(position=(0.0, 0.3, 1.2), width=128, height=height), dev)
        mesh = build_tube_triangle_mesh(*lines, radius=0.02, num_subdivisions=4, device=dev)
        table = torch.as_tensor(TransferFunction.standard().table, device=dev)
        out = {"opaque": pm.render_opaque_sharded(
            mesh, cam[0], cam[1], table, RasterSettings(width=128, height=height, chunk=64),
            group)}
        scene = build_capsule_scene(*lines, radius=0.02, device=dev)
        s_oit = RasterSettings(width=128, height=height, tile_w=16, tile_h=8, chunk=16,
                               span_x=3, span_y=3)
        out["mlab"] = pm.render_tubes_mlab_sharded(scene, *cam, s_oit, group, K=4)
        rtao = RtaoSettings(num_samples=2, grid_resolution=16)
        grid = build_segment_grid(scene.a, scene.ba, scene.radius, scene.mask, resolution=16)
        out["rtao"] = pm.render_tubes_rtao_sharded(scene, *cam, s_oit, group, rtao=rtao,
                                                   grid=grid)
        oo = OpacityOptimizationSettings(opacity_resolution_scale=1.0, gather_k=4, render_k=4)
        vo0 = torch.ones((num_lines, num_points), dtype=torch.float32, device=dev)
        vo = pm.opacity_solve_sharded(scene, *cam, vo0, s_oit, oo, num_lines, num_points, group)
        out["opacity_solve"] = vo
        out["opacity_final"] = final_render(scene, *cam, vo, s_oit, oo.render_k)
        out["vpt"] = pm.render_vpt_sharded(
            threefry.prng_key(5, dev), torch.as_tensor(dens, device=dev),
            torch.tensor([0.5, 0.5, 2.2], dtype=torch.float32, device=dev),
            torch.as_tensor(basis, device=dev), 32, 16, group,
            settings=VptSettings(max_events=4), spp=1)
        return {k: v.cpu() for k, v in out.items()}

    results = pm.run_ranks(n_devices, rank, device_type)
    want = {"opaque": (4, height, 128), "mlab": (4, height, 128), "rtao": (4, height, 128),
            "opacity_solve": (num_lines, num_points), "opacity_final": (4, height, 128),
            "vpt": (16, 32, 3)}
    for name, shape in want.items():
        for r, res in enumerate(results):
            x = res[name]
            if tuple(x.shape) != shape or not bool(torch.isfinite(x).all()):
                raise RuntimeError(f"dryrun_multichip: rank {r}'s {name} is {tuple(x.shape)} "
                                   "or non-finite")
            if not torch.equal(x, results[0][name]):
                raise RuntimeError(f"dryrun_multichip: rank {r}'s {name} differs from rank 0's")
    print(f"dryrun_multichip({n_devices}, {device_type}): OK, " + ", ".join(
        f"{k} {v}" for k, v in want.items()), flush=True)
    return want


def tornado_trajectories(device="cuda", num_seeds=512, max_steps=400, seed=42):
    """The Crawfis tornado traced on `device` from `num_seeds` seeds drawn
    by np.random.default_rng(seed), positions and attributes normalized."""
    from linevis_tpu_torch.core.trajectories import (
        normalize_attributes,
        normalize_trajectories,
    )
    from linevis_tpu_torch.trace.fields import tornado_velocity
    from linevis_tpu_torch.trace.streamline import (
        StreamlineTracingSettings,
        trace_streamlines,
    )

    seeds = np.random.default_rng(seed).uniform(size=(num_seeds, 3)).astype(np.float32)
    traj = trace_streamlines(
        tornado_velocity,
        StreamlineTracingSettings(
            num_seeds=num_seeds, max_steps=max_steps, dt=1.0 / 150.0
        ),
        seeds=seeds, device=device,
    )
    traj = normalize_attributes(normalize_trajectories(traj))
    if not np.isfinite(traj.positions).all():
        raise RuntimeError("tornado trace produced non-finite positions")
    return traj


def tornado_scene(device="cuda", num_seeds=512, max_steps=400, seed=42, traj=None):
    """The tornado (`tornado_trajectories`, or the given `traj`) as a
    CapsuleScene of num_seeds * max_steps segments colored by velocity
    magnitude."""
    from linevis_tpu_torch.render.tube_raster import build_capsule_scene

    traj = traj or tornado_trajectories(device, num_seeds, max_steps, seed)
    return build_capsule_scene(
        traj.positions, traj.mask, traj.attributes[:, 0], radius=TORNADO_RADIUS,
        device=device,
    )


def tornado_prism_scene(device="cuda", n_sides=8, traj=None, **trace_kw):
    """The tornado as a PrismScene of `n_sides`-gon prisms."""
    from linevis_tpu_torch.render.tube_raster import build_prism_scene

    traj = traj or tornado_trajectories(device, **trace_kw)
    return build_prism_scene(
        traj.positions, traj.mask, traj.attributes[:, 0], radius=TORNADO_RADIUS,
        n_sides=n_sides, device=device,
    )


def tornado_tube_mesh(device="cuda", num_subdivisions=8, traj=None, **trace_kw):
    """The tornado as a triangle TubeMesh of `num_subdivisions`-gon tubes."""
    from linevis_tpu_torch.geometry.tubes import build_tube_triangle_mesh

    traj = traj or tornado_trajectories(device, **trace_kw)
    return build_tube_triangle_mesh(
        traj.positions, traj.mask, traj.attributes[:, 0], radius=TORNADO_RADIUS,
        num_subdivisions=num_subdivisions, device=device,
    )


def tornado_segment_grid(scene, resolution=64):
    """The AO segment grid of a capsule scene (camera-independent)."""
    from linevis_tpu_torch.kernels.ao_grid import build_segment_grid

    return build_segment_grid(scene.a, scene.ba, scene.radius, scene.mask,
                              resolution=resolution)


def tornado_wide_bvh(scene, builder="binned_sah"):
    """The packed 8-wide BVH of a capsule scene on its device ->
    (groups, {"build_s", "pack_s"}): `builder`'s binary tree, then the
    host-side collapse, timed apart."""
    from linevis_tpu_torch.render.ray_tracer import build_wide_capsule_bvh

    timings = {}
    return build_wide_capsule_bvh(scene, builder=builder, timings=timings), timings


# The repo's five reference configs (tests/baseline_scenes.py) through the
# port's registry.

TORNADO_LINE_WIDTH = 0.003
CONVECTION_LINE_WIDTH = 0.004
FEMUR_LINE_WIDTH = 0.012
BASELINE_CAMERA = (0.0, 0.1, 1.2)
ORBIT_STEP = 0.01  # yaw between two cameras of an orbit, radians


@dataclasses.dataclass
class BaselineRun:
    """One baseline config set up on a device: the registry's renderer,
    holding the config's line data, and the cameras of its frames in order."""

    name: str
    renderer: object  # render.renderer.LineRenderer
    cameras: List[object]  # render.camera.Camera

    def render(self) -> np.ndarray:
        """Draw every frame in order -> the last image, numpy [H, W, 4]."""
        img = None
        for cam in self.cameras:
            img = self.renderer.render(cam)
        return img


def _res(w, h, scale):
    """tests/baseline_scenes.py `_res` at an explicit scale."""
    return (max(int(w * scale) // 16 * 16, 32), max(int(h * scale) // 16 * 16, 16))


def _orbit(cam, n):
    """`cam` and n - 1 cameras orbiting its look-at point by ORBIT_STEP each,
    at its pitch and distance."""
    import math

    x, y, z = (p - c for p, c in zip(cam.position, cam.look_at_point))
    radius = math.sqrt(x * x + y * y + z * z)
    pitch, yaw = math.asin(y / radius), math.atan2(x, z)
    return [cam] + [cam.orbit(yaw + ORBIT_STEP * i, pitch, radius) for i in range(1, n)]


def _baseline(name, mode, line_data, w, h, device, frames, settings=None, repeat=1):
    """The registry's renderer of `mode` with `settings` on `line_data`, its
    frames at the baseline camera (`repeat` of them), or an orbit of
    `frames` cameras."""
    from linevis_tpu_torch.core.settings import SettingsMap
    from linevis_tpu_torch.render.camera import Camera
    from linevis_tpu_torch.render.renderer import create_renderer

    r = create_renderer(mode, SettingsMap(settings or {}), device=device)
    r.set_line_data(line_data)
    cam = Camera(position=BASELINE_CAMERA, look_at_point=(0.0, 0.0, 0.0), width=w, height=h)
    cams = [cam] * repeat if frames is None else _orbit(cam, frames)
    return BaselineRun(name, r, cams)


def tornado_line_data(device="cuda"):
    """The tornado of configs 1, 2 and 5 (`tornado_trajectories`: 512 seeds x
    400 RK4 steps, dt 1/150, traced on `device`) as LineData of line width
    0.003."""
    from linevis_tpu_torch.scene.line_data import LineData

    ld = LineData(tornado_trajectories(device))
    ld.set_line_width(TORNADO_LINE_WIDTH)
    return ld


def convection_velocity(p, time=0.0):
    """Analytic Rayleigh-Benard-style convection rolls (config 3's field,
    tests/baseline_scenes.py and bench.py). p: [..., 3] -> [..., 3]."""
    import torch

    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    k = 2.0 * np.pi
    vx = torch.sin(k * x) * torch.cos(k * y)
    vy = -torch.cos(k * x) * torch.sin(k * y)
    vz = 0.3 * torch.sin(k * x) * torch.sin(k * z)
    return torch.stack([vx, vy, vz], dim=-1)


def convection_trajectories(device="cuda", seeds=None):
    """Config 3's streamlines: 256 seeds (`seeds`, or the tracer's default
    draw, jax.random's uniforms under PRNGKey(42) as in the JAX config)
    x 300 RK4 steps, dt 1/120, traced on
    `device` through `convection_velocity`, positions and attributes
    normalized."""
    from linevis_tpu_torch.core.trajectories import (
        normalize_attributes,
        normalize_trajectories,
    )
    from linevis_tpu_torch.trace.streamline import (
        StreamlineTracingSettings,
        trace_streamlines,
    )

    traj = trace_streamlines(
        convection_velocity,
        StreamlineTracingSettings(num_seeds=256, max_steps=300, dt=1.0 / 120.0),
        seeds=seeds, device=device,
    )
    return normalize_attributes(normalize_trajectories(traj))


def convection_line_data(device="cuda"):
    """Config 3's line data (`convection_trajectories` on `device`), line
    width 0.004."""
    from linevis_tpu_torch.scene.line_data import LineData

    ld = LineData(convection_trajectories(device))
    ld.set_line_width(CONVECTION_LINE_WIDTH)
    return ld


def synth_v3_blocks(rng, lines_per_ps=24, n=48):
    """Three PS families of helical lines on a bone-like capsule volume
    (the port's copy of examples/render_stress_bands.py:synth_v3_blocks)."""
    from linevis_tpu_torch.core.trajectories import RaggedTrajectories
    from linevis_tpu_torch.loaders.stress_dat import RaggedStressTrajectories

    blocks = []
    for ps in range(3):
        block = RaggedStressTrajectories(
            trajectories=RaggedTrajectories([], [], []), ps_index=ps
        )
        for li in range(lines_per_ps):
            t = np.linspace(0, 1, n, dtype=np.float32)
            phase = rng.uniform(0, 2 * np.pi)
            z = t * 2.0 - 1.0
            r = 0.35 + 0.1 * np.cos(3 * np.pi * z)
            if ps == 0:  # major: longitudinal
                ang = phase + 0.8 * t
                pos = np.stack([r * np.cos(ang), r * np.sin(ang), z], 1)
            elif ps == 1:  # medium: helical
                ang = phase + 6.0 * t
                pos = np.stack([r * np.cos(ang), r * np.sin(ang), z * 0.8], 1)
            else:  # minor: hoops
                ang = phase + 2 * np.pi * t
                zz = np.full_like(t, rng.uniform(-0.9, 0.9))
                rr = 0.35 + 0.1 * np.cos(3 * np.pi * zz)
                pos = np.stack([rr * np.cos(ang), rr * np.sin(ang), zz], 1)
            pos = pos.astype(np.float32)
            block.trajectories.positions.append(pos)
            # Right vector: radial direction (band plane tangent to surface).
            right = pos.copy()
            right[:, 2] = 0
            nrm = np.maximum(np.linalg.norm(right, axis=1, keepdims=True), 1e-5)
            right = (right / nrm).astype(np.float32)
            block.band_points_left.append(-right)
            block.band_points_right.append(right)
            block.band_points_left_unsmoothed.append(-right)
            block.band_points_right_unsmoothed.append(right)
            attrs = np.zeros((9, n), np.float32)
            sigma = (1.0 - np.abs(z)) * (3 - ps)  # principal stress
            attrs[0] = sigma
            attrs[1] = np.abs(sigma)
            attrs[2] = np.abs(sigma) * 0.9  # von Mises
            attrs[3:6] = rng.normal(0, 0.3, (3, n)).astype(np.float32) + sigma
            attrs[6:9] = rng.normal(0, 0.2, (3, n)).astype(np.float32)
            block.trajectories.attributes.append(attrs)
            block.hierarchy_levels.append(
                [float(np.abs(sigma).mean() / 3.0)] * 4
            )
            block.appearance_orders.append(li)
            block.seed_positions.append(pos[0])
        blocks.append(block)
    return blocks


def femur_line_data():
    """Config 4's Femur-like stress lines: `synth_v3_blocks` of
    np.random.default_rng(11) (72 lines of 48 points), written as a v3
    `.dat` to a temporary file of its own (removed after reading; never the
    JAX builder's shared file) and loaded as LineDataStress of line width
    0.012."""
    from linevis_tpu_torch.loaders.stress_dat import write_stress_trajectories_dat_v3
    from linevis_tpu_torch.scene.line_data_stress import LineDataStress

    fd, path = tempfile.mkstemp(suffix=".dat", prefix="femur_psl_v3_")
    os.close(fd)
    try:
        write_stress_trajectories_dat_v3(path, synth_v3_blocks(np.random.default_rng(11)))
        ld = LineDataStress.load_from_dat([path], version=3)
    finally:
        os.remove(path)
    ld.set_line_width(FEMUR_LINE_WIDTH)
    return ld


SPHERE_SUBDIVISIONS = 8  # 20 * 4^8 = 1,310,720 triangles


def displaced_icosphere(subdivisions: int = SPHERE_SUBDIVISIONS) -> np.ndarray:
    """[20 * 4^subdivisions, 3, 3] float32 corners of an icosahedron
    subdivided `subdivisions` times, outward winding, radially displaced by
    1 + 0.08 sin(5x) sin(4y) sin(3z), so that the curvature varies. A
    triangle soup: every shared corner has the same bits in each of its
    triangles (a midpoint is normalize(a + b) in float64 either way)."""
    g = (1.0 + 5.0 ** 0.5) / 2.0
    v = np.array([(-1, g, 0), (1, g, 0), (-1, -g, 0), (1, -g, 0), (0, -1, g), (0, 1, g),
                  (0, -1, -g), (0, 1, -g), (g, 0, -1), (g, 0, 1), (-g, 0, -1), (-g, 0, 1)],
                 np.float64)
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9),
             (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2),
             (3, 2, 6), (3, 6, 8), (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10),
             (8, 6, 7), (9, 8, 1)]
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    tri = v[np.array(faces)]

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    for _ in range(subdivisions):
        a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
        ab, bc, ca = unit(a + b), unit(b + c), unit(c + a)
        tri = np.stack([np.stack(t, axis=1) for t in
                        ((a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca))], axis=1)
        tri = tri.reshape(-1, 3, 3)
    x, y, z = tri[..., 0], tri[..., 1], tri[..., 2]
    r = 1.0 + 0.08 * np.sin(5.0 * x) * np.sin(4.0 * y) * np.sin(3.0 * z)
    return (tri * r[..., None]).astype(np.float32)


def write_binary_stl(path: str, tri_pts: np.ndarray) -> None:
    """[T, 3, 3] corners -> a binary STL file (zero normals)."""
    rec = np.zeros(tri_pts.shape[0], np.dtype([("n", "<3f4"), ("v", "<9f4"), ("attr", "<u2")]))
    rec["v"] = tri_pts.reshape(-1, 9)
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(np.uint32(tri_pts.shape[0]).tobytes())
        f.write(rec.tobytes())


def sphere_mesh_data(subdivisions: int = SPHERE_SUBDIVISIONS):
    """`displaced_icosphere` written as a binary STL to a temporary file of
    its own (removed after reading) and loaded as TriangleMeshData: the STL
    loader welds the corners and computes normals and curvature."""
    from linevis_tpu_torch.scene.triangle_mesh_data import TriangleMeshData

    fd, path = tempfile.mkstemp(suffix=".stl", prefix="icosphere_")
    os.close(fd)
    try:
        write_binary_stl(path, displaced_icosphere(subdivisions))
        return TriangleMeshData.load_from_file(path, name="icosphere")
    finally:
        os.remove(path)


def femur_hex_mesh(nx: int = 48, ny: int = 48, nz: int = 96):
    """A hexahedral mesh of nx * ny * nz cells around the Femur-like lines
    (`synth_v3_blocks`: radius 0.35 + 0.1 cos(3 pi z), z in [-1, 1]): the
    square cross-section mapped onto a disk of radius 0.47 + 0.1 cos(3 pi
    z), z over [-1.05, 1.05], the axis bent by 0.04 z^2 in x. -> (points
    [V, 3] float32, hexes [H, 8] int64 in VTK corner order)."""
    i, j, k = np.meshgrid(np.arange(nx + 1), np.arange(ny + 1), np.arange(nz + 1),
                          indexing="ij")
    u, v = 2.0 * i / nx - 1.0, 2.0 * j / ny - 1.0
    z = 1.05 * (2.0 * k / nz - 1.0)
    r = 0.47 + 0.1 * np.cos(3.0 * np.pi * z / 1.05)
    x = r * u * np.sqrt(1.0 - 0.5 * v * v) + 0.04 * z * z
    y = r * v * np.sqrt(1.0 - 0.5 * u * u)
    points = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)

    def pid(a, b, c):
        return ((a * (ny + 1) + b) * (nz + 1) + c).reshape(-1)

    a, b, c = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    hexes = np.stack([pid(a, b, c), pid(a + 1, b, c), pid(a + 1, b + 1, c), pid(a, b + 1, c),
                      pid(a, b, c + 1), pid(a + 1, b, c + 1), pid(a + 1, b + 1, c + 1),
                      pid(a, b + 1, c + 1)], axis=1).astype(np.int64)
    return points, hexes


def write_hex_mesh_vtk(path: str, points: np.ndarray, hexes: np.ndarray) -> None:
    """An ASCII VTK legacy UNSTRUCTURED_GRID of hexahedra (cell type 12)."""
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\nhex mesh\nASCII\nDATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {len(points)} float\n")
        np.savetxt(f, points, fmt="%.7g")
        f.write(f"CELLS {len(hexes)} {9 * len(hexes)}\n")
        np.savetxt(f, np.concatenate([np.full((len(hexes), 1), 8), hexes], axis=1), fmt="%d")
        f.write(f"CELL_TYPES {len(hexes)}\n")
        np.savetxt(f, np.full((len(hexes), 1), 12), fmt="%d")


def config1_tornado_opaque(device="cuda", scale=1.0, frames=None, line_data=None):
    return _baseline("cfg1_tornado_opaque_800x600", "Opaque",
                     line_data or tornado_line_data(device), *_res(800, 600, scale),
                     device, frames)


def config2_tornado_ppll(device="cuda", scale=1.0, frames=None, line_data=None):
    return _baseline("cfg2_tornado_ppll_1080p", "Per-Pixel Linked Lists",
                     line_data or tornado_line_data(device), *_res(1920, 1080, scale),
                     device, frames, settings={"opacity": 0.3})


def config3_convection_rtao(device="cuda", scale=1.0, frames=None, line_data=None):
    """RTAO reference defaults: 4 samples a frame, accumulating (2 frames, as
    the JAX builder draws them; `frames` accumulating frames at the same
    camera)."""
    return _baseline("cfg3_convection_rtao_1080p", "RTAO",
                     line_data or convection_line_data(device), *_res(1920, 1080, scale),
                     device, None, repeat=frames or 2)


def config4_femur_mlab(device="cuda", scale=1.0, frames=None, line_data=None):
    return _baseline("cfg4_femur_mlab_1080p", "Multi-Layer Alpha Blending",
                     line_data or femur_line_data(), *_res(1920, 1080, scale), device,
                     frames, settings={"opacity": 0.45})


def config4b_femur_mboit(device="cuda", scale=1.0, frames=None, line_data=None):
    return _baseline("cfg4b_femur_mboit_1080p", "Moment-Based OIT",
                     line_data or femur_line_data(), *_res(1920, 1080, scale), device,
                     frames, settings={"opacity": 0.45})


def config5_tornado_opacity_opt_replay(device="cuda", scale=1.0, frames=None,
                                       line_data=None):
    """Opacity optimization at the end of a short camera flight (replay
    semantics: the 3rd frame of a circle path; `frames` of its first frames)."""
    from linevis_tpu_torch.automation.camera_path import CameraPath
    from linevis_tpu_torch.render.camera import Camera

    run = _baseline("cfg5_tornado_opacityopt_1080p", "Opacity Optimization",
                    line_data or tornado_line_data(device), *_res(1920, 1080, scale),
                    device, None)
    path = CameraPath.from_circle_path(run.renderer.line_data.get_aabb())
    w, h = run.cameras[0].width, run.cameras[0].height
    run.cameras = []
    for i in range(frames or 3):
        pos, look = path.camera_at(i / 16.0 * path.total_time)
        run.cameras.append(Camera(position=tuple(pos), look_at_point=tuple(look),
                                  width=w, height=h))
    return run


BASELINE_CONFIGS = {
    "cfg1_tornado_opaque_800x600": config1_tornado_opaque,
    "cfg2_tornado_ppll_1080p": config2_tornado_ppll,
    "cfg3_convection_rtao_1080p": config3_convection_rtao,
    "cfg4_femur_mlab_1080p": config4_femur_mlab,
    "cfg4b_femur_mboit_1080p": config4b_femur_mboit,
    "cfg5_tornado_opacityopt_1080p": config5_tornado_opacity_opt_replay,
}


# Scattering: the reference's ScatteringTracingSettings but the resolution
# (trace/scattering.py:40-56): 64 x 64 pixels x 10 samples = 40,960 paths.
SCATTERING_TRACE = dict(res_x=64, res_y=64, samples_per_pixel=10, max_events=128, g=0.2, seed=42)
CLOUD_SIZE = 512  # voxels a side: 512^3 float32, 537 MB
CLOUD_BLOBS = 300


def procedural_cloud(device="cuda", n=CLOUD_SIZE, blobs=CLOUD_BLOBS, seed=7):
    """A [n, n, n] float32 cloud on `device`: the sum of `blobs` Gaussian
    blobs (centres, radii and amplitudes from np.random.default_rng(seed))
    over the unit cube, each cut at three radii, clipped to [0, 1]."""
    import torch

    rng = np.random.default_rng(seed)
    centres = rng.uniform(0.2, 0.8, (blobs, 3))
    radii = rng.uniform(0.02, 0.08, blobs)
    amps = rng.uniform(0.5, 1.5, blobs)
    g = torch.linspace(0.0, 1.0, n, device=device)
    cloud = torch.zeros((n, n, n), device=device)
    for c, r, a in zip(centres, radii, amps):
        lo = np.clip(np.floor((c - 3 * r) * (n - 1)).astype(int), 0, n - 1)
        hi = np.clip(np.ceil((c + 3 * r) * (n - 1)).astype(int) + 1, 0, n)
        e = [torch.exp(-((g[lo[i]:hi[i]] - float(c[i])) ** 2) / float(r * r)) for i in range(3)]
        cloud[lo[2]:hi[2], lo[1]:hi[1], lo[0]:hi[0]] += (
            float(a) * e[2][:, None, None] * e[1][None, :, None] * e[0][None, None, :])
    return torch.clamp(cloud, 0.0, 1.0)


def scattering_line_data(device="cuda", n=CLOUD_SIZE, blobs=CLOUD_BLOBS, trace=None):
    """`procedural_cloud` traced on `device` by `LineDataScattering.trace`
    with `SCATTERING_TRACE` (or `trace`, a dict of its settings)."""
    from linevis_tpu_torch.scene.line_data_scattering import LineDataScattering
    from linevis_tpu_torch.trace.scattering import ScatteringTracingSettings

    cloud = procedural_cloud(device, n, blobs).cpu().numpy()
    return LineDataScattering.trace(
        cloud, ScatteringTracingSettings(**(trace or SCATTERING_TRACE)), device=device)
