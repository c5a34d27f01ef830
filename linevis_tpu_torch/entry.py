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
the opacity-optimization renderer on it; `tornado_scene`, `tornado_prism_scene` and `tornado_tube_mesh` build
the scene of the JAX package's primary benchmark (`bench.py`: 512 seeds x 400
RK4 steps, dt 1/150, tube radius 0.0015) from one traced line set
(`tornado_trajectories`); `tornado_segment_grid` and `tornado_wide_bvh` build
the AO grid and the packed 8-wide BVH of a capsule scene.
"""

from __future__ import annotations

from functools import partial

import numpy as np

__all__ = [
    "entry", "entry_mlab", "entry_prism", "entry_triangle", "entry_rtao",
    "entry_wavefront", "entry_wboit", "entry_depth_peeling", "entry_mlab_buckets",
    "entry_mboit", "entry_depth_complexity", "entry_opacity_optimization",
    "tornado_trajectories", "tornado_scene", "tornado_prism_scene",
    "tornado_tube_mesh", "tornado_segment_grid", "tornado_wide_bvh",
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
    import torch

    from linevis_tpu_torch.kernels.ao_grid import build_segment_grid
    from linevis_tpu_torch.render.pipeline import RasterSettings
    from linevis_tpu_torch.render.rtao import RtaoSettings, render_tubes_rtao

    scene, cam = _small_scene(device)
    settings = RasterSettings(width=256, height=128, tile_w=32, tile_h=16)
    rtao = RtaoSettings(grid_resolution=32)
    grid = build_segment_grid(scene.a, scene.ba, scene.radius, scene.mask,
                              resolution=rtao.grid_resolution)
    # The samples are drawn on the CPU so that every device traces the same rays.
    gen = torch.Generator().manual_seed(0)
    shape = (rtao.num_samples, settings.height, settings.width)
    uniforms = tuple(torch.rand(shape, generator=gen).to(device) for _ in range(2))
    fn = partial(render_tubes_rtao, settings=settings, rtao=rtao, grid=grid,
                 uniforms=uniforms)
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
