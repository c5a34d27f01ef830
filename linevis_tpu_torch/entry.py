"""Entry points: the capsule tube frame step with example arguments (opaque
and transparent), and the tornado benchmark scene.

`entry` is the counterpart of `__graft_entry__.entry()` in the JAX package,
`entry_mlab` its transparent (MLAB, K=8) counterpart on the same scene;
`tornado_scene` builds the scene of the JAX package's primary benchmark
(`bench.py`: 512 seeds x 400 RK4 steps, dt 1/150, tube radius 0.0015).
"""

from __future__ import annotations

from functools import partial

import numpy as np

__all__ = ["entry", "entry_mlab", "tornado_scene"]


def _small_scene(device):
    """The entry points' scene: 8 helical lines of 24 points, radius 0.02,
    seen from (0, 0.3, 1.2) at 256x128 -> (scene, camera tensors)."""
    from linevis_tpu_torch.render.camera import Camera
    from linevis_tpu_torch.render.tube_raster import build_capsule_scene, camera_tensors

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
    scene = build_capsule_scene(pos, mask, attrs, radius=0.02, device=device)
    cam = Camera(position=(0.0, 0.3, 1.2), width=256, height=128)
    return scene, camera_tensors(cam, device)


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


def tornado_scene(device="cuda", num_seeds=512, max_steps=400, seed=42):
    """The Crawfis tornado traced on `device` from `num_seeds` seeds drawn
    by np.random.default_rng(seed), normalized, as a CapsuleScene of
    num_seeds * max_steps segments colored by velocity magnitude."""
    from linevis_tpu_torch.core.trajectories import (
        normalize_attributes,
        normalize_trajectories,
    )
    from linevis_tpu_torch.render.tube_raster import build_capsule_scene
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
    return build_capsule_scene(
        traj.positions, traj.mask, traj.attributes[:, 0], radius=0.0015,
        device=device,
    )
