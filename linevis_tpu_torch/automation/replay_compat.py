"""Compatibility shims so the reference's replay scripts run unmodified.

Counterpart of `linevis_tpu/automation/replay_compat.py` (plain Python,
kept equal to it).

The reference's `Data/ReplayScripts/*.py` do `import g` (the embedded
CPython module, ReplayWidget.cpp:576-624) and
`from modules.campath import camera_path_circle`.  `load_script`
temporarily installs module objects for both; this file provides the
`modules.campath` implementation — an independent implementation of the
same API: a circle flight whose parameter is eased by a cubic Bezier
timing curve (acceleration = control-point pull-in), emitted as
`set_duration` keyframes through the g API.
"""

from __future__ import annotations

import math
import sys
import types

__all__ = ["install_compat_modules", "remove_compat_modules"]


def _bezier_timing(x: float, accel_start: float, accel_end: float) -> float:
    """y(x) of the cubic Bezier with control points (0,0),
    (accel_start, 0), (1-accel_end, 1), (1,1): slow start/end, linear
    middle. Solved for the parameter by bisection (monotone in x)."""
    p1x, p2x = accel_start, 1.0 - accel_end

    def bx(t):
        mt = 1.0 - t
        return 3 * mt * mt * t * p1x + 3 * mt * t * t * p2x + t ** 3

    def by(t):
        mt = 1.0 - t
        return 3 * mt * t * t + t ** 3  # p1y=0, p2y=1, p3y=1

    lo, hi = 0.0, 1.0
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        if bx(mid) < x:
            lo = mid
        else:
            hi = mid
    return by(0.5 * (lo + hi))


def _cubic_bezier_y_at_x(x, p0, p1, p2, p3):
    """y(x) of a cubic Bezier with arbitrary 2D control points (the
    reference campath module's f_cubic_bezier, solved by bisection —
    control x coordinates must be monotone)."""
    def bezier(t, c0, c1, c2, c3):
        mt = 1.0 - t
        return (mt ** 3 * c0 + 3 * mt * mt * t * c1
                + 3 * mt * t * t * c2 + t ** 3 * c3)

    lo, hi = 0.0, 1.0
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        if bezier(mid, p0[0], p1[0], p2[0], p3[0]) < x:
            lo = mid
        else:
            hi = mid
    t = 0.5 * (lo + hi)
    return bezier(t, p0[1], p1[1], p2[1], p3[1])


def _make_campath(g):
    mod = types.ModuleType("modules.campath")

    def camera_path_circle(
        angle_start, angle_end, radius_start, radius_end, total_time,
        pitch=0.0, center=(0.0, 0.0, 0.0), acceleration=0.4,
        acceleration_start=None, acceleration_end=None,
        radius_functor=None, subdivisions=64,
    ):
        if acceleration_start is None:
            acceleration_start = acceleration
        if acceleration_end is None:
            acceleration_end = acceleration
        g.set_duration(0.0)
        prev_time = 0.0
        for i in range(subdivisions + 1):
            t = _bezier_timing(
                i / subdivisions, acceleration_start, acceleration_end
            )
            time = t * total_time
            angle = angle_start + t * (angle_end - angle_start)
            radius = (
                radius_functor(t) if radius_functor is not None
                else radius_start + t * (radius_end - radius_start)
            )
            pos = (
                math.cos(angle) * math.cos(pitch) * radius + center[0],
                math.sin(pitch) * radius + center[1],
                math.sin(angle) * math.cos(pitch) * radius + center[2],
            )
            g.set_camera_position(pos)
            g.set_camera_look_at(tuple(center))
            g.set_duration(max(time - prev_time, 0.0))
            prev_time = time

    def camera_pitch_rotation_smooth(yaw, pitch_start, pitch_end,
                                     total_time, acceleration=0.4):
        """Bezier-eased pitch sweep at fixed yaw (campath.py:152-171)."""
        subdivisions = 256
        g.set_duration(0.0)
        for i in range(subdivisions + 1):
            t = _bezier_timing(i / subdivisions, acceleration, acceleration)
            pitch = pitch_start + t * (pitch_end - pitch_start)
            g.set_camera_yaw_pitch_rad((yaw, pitch))
            g.set_duration(total_time / subdivisions)

    def jitter_camera(center, position, yaw, pitch, num_iterations=1,
                      radius=None):
        """Small oscillating orbit around the view center
        (campath.py:173-187): one settle arc then back-and-forth arcs of
        +-0.1 rad at the current radius."""
        pitch = -pitch
        angle_std = yaw - math.pi
        angle_start = angle_std - 0.1
        angle_end = angle_std + 0.1
        if position is not None:
            d = (center[0] - position[0], center[1] - position[1],
                 center[2] - position[2])
            radius = math.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        camera_path_circle(
            angle_start=angle_std, angle_end=angle_end,
            radius_start=radius, radius_end=radius,
            total_time=1, pitch=pitch, center=center, acceleration=0.2)
        for _ in range(num_iterations):
            camera_path_circle(
                angle_start=angle_end, angle_end=angle_start,
                radius_start=radius, radius_end=radius,
                total_time=2, pitch=pitch, center=center, acceleration=0.2)

    def blend_camera_view(start_pos, end_pos, start_yaw, end_yaw,
                          start_pitch=0.0, end_pitch=0.0, total_time=2.0,
                          acceleration=0.4, p1_pos=None, p2_pos=None,
                          p1_yaw=None, p2_yaw=None, p1_pitch=None,
                          p2_pitch=None):
        """Bezier-eased position + yaw/pitch blend (campath.py:199-260),
        with optional per-channel control points."""
        p0, p3 = (0, 0), (1, 1)
        p1_pos = p1_pos or (acceleration, 0)
        p2_pos = p2_pos or (1.0 - acceleration, 1)
        p1_yaw = p1_yaw or (acceleration, 0)
        p2_yaw = p2_yaw or (1.0 - acceleration, 1)
        p1_pitch = p1_pitch or (acceleration, 0)
        p2_pitch = p2_pitch or (1.0 - acceleration, 1)
        subdivisions = 256
        g.set_duration(0.0)
        for i in range(subdivisions + 1):
            x = i / subdivisions
            t_pos = _cubic_bezier_y_at_x(x, p0, p1_pos, p2_pos, p3)
            t_yaw = _cubic_bezier_y_at_x(x, p0, p1_yaw, p2_yaw, p3)
            t_pitch = _cubic_bezier_y_at_x(x, p0, p1_pitch, p2_pitch, p3)
            pos = tuple(
                s + t_pos * (e - s) for s, e in zip(start_pos, end_pos)
            )
            yaw = start_yaw + t_yaw * (end_yaw - start_yaw)
            pitch = start_pitch + t_pitch * (end_pitch - start_pitch)
            g.set_camera_position(pos)
            g.set_camera_yaw_pitch_rad(yaw, pitch)
            g.set_duration(total_time / subdivisions)

    def f_cubic_bezier(x, p0, p1, p2, p3):
        return _cubic_bezier_y_at_x(x, p0, p1, p2, p3)

    mod.camera_path_circle = camera_path_circle
    mod.camera_pitch_rotation_smooth = camera_pitch_rotation_smooth
    mod.jitter_camera = jitter_camera
    mod.blend_camera_view = blend_camera_view
    mod.f_cubic_bezier = f_cubic_bezier
    mod.pow2 = lambda x: x * x
    mod.pow3 = lambda x: x * x * x
    return mod


def install_compat_modules(g) -> dict:
    """Install `g`, `modules`, `modules.campath` into sys.modules; returns
    the previous entries for `remove_compat_modules`."""
    saved = {
        name: sys.modules.get(name)
        for name in ("g", "modules", "modules.campath")
    }
    gmod = types.ModuleType("g")
    for name in dir(g):
        if not name.startswith("_"):
            setattr(gmod, name, getattr(g, name))
    pkg = types.ModuleType("modules")
    pkg.__path__ = []  # mark as package
    campath = _make_campath(g)
    pkg.campath = campath
    sys.modules["g"] = gmod
    sys.modules["modules"] = pkg
    sys.modules["modules.campath"] = campath
    return saved


def remove_compat_modules(saved: dict) -> None:
    for name, mod in saved.items():
        if mod is None:
            sys.modules.pop(name, None)
        else:
            sys.modules[name] = mod
