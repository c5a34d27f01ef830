"""Replay scripting: the `g.*` API driving datasets, renderers, cameras.

Counterpart of `linevis_tpu/automation/replay.py`. Reference:
`src/Widgets/ReplayWidget.*` embeds CPython and exposes a module `g` whose
setters are recorded into keyframed states (`ReplayWidget.cpp:576-624`):
set_dataset, set_renderer, set_rendering_algorithm_settings,
set_dataset_settings, set_camera_position / set_camera_look_at /
set_camera_yaw_pitch, set_camera_checkpoint, set_duration (the keyframe
interval, with linear interpolation of numeric settings and slerp of
orientations, `ReplayWidget.hpp:128-160`), set_transfer_function,
save_screenshot.

A replay script is `exec`ed with an injected `g` object; `run()` steps
through the keyframe timeline and renders the interpolated frames with the
port's registry on the widget's `device` (the card unless the caller asks
for the CPU). A state that names a renderer creates it anew; the line
data's device representations are cached on the data, so a new renderer
on the same data uploads nothing again.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, List, Optional

import numpy as np

from linevis_tpu_torch.core.settings import SettingsMap
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.framebuffer import save_png
from linevis_tpu_torch.render.renderer import create_renderer
from linevis_tpu_torch.render.transfer_function import TransferFunction

__all__ = ["ReplayWidget", "ReplayState", "slerp"]


def slerp(q0, q1, t: float) -> np.ndarray:
    """Spherical linear interpolation of quaternions (x, y, z, w) —
    the reference exposes the same helper to scripts
    (`ReplayWidget.cpp:475-497` py_slerp) and uses it for camera
    orientations (`ReplayWidget.cpp:870`)."""
    q0 = np.asarray(q0, np.float64)
    q1 = np.asarray(q1, np.float64)
    q0 = q0 / max(np.linalg.norm(q0), 1e-12)
    q1 = q1 / max(np.linalg.norm(q1), 1e-12)
    d = float(np.dot(q0, q1))
    if d < 0.0:
        q1, d = -q1, -d
    if d > 0.9995:
        out = q0 + t * (q1 - q0)
        return (out / max(np.linalg.norm(out), 1e-12)).astype(np.float32)
    theta0 = math.acos(min(max(d, -1.0), 1.0))
    s0 = math.sin((1.0 - t) * theta0) / math.sin(theta0)
    s1 = math.sin(t * theta0) / math.sin(theta0)
    return (s0 * q0 + s1 * q1).astype(np.float32)


def _quat_rotate(q, v) -> np.ndarray:
    """Rotate vector v by quaternion q = (x, y, z, w)."""
    x, y, z, w = (float(c) for c in q)
    u = np.array([x, y, z], np.float64)
    v = np.asarray(v, np.float64)
    return (
        2.0 * np.dot(u, v) * u
        + (w * w - np.dot(u, u)) * v
        + 2.0 * w * np.cross(u, v)
    ).astype(np.float32)


def _parse_numeric(val: str):
    """Parse a settings value as float or float vector, else None
    (the reference's REAL/INTEGER/VEC2/3/4 dynamic types,
    ReplayWidget.hpp:114-160)."""
    try:
        return float(val)
    except (TypeError, ValueError):
        pass
    try:
        parts = [float(t) for t in str(val).replace(",", " ").split()]
        if 2 <= len(parts) <= 4:
            return np.asarray(parts, np.float64)
    except ValueError:
        pass
    return None


@dataclasses.dataclass
class ReplayState:
    """One keyframe (reference ReplayState)."""

    duration: float = 0.0
    dataset: Optional[str] = None
    renderer: Optional[str] = None
    renderer_settings: Optional[SettingsMap] = None
    dataset_settings: Optional[SettingsMap] = None
    camera_position: Optional[np.ndarray] = None
    camera_look_at: Optional[np.ndarray] = None
    camera_orientation: Optional[np.ndarray] = None  # quat (x, y, z, w)
    camera_fovy: Optional[float] = None
    transfer_function: Optional[str] = None
    transfer_function_range: Optional[tuple] = None
    multi_var_transfer_functions: Optional[list] = None
    multi_var_transfer_function_ranges: Optional[list] = None
    tracer_settings: Optional[SettingsMap] = None
    screenshot: Optional[str] = None


class _GApi:
    """The `g` module surface exposed to replay scripts."""

    def __init__(self, widget: "ReplayWidget"):
        self._w = widget

    # state management -----------------------------------------------------
    def set_duration(self, seconds: float) -> None:
        self._w._commit_state()
        self._w._current.duration = float(seconds)

    def set_dataset(self, name: str) -> None:
        self._w._current.dataset = name

    def set_renderer(self, name: str) -> None:
        self._w._current.renderer = name

    def set_rendering_algorithm_settings(self, settings: dict) -> None:
        self._w._current.renderer_settings = SettingsMap(settings)

    def set_dataset_settings(self, settings: dict) -> None:
        self._w._current.dataset_settings = SettingsMap(settings)

    def set_camera_position(self, x, y=None, z=None) -> None:
        if y is None:
            x, y, z = x
        self._w._current.camera_position = np.array([x, y, z], np.float32)

    def set_camera_look_at(self, x, y=None, z=None) -> None:
        if y is None:
            x, y, z = x
        self._w._current.camera_look_at = np.array([x, y, z], np.float32)

    def set_camera_yaw_pitch(self, yaw: float, pitch: float, radius: float = 1.2):
        la = self._w._current.camera_look_at
        cx, cy, cz = (0.0, 0.0, 0.0) if la is None else la
        pos = (
            cx + radius * math.cos(pitch) * math.sin(yaw),
            cy + radius * math.sin(pitch),
            cz + radius * math.cos(pitch) * math.cos(yaw),
        )
        self._w._current.camera_position = np.array(pos, np.float32)

    def set_camera_fovy(self, fovy: float) -> None:
        self._w._current.camera_fovy = float(fovy)

    def set_camera_orientation_quaternion(self, q) -> None:
        """Camera orientation as (x, y, z, w); interpolated by slerp
        between keyframes (ReplayWidget.cpp:870)."""
        self._w._current.camera_orientation = np.asarray(q, np.float32)

    def slerp(self, q0, q1, t: float):
        return slerp(q0, q1, t)

    def set_transfer_functions_range(self, vmin: float, vmax: float) -> None:
        self._w._current.transfer_function_range = (float(vmin), float(vmax))

    def set_tracer_settings(self, settings: dict) -> None:
        self._w._current.tracer_settings = SettingsMap(settings)

    # -- aliases used by the reference's Data/ReplayScripts/*.py ------------
    def set_camera_fovy_deg(self, fovy_deg: float) -> None:
        self._w._current.camera_fovy = math.radians(float(fovy_deg))

    def set_camera_yaw_pitch_rad(self, yaw, pitch=None) -> None:
        if pitch is None:  # scripts also pass one (yaw, pitch) tuple
            yaw, pitch = yaw
        self.set_camera_yaw_pitch(yaw, pitch)

    def set_camera_look_at_location(self, x, y=None, z=None) -> None:
        self.set_camera_look_at(x, y, z)

    def set_transfer_function_range(self, vmin, vmax=None) -> None:
        if vmax is None:  # scripts also pass one (min, max) tuple
            vmin, vmax = vmin
        self.set_transfer_functions_range(vmin, vmax)

    def set_camera_checkpoint(self, name: str) -> None:
        cp = self._w.checkpoints.get(name)
        if cp is None:
            # The reference resolves checkpoints from the user's saved
            # CameraCheckpoints file; scripts referencing one that is
            # not registered keep the current camera (warn, no crash).
            import warnings

            warnings.warn(f"unknown camera checkpoint {name!r} (ignored)")
            return
        self._w._current.camera_position = np.asarray(cp["position"], np.float32)
        self._w._current.camera_look_at = np.asarray(cp["look_at"], np.float32)

    def set_transfer_functions(self, names: list) -> None:
        """Per-variable TFs for multi-var rendering (py_set_transfer_functions,
        ReplayWidget.cpp:121-155)."""
        self._w._current.multi_var_transfer_functions = [str(n) for n in names]

    def set_transfer_functions_ranges(self, ranges: list) -> None:
        self._w._current.multi_var_transfer_function_ranges = [
            (float(r[0]), float(r[1])) for r in ranges
        ]

    def convert_yaw_pitch_rad_to_quaternion(self, yaw, pitch=None):
        """(x, y, z, w) of angleAxis(-pitch, X) * angleAxis(yaw + pi/2, Y)
        (py_convert_yaw_pitch_rad_to_quaternion, ReplayWidget.cpp:448-473)."""
        if pitch is None:
            yaw, pitch = yaw
        ax = -float(pitch) * 0.5
        ay = (float(yaw) + math.pi / 2.0) * 0.5
        q1 = np.array([math.sin(ax), 0.0, 0.0, math.cos(ax)])  # X axis
        q2 = np.array([0.0, math.sin(ay), 0.0, math.cos(ay)])  # Y axis
        x1, y1, z1, w1 = q1
        x2, y2, z2, w2 = q2
        return (
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        )

    def get_default_camera_fov_deg(self) -> float:
        return math.degrees(Camera().fovy)

    def set_transfer_function(self, name_or_path: str) -> None:
        self._w._current.transfer_function = name_or_path

    def set_use_camera_flight(self, value: bool) -> None:
        self._w.use_camera_flight = bool(value)

    def set_render_every_frame(self, value: bool) -> None:
        self._w.render_every_frame = bool(value)

    def save_screenshot(self, filename: str) -> None:
        self._w._current.screenshot = filename


class ReplayWidget:
    """Executes replay scripts and plays back the keyframe timeline."""

    def __init__(
        self,
        dataset_loader: Callable[[str], "object"],
        fps: float = 30.0,
        output_dir: str = "out",
        device="cuda",
    ):
        self.dataset_loader = dataset_loader
        self.fps = fps
        self.output_dir = output_dir
        self.device = device
        # Directory searched for transfer-function names used by
        # set_transfer_function(s) (the reference's
        # Data/TransferFunctions/); absolute paths work without it.
        self.transfer_function_dir: Optional[str] = None
        self.states: List[ReplayState] = []
        self._current = ReplayState()
        self.checkpoints: Dict[str, dict] = {}
        self.use_camera_flight = False
        self.render_every_frame = True
        self.frame_callback: Optional[Callable] = None
        self.tracer_callback: Optional[Callable] = None

    def _commit_state(self) -> None:
        self.states.append(self._current)
        self._current = dataclasses.replace(self._current, screenshot=None,
                                            dataset=None, renderer=None,
                                            renderer_settings=None,
                                            dataset_settings=None,
                                            transfer_function=None,
                                            transfer_function_range=None,
                                            multi_var_transfer_functions=None,
                                            multi_var_transfer_function_ranges=None,
                                            tracer_settings=None)

    def load_script(self, path_or_code: str) -> None:
        """Execute a replay script that calls the `g` API.

        Reference scripts (`Data/ReplayScripts/*.py`) also `import g` and
        `from modules.campath import ...`; compat module shims are
        installed for the duration of the exec (replay_compat.py)."""
        from linevis_tpu_torch.automation.replay_compat import (
            install_compat_modules,
            remove_compat_modules,
        )

        code = path_or_code
        if os.path.exists(path_or_code):
            with open(path_or_code) as f:
                code = f.read()
        g = _GApi(self)
        saved = install_compat_modules(g)
        try:
            ns = {"g": g}
            exec(compile(code, "<replay>", "exec"), ns)
            # Reference convention (ReplayWidget.cpp:700-702): the script
            # defines `replay()` and the widget calls it after import.
            # Inline g.* calls at module level (our shorthand) also work.
            replay_fn = ns.get("replay")
            if callable(replay_fn):
                replay_fn()
        finally:
            remove_compat_modules(saved)
        self._commit_state()

    def run(self, width: int = 800, height: int = 600) -> int:
        """Plays the timeline; returns the number of frames rendered."""
        os.makedirs(self.output_dir, exist_ok=True)
        line_data = None
        renderer = None
        cam = Camera(width=width, height=height)
        pos = np.asarray(cam.position, np.float32)
        look = np.asarray(cam.look_at_point, np.float32)
        quat: Optional[np.ndarray] = None
        prev_settings: Dict[str, str] = {}
        frames = 0
        flight_path = None
        total_d = 0.0
        elapsed = 0.0
        for state in self.states:
            if state.dataset is not None:
                line_data = self.dataset_loader(state.dataset)
            if state.renderer is not None:
                renderer = create_renderer(state.renderer, device=self.device)
                if line_data is not None:
                    renderer.set_line_data(line_data)
            if renderer is not None and line_data is not None and renderer.line_data is None:
                renderer.set_line_data(line_data)
            if state.dataset_settings is not None and line_data is not None:
                line_data.set_new_settings(state.dataset_settings)
            if state.transfer_function is not None and renderer is not None:
                tf_path = state.transfer_function
                if not os.path.exists(tf_path) and self.transfer_function_dir:
                    tf_path = os.path.join(self.transfer_function_dir, tf_path)
                if os.path.exists(tf_path):
                    renderer.set_transfer_function(
                        TransferFunction.from_xml(tf_path)
                    )
            if state.transfer_function_range is not None and renderer is not None:
                renderer.transfer_function_range = state.transfer_function_range
            if (state.multi_var_transfer_functions is not None
                    and renderer is not None):
                renderer.multi_var_tf_names = state.multi_var_transfer_functions
            if (state.multi_var_transfer_function_ranges is not None
                    and renderer is not None):
                renderer.multi_var_tf_ranges = (
                    state.multi_var_transfer_function_ranges)
            if state.tracer_settings is not None and self.tracer_callback:
                self.tracer_callback(state.tracer_settings)

            target_pos = state.camera_position if state.camera_position is not None else pos
            target_look = state.camera_look_at if state.camera_look_at is not None else look
            target_quat = state.camera_orientation
            n_frames = max(int(round(state.duration * self.fps)), 0)

            # Split settings into static (applied once) and dynamic
            # (numeric, interpolated per frame from the previous values —
            # ReplayWidget.hpp:104-160 setStaticSettings /
            # setInterpolatedDynamicSettings).
            dynamic: Dict[str, tuple] = {}
            if state.renderer_settings is not None and renderer is not None:
                static = SettingsMap()
                for key, val in state.renderer_settings.items():
                    new_num = _parse_numeric(val)
                    old_num = (
                        _parse_numeric(prev_settings.get(key))
                        if key in prev_settings else None
                    )
                    if (n_frames > 0 and new_num is not None
                            and old_num is not None
                            and np.shape(new_num) == np.shape(old_num)):
                        dynamic[key] = (old_num, new_num)
                    else:
                        static.add_key_value(key, val)
                    prev_settings[key] = str(val)
                renderer.set_new_settings(static)

            if n_frames == 0:
                pos, look = target_pos, target_look
                if target_quat is not None:
                    quat = target_quat
                if state.renderer_settings is not None and renderer is not None:
                    renderer.set_new_settings(state.renderer_settings)
            for i in range(n_frames):
                # Linear interpolation of numeric state + slerp of the
                # camera orientation (ReplayWidget.hpp:128, .cpp:870).
                t = (i + 1) / n_frames
                p = (1 - t) * pos + t * np.asarray(target_pos, np.float32)
                la = (1 - t) * look + t * np.asarray(target_look, np.float32)
                if target_quat is not None:
                    q = (slerp(quat, target_quat, t)
                         if quat is not None else target_quat)
                    dist = float(np.linalg.norm(la - p)) or 1.0
                    la = p + _quat_rotate(q, (0.0, 0.0, -1.0)) * dist
                if dynamic and renderer is not None:
                    interp = SettingsMap()
                    for key, (v0, v1) in dynamic.items():
                        v = (1 - t) * v0 + t * v1
                        interp.add_key_value(
                            key,
                            " ".join(str(c) for c in np.atleast_1d(v))
                            if np.ndim(v) else str(v),
                        )
                    renderer.set_new_settings(interp)
                if self.use_camera_flight and line_data is not None:
                    # Camera flight mode (MainApp.cpp:2417): the camera
                    # follows the circle path around the data's AABB for
                    # the whole timeline; scripted positions are ignored.
                    if flight_path is None:
                        from linevis_tpu_torch.automation.camera_path import (
                            CameraPath,
                        )

                        flight_path = CameraPath.from_circle_path(
                            line_data.get_aabb()
                        )
                        total_d = max(
                            sum(s.duration for s in self.states), 1e-6
                        )
                    t_abs = (elapsed + (i + 1) / self.fps) / total_d
                    p, la = flight_path.camera_at(
                        min(t_abs, 1.0) * flight_path.total_time
                    )
                cam = dataclasses.replace(
                    cam, position=tuple(p), look_at_point=tuple(la)
                )
                if renderer is not None and (self.render_every_frame or i == n_frames - 1):
                    img = renderer.render(cam)
                    frames += 1
                    if self.frame_callback:
                        self.frame_callback(frames, img)
            elapsed += state.duration
            if n_frames:
                pos, look = np.asarray(target_pos, np.float32), np.asarray(
                    target_look, np.float32
                )
                if target_quat is not None:
                    quat = target_quat
            if state.screenshot and renderer is not None:
                cam = dataclasses.replace(
                    cam, position=tuple(pos), look_at_point=tuple(look)
                )
                img = renderer.render(cam)
                frames += 1
                save_png(os.path.join(self.output_dir, state.screenshot), img)
        return frames

    # Camera checkpoints (reference sgl CheckpointWindow; JSON persistence).
    def save_checkpoints(self, path: str) -> None:
        import json

        with open(path, "w") as f:
            json.dump(
                {
                    k: {"position": list(map(float, v["position"])),
                        "look_at": list(map(float, v["look_at"]))}
                    for k, v in self.checkpoints.items()
                },
                f,
            )

    def load_checkpoints(self, path: str) -> None:
        import json

        with open(path) as f:
            self.checkpoints = json.load(f)
