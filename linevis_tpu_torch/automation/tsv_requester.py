"""3D-TSV stress-line tracing requester (ZeroMQ REQ/REP).

Counterpart of `linevis_tpu/automation/tsv_requester.py` (reference
`src/LineData/Stress/StressLineTracingRequester{,Socket}.{hpp,cpp}`): a
worker thread talks to the external 3D-TSV MATLAB principal-stress-line
tracer over TCP (default localhost:17384,
StressLineTracingRequesterSocket.hpp:49) with a JSON REQ/REP protocol
(request keys per StressLineTracingRequester.cpp:263-295); the reply names
`.dat` files, loaded with the stress loader into a `LineDataStress` that the
registry draws on any device. Seed strategies Volume / Surface /
LoadingArea / FixedArea (StressLineTracingRequester.hpp:46-51).

Host-side, on pyzmq, imported when a requester is made, so the package
works without it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import List, Optional

__all__ = ["StressLineTracingSettings", "StressLineTracingRequester",
           "SEED_STRATEGIES"]

SEED_STRATEGIES = ("Volume", "Surface", "LoadingArea", "FixedArea")


@dataclasses.dataclass
class StressLineTracingSettings:
    """Request fields (StressLineTracingRequester.cpp:263-295)."""

    mesh_filename: str = ""
    line_density_control: Optional[float] = None  # None -> "default"
    num_levels: Optional[int] = None
    seed_strategy: str = "Volume"
    seed_density_control: Optional[float] = None
    trace_major: bool = True
    trace_medium: bool = True
    trace_minor: bool = True
    merging_opt: bool = False
    snapping_opt: bool = True
    max_angle_deviation: float = 6.0
    multi_merging_thresholds: Optional[List[float]] = None

    def to_request_json(self) -> str:
        req = {
            "fileName": self.mesh_filename,
            "lineDensCtrl": (
                self.line_density_control
                if self.line_density_control is not None else "default"
            ),
            "numLevels": (
                self.num_levels if self.num_levels is not None else "default"
            ),
            "seedStrategy": self.seed_strategy,
            "seedDensCtrl": (
                self.seed_density_control
                if self.seed_density_control is not None else "default"
            ),
            "selectedPrincipalStressField": [
                i + 1
                for i, on in enumerate(
                    (self.trace_major, self.trace_medium, self.trace_minor)
                )
                if on
            ],
            "mergingOpt": self.merging_opt,
            "snappingOpt": self.snapping_opt,
            "maxAngleDevi": self.max_angle_deviation,
        }
        if self.multi_merging_thresholds is not None:
            req["multiMergingThresholds"] = list(self.multi_merging_thresholds)
        return json.dumps(req)


class StressLineTracingRequester:
    """Mailbox-of-size-1 worker thread (LineDataRequester pattern,
    StressLineTracingRequesterSocket mainLoop)."""

    def __init__(self, address: str = "localhost", port: int = 17384,
                 timeout_ms: int = 10000):
        import zmq

        self._zmq = zmq
        self.endpoint = f"tcp://{address}:{port}"
        self.timeout_ms = timeout_ms
        self._context = zmq.Context.instance()
        self._request: Optional[str] = None
        self._reply: Optional[dict] = None
        self._lock = threading.Condition()
        self._stop = False
        self._thread = threading.Thread(target=self._main_loop, daemon=True)
        self._thread.start()

    # -- public interface (StressLineTracingRequesterSocket.hpp) ------------
    def queue_request(self, settings: StressLineTracingSettings) -> None:
        with self._lock:
            self._request = settings.to_request_json()
            self._lock.notify_all()

    def get_reply(self, timeout: Optional[float] = None) -> Optional[dict]:
        """Returns the parsed reply JSON (or None if none arrived)."""
        with self._lock:
            if self._reply is None:
                self._lock.wait(timeout)
            reply, self._reply = self._reply, None
            return reply

    @staticmethod
    def load_reply_line_data(reply: dict, base_dir: str = ""):
        """Reply -> LineDataStress via the stress .dat loader
        (StressLineTracingRequester.cpp:319-361). It needs no socket, so it
        is also callable on the class, where pyzmq is missing."""
        from linevis_tpu_torch.scene.line_data_stress import LineDataStress

        names = reply.get("fileName", [])
        if isinstance(names, str):
            names = [names]
        paths = [os.path.join(base_dir, n) for n in names]
        version = int(reply.get("version", 3))
        return LineDataStress.load_from_dat(paths, version=version)

    def join(self) -> None:
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        self._thread.join(timeout=2.0)

    # -- worker --------------------------------------------------------------
    def _main_loop(self) -> None:
        zmq = self._zmq
        socket = self._context.socket(zmq.REQ)
        socket.setsockopt(zmq.LINGER, 0)
        socket.setsockopt(zmq.RCVTIMEO, self.timeout_ms)
        socket.setsockopt(zmq.SNDTIMEO, self.timeout_ms)
        socket.connect(self.endpoint)
        try:
            while True:
                with self._lock:
                    while self._request is None and not self._stop:
                        self._lock.wait()
                    if self._stop:
                        return
                    request, self._request = self._request, None
                try:
                    socket.send_string(request)
                    reply = socket.recv_string()
                    parsed = json.loads(reply)
                except Exception as e:  # timeout / broker gone / bad JSON
                    parsed = {"error": str(e)}
                with self._lock:
                    self._reply = parsed
                    self._lock.notify_all()
        finally:
            socket.close(0)
