"""The host's time issuing a frame: the program's `frame` span less its
hand-back spans (`handback.wait`, `handback.copy`, `handback.host`), host ms
a frame of the traced window. Moves frame_ms."""

from linebench.metrics._common import ms_a_frame
from linebench.metrics._spans import span_seconds

UNIT = "ms"
HANDBACK = ("handback.wait", "handback.copy", "handback.host")


def read(run):
    s = span_seconds(run)
    if s is None:
        return None
    return ms_a_frame(run, s["frame"] - sum(s.get(k, 0.0) for k in HANDBACK))
