"""The image's hand-back on the host: the program's `handback.copy` (the
copy to host memory) and `handback.host` (the channel move and the box
filter of a supersampled frame) spans, host ms a frame of the traced
window. Moves frame_ms."""

from linebench.metrics._common import ms_a_frame
from linebench.metrics._spans import span_seconds

UNIT = "ms"


def read(run):
    s = span_seconds(run)
    if s is None or not {"handback.copy", "handback.host"} & set(s):
        return None
    return ms_a_frame(run, s.get("handback.copy", 0.0) + s.get("handback.host", 0.0))
