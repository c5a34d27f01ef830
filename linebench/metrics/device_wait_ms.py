"""The host's wait for the device's queued work before the image's copy:
the program's `handback.wait` span (an explicit synchronize, issued only
while tracing), host ms a frame of the traced window. Moves frame_ms."""

from linebench.metrics._common import ms_a_frame
from linebench.metrics._spans import span_seconds

UNIT = "ms"


def read(run):
    s = span_seconds(run)
    if s is None or "handback.wait" not in s:
        return None
    return ms_a_frame(run, s["handback.wait"])
