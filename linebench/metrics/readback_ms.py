"""The image's copy to the host a frame: device time of the window's
device-to-host copies (the registry's `.cpu().numpy()`), ms a frame.
Moves frame_ms."""

from linebench.metrics._common import ms_a_frame, traced

UNIT = "ms"


def read(run):
    if not traced(run):
        return None
    return ms_a_frame(run, run["trace"].dtoh_s)
