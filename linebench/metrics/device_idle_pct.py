"""The share of the traced window in which no operation ran on the device,
%. Moves frame_ms."""

from linebench.metrics._common import traced

UNIT = "%"


def read(run):
    if not traced(run):
        return None
    t = run["trace"]
    return 100.0 * (1.0 - t.busy_s / t.window_s)
