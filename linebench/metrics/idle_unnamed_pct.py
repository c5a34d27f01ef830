"""The share of the device's idle gaps in the traced window that no host
event names: the gaps the trace's reduction labels "host, outside PyTorch
operations" over all the gaps it labels, %. Program spans name the gaps
they cover. Moves frame_ms."""

from linebench.metrics._common import traced

UNIT = "%"
UNNAMED = "host, outside PyTorch operations"


def read(run):
    if not traced(run):
        return None
    gaps = run["trace"].idle_by_host_op
    total = sum(s for _, s in gaps)
    if total <= 0.0:
        return None
    return 100.0 * sum(s for n, s in gaps if n == UNNAMED) / total
