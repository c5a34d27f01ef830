"""The plain PyTorch stages' device time a frame: every kernel of the
window that is not a hand-written one and not a copy or fill, ms. Moves
frame_ms."""

from linebench.devtrace import is_kernel
from linebench.metrics._common import handwritten_names, ms_a_frame, traced

UNIT = "ms"


def read(run):
    if not traced(run):
        return None
    t = run["trace"]
    kernels = sum(s for n, s in t.by_name.items() if is_kernel(n))
    return ms_a_frame(run, kernels - t.seconds_matching(handwritten_names(run)))
