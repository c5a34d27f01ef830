"""The hand-written CUDA kernels' device time a frame (the launches named
in `kernels/`), ms. Moves frame_ms."""

from linebench.metrics._common import handwritten_names, ms_a_frame, traced

UNIT = "ms"


def read(run):
    if not traced(run):
        return None
    return ms_a_frame(run, run["trace"].seconds_matching(handwritten_names(run)))
