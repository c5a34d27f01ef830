"""The AO grid trace's (kernel B5, `csrc/ao_grid.cu`) share of its
roofline, %: the least time of the work the occlusion estimator needs a
frame over the kernel's device time a frame. The work is counted by the
plain reference on the rows it computes, scaled to the frame: for each AO
ray the any-hit tests against the segments of the cells sampled along it,
in order, up to its first hit (62 float operations each, and 12, 10, 10
for each root of the body and caps taken); the bytes are each ray read once
(origin, direction, t_max) and its flag written, and each binned segment
record (8 floats) read once. Moves frame_ms."""

from linebench import peaks
from linebench.metrics._common import kernel_ms
from linebench.reference.rtao import AO_OPS_PER_ROOT, AO_OPS_PER_TEST

UNIT = "%"


def read(run):
    ms = kernel_ms(run, "ao_grid")
    c = run["counts"]
    if ms is None or "ao_tests" not in c:
        return None
    flops = c["ao_tests"] * AO_OPS_PER_TEST + sum(
        n * o for n, o in zip(c["ao_roots"], AO_OPS_PER_ROOT))
    nbytes = c["ao_rays"] * (7 * 4 + 4) + c["ao_records"] * 8 * 4
    return 100.0 * peaks.least_ms(float_ops=flops, nbytes=nbytes) / ms
