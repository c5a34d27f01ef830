"""The AO pair sort's dropped pairs: of the (cell, ray) keys
`kernels/ao_grid.py:expand_ray_pairs` hands to the sort
(`ao.pairs_sorted`), the share not kept for the trace, with no cell below
G^3 (`ao.pairs_kept`), %. Counted by the program in the traced window.
Moves frame_ms."""

from linebench.metrics._spans import counts

UNIT = "%"


def read(run):
    c = counts(run)
    if not c or not c.get("ao.pairs_sorted"):
        return None
    return 100.0 * (c["ao.pairs_sorted"] - c["ao.pairs_kept"]) / c["ao.pairs_sorted"]
