"""The triangle force kernel's share of its roofline: the least time of
the dense force steps it ran in the window (``roofline/counts.py``, one
world each) over the trace time of its two passes, ``tri_tiles_kernel``
and ``tri_combine_kernel``."""

from benchmark.roofline import counts


def read(w):
    launches = w.counters.get("pairwise_force_square_mxu_tri", 0)
    seconds, _ = w.trace.seconds_of("tri_tiles_kernel", "tri_combine_kernel")
    if not launches or seconds <= 0:
        return None
    least = launches * counts.dense_force_least_s(int(w.cell.config["num_boids"]))
    return 100.0 * least / seconds
