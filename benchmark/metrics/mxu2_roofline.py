"""The general tensor-core force kernel's share of its roofline: the least
time of the dense force steps of every branch it ran in the window
(``roofline/counts.py``) over the trace time of
``pairwise_force_rows_mxu_kernel``."""

from benchmark.roofline import counts


def read(w):
    launches = w.counters.get("pairwise_force_rows_mxu2", 0)
    seconds, _ = w.trace.seconds_of("pairwise_force_rows_mxu_kernel")
    if not launches or seconds <= 0:
        return None
    worlds = launches * int(w.counters.get("branches", 1))
    least = counts.dense_force_least_s(int(w.cell.config["num_boids"]), worlds)
    return 100.0 * least / seconds
