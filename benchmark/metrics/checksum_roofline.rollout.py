"""The checksum kernel's share of its roofline in speculative rollouts: the
least time of the window's batched saves, one a frame saving every branch
(bytes only, ``roofline/counts.py``), over the trace time of
``world_checksum_kernel``."""

from benchmark.roofline import counts


def read(w):
    launches = w.counters.get("world_checksum", 0)
    seconds, _ = w.trace.seconds_of("world_checksum_kernel")
    if not launches or seconds <= 0:
        return None
    saves = launches * int(w.counters.get("branches", 1))
    return 100.0 * counts.checksum_least_s(w.cell.config, saves) / seconds
