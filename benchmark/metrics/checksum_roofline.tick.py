"""The checksum kernel's share of its roofline in SyncTest ticks: the least
time of the window's saves and restore guards (bytes only,
``roofline/counts.py``; the runner's ``saves_total`` and
``restore_guards_total``) over the trace time of ``world_checksum_kernel``."""

from benchmark.roofline import counts


def read(w):
    saves, guards = w.counters.get("saves", 0), w.counters.get("guards", 0)
    seconds, _ = w.trace.seconds_of("world_checksum_kernel")
    if not w.counters.get("world_checksum", 0) or seconds <= 0:
        return None
    return 100.0 * counts.checksum_least_s(w.cell.config, saves, guards) / seconds
