"""Host milliseconds a tick in the schedule's steps of the burst: the
program's ``burst_step`` spans (``rollout.rollout_burst``, one an advanced
frame: the flock's forces through ``schedule.py`` and the frame count),
summed over the window and divided by its ticks. Empty (None) where the
program records no such span."""


def read(w):
    span = w.program_spans.get("burst_step")
    return span["total_ms"] / w.units if span and w.units else None
