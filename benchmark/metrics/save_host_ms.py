"""Host milliseconds a tick in the burst's saves: the program's
``burst_save`` spans (``rollout.rollout_burst``, one a save:
``state.ring_save``'s launch of the checksum kernel), summed over the
window and divided by its ticks. Empty (None) where the program records
no such span."""


def read(w):
    span = w.program_spans.get("burst_save")
    return span["total_ms"] / w.units if span and w.units else None
