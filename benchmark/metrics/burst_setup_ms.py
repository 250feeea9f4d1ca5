"""Host milliseconds a tick in the burst's set-up: the program's
``burst_setup`` spans (``RolloutExecutor.run``: the rollback's
``ring_load`` and the uploads of the inputs' bits and status), summed over
the window and divided by its ticks. Empty (None) where the program
records no such span."""


def read(w):
    span = w.program_spans.get("burst_setup")
    return span["total_ms"] / w.units if span and w.units else None
