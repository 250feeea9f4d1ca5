"""Host milliseconds a tick in the restore guard: the program's
``restore_guard`` spans (``runner.py`` around ``integrity.verify_row``:
the guard kernel's launch and its 4-byte read, which waits for the
card), summed over the window and divided by its ticks. Empty (None)
where the program records no such span."""


def read(w):
    span = w.program_spans.get("restore_guard")
    return span["total_ms"] / w.units if span and w.units else None
