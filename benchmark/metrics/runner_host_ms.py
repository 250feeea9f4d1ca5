"""Host milliseconds a tick that ``RollbackRunner.handle_requests`` spends
other than waiting for the checksums it reads back: the program's own
spans (the runner's ``tracer``), ``handle_requests`` less
``checksum_sync``, summed over the window and divided by its ticks. The
dispatch of the burst, the restore guard's launch and its 4-byte read,
the session's bookkeeping; not the burst's device time, which the
read-back waits for."""


def read(w):
    spans = w.program_spans
    if "handle_requests" not in spans or not w.units:
        return None
    waited = spans.get("checksum_sync", {}).get("total_ms", 0.0)
    return (spans["handle_requests"]["total_ms"] - waited) / w.units
