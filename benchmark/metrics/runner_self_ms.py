"""The runner's own host milliseconds a tick: the self time of its
``handle_requests`` and ``dispatch`` spans, that is ``handle_requests``
less the spans inside it that other readers take (``checksum_sync``,
``restore_guard``, ``burst_setup``, ``burst_save``, ``burst_step``), from
the program's span totals, divided by the window's ticks: the segmenting,
masks and stacks, bookkeeping and Python between the parts. With
``step_host_ms``, ``save_host_ms``, ``guard_wait_ms`` and
``burst_setup_ms`` it sums to ``runner_host_ms``. Empty (None) where the
program records no burst spans."""

PARTS = ("checksum_sync", "restore_guard", "burst_setup", "burst_save", "burst_step")


def read(w):
    spans = w.program_spans
    if not w.units or not all(k in spans for k in ("handle_requests", "burst_setup",
                                                   "burst_step")):
        return None
    inside = sum(spans[k]["total_ms"] for k in PARTS if k in spans)
    return (spans["handle_requests"]["total_ms"] - inside) / w.units
