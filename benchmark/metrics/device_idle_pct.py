"""Share of the traced window in which no operation ran on the card: 100
minus the union of the device operations' intervals over the window. It
reads ``device_idle_pct.<kind>`` for every kind of window (``.tick``,
``.rollout``), each moving its cell's rate."""


def read(w):
    if not w.trace.ops or w.seconds <= 0:
        return None
    return 100.0 - 100.0 * w.trace.busy_s() / w.seconds
