"""Mean host milliseconds of ``SyncTestSession.advance_frame`` a tick: the
benchmark's span around the session's call in each tick of the window."""


def read(w):
    return w.spans.mean_ms("layer.session.advance_frame")
