"""The no-op tracer the runner uses when no tracer is installed.

Counterpart of ``bevy_ggrs_tpu/obs/trace.py``'s :data:`null_tracer`: every
instrument is O(1) and allocation-free, so instrumented code calls it
unconditionally.
"""

from __future__ import annotations


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _NullTracer:
    __slots__ = ()

    enabled = False
    _span = _NullSpan()

    def span(self, name: str, **args) -> _NullSpan:
        return self._span

    def instant(self, name: str, **args) -> None:
        pass


null_tracer = _NullTracer()
