"""The no-op rollback ledger the runner uses when no ledger is installed.

Stands in for ``bevy_ggrs_tpu/obs/ledger.py``'s :data:`null_ledger`, which
the speculation part of the port brings with the ledger itself.
"""

from __future__ import annotations


class _NullLedger:
    enabled = False

    def record(self, outcome: str, **kw) -> None:
        pass


null_ledger = _NullLedger()
