"""Typed control-plane errors (DESIGN.md §15, §17).

``RecoveryError`` replaces the bare ``assert self.ckpt_dir`` that used to
guard ``fail_stop_recover``: asserts vanish under ``python -O``, and the
scheduler needs a typed signal it can catch to retire the event as
``aborted`` instead of crashing the replay loop. Raised when a fail-stop
cannot be recovered by *any* rung — the survivor set (plus parity) cannot
cover the state and no checkpoint directory is configured.

Lives in ``core`` (not ``elastic.redundancy``) so the reshard engine can
refuse to execute ``kind == "lost"`` tasks without importing the elastic
package (which imports reshard back — a cycle).
"""

from __future__ import annotations


class RecoveryError(RuntimeError):
    """No recovery rung can restore the state; fail loudly with context."""


class ProtocolError(RuntimeError):
    """Malformed or unsupported control-plane message (DESIGN.md §17):
    unknown type tag, missing required field, or a schema version newer
    than this decoder. Also raised driver-side when an endpoint answers a
    command with an unexpected ``ErrorResponse``."""


class TraceError(ValueError):
    """Malformed volatility-trace row (``elastic/trace.py``): unknown
    event kind, non-positive device count, negative/NaN warning window or
    timestamp, or invalid lost-rank list. Raised at trace-load time so a
    bad row fails the replay up front instead of mid-run with an opaque
    topology-search error."""
