"""Request tracing, as far as the serving path calls it.

The serving plane opens spans at its stage boundaries through
:func:`start_span`; a request with no trace context (``None``) opens
none and pays nothing. The port does not yet adopt ``traceparent``
headers or keep a span ring (``/traces``), so every request is untraced
and :func:`start_span` returns None. :func:`set_role` records the
worker's serving role for the spans a later slice will record.
"""

from __future__ import annotations

from typing import Optional

_role = "unified"


def set_role(role: str) -> None:
    """Stamp this process's serving role (unified/prefill/decode)."""
    global _role
    _role = str(role)


def start_span(name: str, parent, **tags) -> Optional[object]:
    """Child span under ``parent``; None for an untraced request."""
    if parent is None:
        return None
    raise NotImplementedError(
        f"span {name!r}: request tracing is not ported yet"
    )
