"""Metric taps: how telemetry gets values out of the reduce without a host sync.

The port of ``repro.obs.taps``, with the same key strings.
``tap(name, value, **labels)`` records ``value`` into the innermost active
collector and does nothing when none is active. ``collect()`` opens a
collector; the entry point that opened it (``scalecom_reduce`` with
``telemetry=True``) returns what was collected as ``"obs/<key>"`` entries of
its stats. Values are 0-d tensors left on the device: nothing is copied to
the host, so a tap never waits for the card.

Keys are ``name{label=value,...}`` with labels sorted by name, so one tap
site always gives one key, and ``parse_key`` reads the labels back.
Conventional labels: ``path`` (tensor), ``bucket`` (launch bucket index),
``compressor``, ``codec``.

This module imports nothing of the port, so any module can tap.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Tuple

__all__ = ["active", "tap", "tap_key", "parse_key", "collect"]

# innermost-last stack of open collectors, scoped by ``collect()``
_STACK: List[Dict[str, Any]] = []


def active() -> bool:
    """True if some caller up the stack is collecting taps: code computes a
    value that only feeds a tap under this test, so telemetry off costs
    nothing."""
    return bool(_STACK)


def tap_key(name: str, **labels: Any) -> str:
    """``name{k=v,...}`` with the labels sorted by name."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def parse_key(key: str) -> Tuple[str, Dict[str, str]]:
    """Invert ``tap_key``: ``"a{x=1,y=2}"`` -> ``("a", {"x": "1", "y": "2"})``."""
    if not key.endswith("}") or "{" not in key:
        return key, {}
    name, _, rest = key.partition("{")
    labels: Dict[str, str] = {}
    for part in rest[:-1].split(","):
        if "=" in part:
            k, _, v = part.partition("=")
            labels[k] = v
    return name, labels


def tap(name: str, value: Any, **labels: Any) -> None:
    """Record ``value`` under ``tap_key(name, **labels)`` in the innermost
    collector; a no-op when none is open. A repeated key overwrites."""
    if not _STACK:
        return
    _STACK[-1][tap_key(name, **labels)] = value


@contextlib.contextmanager
def collect() -> Iterator[Dict[str, Any]]:
    """Collect every ``tap`` fired inside the block into the yielded dict.
    Collectors nest: an inner one shadows the outer."""
    collected: Dict[str, Any] = {}
    _STACK.append(collected)
    try:
        yield collected
    finally:
        _STACK.pop()
