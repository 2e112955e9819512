"""Argument validation that survives ``python -O``.

Library guards (kernel shape constraints, framing limits) must not be
``assert``: a stripped assert would let a bad geometry reach a kernel.
``check`` raises ``ValueError`` unconditionally.
"""

from __future__ import annotations


def check(cond: bool, msg: str) -> None:
    """Raise ``ValueError(msg)`` unless ``cond``."""
    if not cond:
        raise ValueError(msg)
