"""The modules that no run may load: JAX and the JAX package.

Names are compared whole, as top-level names (the part before the first
dot), so that the port `voxtpu_torch` is not taken for `voxtpu`.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "voxtpu"})


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
