"""Axis-aligned bounding box of point sets (port of
`voxtpu/mesh/bounding_box.py`): per-axis (min, max) and the longest
side, which fits the shared voxel grid (voxel_size = longest_side / N).
"""

from __future__ import annotations

import numpy as np

# Rows a wide row holds: NumPy reduces a C-contiguous (P, 3) array along
# axis 0 with an inner loop three elements long, a (P // _WIDE, 3 * _WIDE)
# view with one 3072 long, about 50x faster at a million points.
_WIDE = 1024


def _reduce(coords: np.ndarray, op) -> np.ndarray:
    """`op.reduce(coords, axis=0)` of (P, 3) float32 through the wide
    view: its rows reduced to one (3 * _WIDE,) row, folded to (_WIDE, 3)
    and reduced again; the P % _WIDE tail rows reduced apart."""
    whole = coords.shape[0] - coords.shape[0] % _WIDE
    parts = []
    if whole:
        wide = op.reduce(coords[:whole].reshape(-1, 3 * _WIDE), axis=0)
        parts.append(op.reduce(wide.reshape(_WIDE, 3), axis=0))
    if whole < coords.shape[0]:
        parts.append(op.reduce(coords[whole:], axis=0))
    return op.reduce(parts, axis=0)


def calculate_bounding_box(coords: np.ndarray):
    """Return ``(longest_side, (min_xyz, max_xyz))`` for (P, 3) coords.

    min and max are exact, so the wide reduction's order gives voxtpu's
    values (a NaN coordinate makes its axis NaN, as there). The one thing
    order can change is the sign of a zero corner, and -0.0 and 0.0 give
    the same grid."""
    coords = np.asarray(coords, np.float32).reshape(-1, 3)
    if coords.shape[0] == 0:
        raise ValueError("empty point set")
    mins = _reduce(coords, np.minimum)
    maxs = _reduce(coords, np.maximum)
    side = float((maxs - mins).max())
    return side, (mins, maxs)
