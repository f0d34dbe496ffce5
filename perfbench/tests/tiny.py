"""Cells cut to a size the CPU holds, for the tests: the same generators,
checks and readers, at n = 64 on meshes of a few thousand faces."""

from __future__ import annotations

import copy

FACES = {"washer": 20000, "torus": 9216}
N = 64


def tiny(cell):
    """A copy of `cell` at the tests' size."""
    cell = copy.deepcopy(cell)
    cell.config["n"] = N
    cell.config["mesh"]["faces"] = FACES[cell.config["mesh"]["shape"]]
    return cell
