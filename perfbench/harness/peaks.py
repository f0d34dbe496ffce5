"""The card's peaks and the least time a piece of work could take.

NVIDIA H100 SXM (80 GB HBM3) at its 700 W limit, from NVIDIA's data
sheet and the SM's issue rates (compute capability 9.0): 3.35 TB/s of
HBM, 67 TFLOP/s float32 outside the tensor cores (an FMA counted as two
operations), uncontracted float32 operations (each add, subtract or
multiply rounded on its own, as the JFA's exact distance must be) at 128
a clock on each of 132 SMs at 1.98 GHz, float32 compares at 64, and
special-function results (expf's ex2, the reciprocal behind a division)
at 16. These are copies of `chip_smoke.py`'s table, so that a share of
the roofline reads the same work whatever implements it.

The operation counts are the functions' own, taken from their shapes
and inputs, whatever a kernel does beyond them:

- `flood_ops`: one JFA step at stride k, from the seeds it reads (the
  count of `chip_smoke.py::flood_ops`).
- `soft_ops`: one soft forward and backward over live fragments and the
  (fragment, column) pairs inside their transition windows (the count of
  `chip_smoke.py::soft_bound`, with `seg_windows`' pairs).
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
F32_UNFUSED_OP_S = 128 * 132 * 1.98e9
CMP_OP_S = 64 * 132 * 1.98e9
SFU_OP_S = 16 * 132 * 1.98e9

# Soft kernels: float32 and special-function operations a forward or a
# backward (fragment, column) pair needs; a fragment's rebuild (3 edge
# sigmoids, weight, x-hit) and, backward, its chain rule to the vertex
# cotangents.
PAIR_FWD = (9, 3)
PAIR_BWD = (14, 3)
FRAG_REBUILD = (37, 9)
FRAG_CHAIN = (30, 3)
# Where (x_hit - cx) / tau_x leaves the transition window: at or above
# SAT_HI the sigmoid is 1 in float32, at or below SAT_LO its term is 0.
SAT_HI, SAT_LO = 17.0, -29.0


def least_seconds(nbytes: float, flops: float = 0.0, unfused: float = 0.0,
                  cmp: float = 0.0, sfu: float = 0.0) -> float:
    """The least time for `nbytes` of device memory traffic and the
    operations given (each unit at its own rate, side by side)."""
    t_ops = max(flops / F32_FLOP_S + unfused / F32_UNFUSED_OP_S, cmp / CMP_OP_S,
                sfu / SFU_OP_S)
    return max(nbytes / HBM_BYTES_S, t_ops)


def flood_ops(seeded: int, pairs: int, candidates: int, n: int) -> tuple[int, int]:
    """(uncontracted float32 operations, compares) of one flood step on
    an n^3 grid: each grid index's world coordinate once an axis (2 a
    value, 6 n), each seed's unpack into world coordinates (9), each
    seeded (source entry, voxel column) pair's (px - sx)^2 + (py - sy)^2
    (5), each seeded candidate's (pz - sz)^2 and sum (3); one compare a
    seeded candidate but the voxel's own seed."""
    return 6 * n + 9 * seeded + 5 * pairs + 3 * candidates, candidates - seeded


def soft_ops(fragments: int, pairs: int) -> tuple[int, int]:
    """(float32 operations, special-function operations) of one soft
    forward and backward over `fragments` live fragments and `pairs`
    (fragment, column) pairs in their windows."""
    flops = pairs * (PAIR_FWD[0] + PAIR_BWD[0]) + fragments * (
        2 * FRAG_REBUILD[0] + FRAG_CHAIN[0])
    sfu = pairs * (PAIR_FWD[1] + PAIR_BWD[1]) + fragments * (
        2 * FRAG_REBUILD[1] + FRAG_CHAIN[1])
    return flops, sfu
