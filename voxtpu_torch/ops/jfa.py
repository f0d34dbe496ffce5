"""Jump Flooding SDF — seed init, the wide flood and dispatch.

Port of `voxtpu/ops/jfa.py`: `_boundary_mask`, `jfa_init_seed`, the
wide (hi, lo) seed encoding and its flood (`jfa_init_seed_wide`,
`_flood_step_seed_wide`, `jfa_wide`), all torch ops, and the `jfa()`
entry point.

Output contract (== the reference, `jfa/sequential.cpp:24-125`):
float32 signed **squared** world distance in [z, y, x] order; surface
seeds 0, interior positive, exterior negative; unreached voxels keep
+/-inf.

Two seed encodings (`encoding`, checked as voxtpu's `jfa_xla` checks
it): ``"packed"``, one int32 grid of 10-bit (z, y, x) fields, -1 where
no seed is known, so N <= 1024; ``"wide"``, a pair of int32 grids hi =
(z << 16) | y (-1: no seed) and lo = x, N <= 16384; ``"auto"`` takes
packed up to N = 1024 and wide above.

Backends: ``"reference"`` (the NumPy oracle), ``"cuda"`` (voxtpu's
``"pallas"``: the packed flood of `ops/jfa_cuda.py` up to N = 1024,
kernels on CUDA tensors, their plain torch versions on the CPU; `pipe`
or `JFA_PIPE=1` selects voxtpu's pipelined step B6; above 1024 the wide
flood, as `jfa_pallas` hands those sizes to its stepped XLA flood) and
``"plain"`` (voxtpu's ``"xla"``: the packed flood through the plain
versions, or the wide flood, as `encoding` says, on the grid's device)
and ``"native"`` (voxtpu's C++/OpenMP flood, `voxtpu_torch/native`, on
the host, its field put on the grid's device).
"""

from __future__ import annotations

import torch

from voxtpu_torch.grids.voxel_grid import GridSpec, VoxelGrid
from voxtpu_torch.utils.trace import span

BACKENDS = ("reference", "plain", "cuda", "native")

_OFFSETS = tuple(
    (dz, dy, dx)
    for dz in (-1, 0, 1)
    for dy in (-1, 0, 1)
    for dx in (-1, 0, 1)
    if not (dz == 0 and dy == 0 and dx == 0)
)

_NO_SEED = -1
_MAX_PACKED_N = 1024  # 10-bit seed fields
_MAX_WIDE_N = 16384   # 3 * (N - 1)^2 < 2^31: squared voxel distances exact in int32


def _boundary_mask(occ: torch.Tensor) -> torch.Tensor:
    """Occupied voxels with >= 1 empty or out-of-grid 26-neighbor
    (reference seed rule, `jfa/sequential.cpp:24-64`)."""
    n0, n1, n2 = occ.shape
    padded = torch.zeros((n0 + 2, n1 + 2, n2 + 2), dtype=torch.bool,
                         device=occ.device)
    padded[1:-1, 1:-1, 1:-1] = occ
    all_n = torch.ones_like(occ)
    for dz, dy, dx in _OFFSETS:
        all_n &= padded[1 + dz:n0 + 1 + dz, 1 + dy:n1 + 1 + dy,
                        1 + dx:n2 + 1 + dx]
    return occ & ~all_n


def jfa_init_seed(occ: torch.Tensor) -> torch.Tensor:
    """The flood state: one packed int32 seed grid, (z << 20 | y << 10 |
    x) at boundary voxels, -1 elsewhere."""
    n = occ.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=occ.device)
    packed = ((idx.view(n, 1, 1) << 20) | (idx.view(1, n, 1) << 10)
              | idx.view(1, 1, n))
    return torch.where(_boundary_mask(occ), packed,
                       torch.full_like(packed, _NO_SEED))


# ---------------------------------------------------------------------------
# Wide seed encoding (N <= 16384): (hi, lo) = ((z << 16) | y, x)
# ---------------------------------------------------------------------------
#
# 10-bit packing caps the single-int32 state at N = 1024. For larger
# grids the seed is a pair of int32 grids, hi = (z << 16) | y with -1
# as the no-seed sentinel and lo = x: twice the packed state. 16-bit
# fields hold global coordinates, so a Z-slab of a sharded grid needs
# no re-basing when seeds cross slab boundaries (`z0`).
#
# Selection must be exactly reproducible, so it compares INTEGER
# voxel-space squared distances. voxtpu found (`jfa.py:131-143`) that
# with float32 world distances XLA rematerializes the selection chain
# once per consumer of the two arrays; a recomputation that contracts
# its multiply-adds differently can flip a near-tie `<` and take hi
# from one seed and lo from another, a "chimera" seed that exists
# nowhere (~1.6% of bunny@64 voxels closer than possible on XLA:CPU; an
# optimization barrier on the mask did not stop it). The integer metric
# is exact under any recomputation (it fits int32 for N <= 16384, since
# 3 * (N - 1)^2 < 2^31), and the reference's float32 world distance is
# computed once, from the final seeds, in the output pass, where no
# selection remains. Eager torch computes each mask once, but the port
# keeps voxtpu's integer selection so that both give the same seeds.

_MASK16 = 0xFFFF
_D2I_SENTINEL = 2**31 - 1  # int32 "+inf" of the no-seed state
# Bytes a step's z-chunk may take for its temporaries (`jfa_wide`'s
# default budget), and the bytes of them a voxel of the chunk needs:
# the candidate's distance and one field (int32 each), its no-seed and
# better masks (bool each), the chunk's best distance (int32).
WIDE_BUDGET = 2 << 30
_WIDE_TEMP_BYTES = 16


def jfa_init_seed_wide(occ: torch.Tensor, z0: int = 0):
    """The wide flood state (hi, lo), int32 each: hi = (z << 16) | y and
    lo = x at boundary voxels, hi = -1 and lo = 0 elsewhere. `z0`
    offsets z (a sharded Z-slab stores global z)."""
    zz, yy, xx = _int_coords(tuple(occ.shape), z0, device=occ.device)
    boundary = _boundary_mask(occ)
    hi = torch.where(boundary, (zz << 16) | yy, torch.full((), _NO_SEED, dtype=torch.int32,
                                                          device=occ.device))
    lo = torch.where(boundary, xx, torch.zeros((), dtype=torch.int32, device=occ.device))
    return hi, lo


def _seed_d2_wide(hi: torch.Tensor, lo: torch.Tensor, org: torch.Tensor, px, py,
                  pz) -> torch.Tensor:
    """Squared world distance voxel -> wide seed, float32, +inf where
    hi < 0 (`jfa.py:162-173`, term for term); `org` = (ox, oy, oz,
    voxel_size). The output pass only, never selection."""
    ox, oy, oz, vs = org[0], org[1], org[2], org[3]
    dx = px - (ox + lo.to(torch.float32) * vs)
    dy = py - (oy + (hi & _MASK16).to(torch.float32) * vs)
    dz = pz - (oz + ((hi >> 16) & 0x7FFF).to(torch.float32) * vs)
    d2 = dx * dx + dy * dy + dz * dz
    return torch.where(hi < 0, torch.full_like(d2, float("inf")), d2)


def _int_coords(shape: tuple, z0: int = 0, *, device):
    """Integer voxel coordinates as broadcast int32 aranges: zz (n0, 1,
    1) offset by `z0`, yy (1, n1, 1), xx (1, 1, n2) (voxtpu's three full
    iotas would take 12 N^3 bytes)."""
    n0, n1, n2 = shape
    ar = lambda m: torch.arange(m, dtype=torch.int32, device=device)  # noqa: E731
    return (ar(n0).add_(z0).view(n0, 1, 1), ar(n1).view(1, n1, 1),
            ar(n2).view(1, 1, n2))


def _seed_d2i_wide(hi: torch.Tensor, lo: torch.Tensor, zz, yy, xx) -> torch.Tensor:
    """Exact integer voxel-space squared distance (the selection metric),
    `_D2I_SENTINEL` where hi < 0. A sentinel's fields are garbage and
    their arithmetic may wrap; the fill discards it. Two int32
    temporaries of the result's size, the rest in place."""
    d2 = xx - lo
    d2.mul_(d2)
    t = hi & _MASK16
    torch.sub(yy, t, out=t)
    d2.add_(t.mul_(t))
    torch.bitwise_right_shift(hi, 16, out=t)
    torch.sub(zz, t.bitwise_and_(0x7FFF), out=t)
    d2.add_(t.mul_(t))
    return d2.masked_fill_(hi < 0, _D2I_SENTINEL)


def _flood_step_seed_wide(hi: torch.Tensor, lo: torch.Tensor, k: int, n: int, zz, yy,
                          xx, *, chunk: int | None = None):
    """One JFA pass over the wide (hi, lo) state (`jfa.py:195-218`):
    voxtpu's candidate order and strict `<`, the exact integer metric
    (`_seed_d2i_wide`). Returns a new pair; (zz, yy, xx) are
    `_int_coords` of the grid.

    No padded copy: for each offset only the box of voxels whose
    neighbour lies inside the grid is compared (outside it the
    neighbour is voxtpu's padding, the sentinel, whose metric
    `_D2I_SENTINEL` never wins under `<`). The pass runs over z-chunks
    of `chunk` planes (all n by default), writing each chunk's result
    straight into the new pair, so that its temporaries (about
    `_WIDE_TEMP_BYTES` a voxel) scale with a chunk."""
    chunk = n if chunk is None else chunk
    if chunk < 1:
        raise ValueError(f"chunk={chunk} must be positive")
    new_hi, new_lo = torch.empty_like(hi), torch.empty_like(lo)
    for z0 in range(0, n, chunk):
        z1 = min(z0 + chunk, n)
        bhi, blo = new_hi[z0:z1], new_lo[z0:z1]
        bhi.copy_(hi[z0:z1])
        blo.copy_(lo[z0:z1])
        best = _seed_d2i_wide(bhi, blo, zz[z0:z1], yy, xx)
        for dz, dy, dx in _OFFSETS:
            oz, oy, ox = dz * k, dy * k, dx * k
            za, zb = max(z0, -oz), min(z1, n - oz)
            ya, yb = max(0, -oy), min(n, n - oy)
            xa, xb = max(0, -ox), min(n, n - ox)
            if za >= zb or ya >= yb or xa >= xb:
                continue
            src = (slice(za + oz, zb + oz), slice(ya + oy, yb + oy), slice(xa + ox, xb + ox))
            box = (slice(za - z0, zb - z0), slice(ya, yb), slice(xa, xb))
            nhi, nlo, bbest = hi[src], lo[src], best[box]
            d2 = _seed_d2i_wide(nhi, nlo, zz[za:zb], yy[:, ya:yb], xx[..., xa:xb])
            better = d2 < bbest
            torch.where(better, nhi, bhi[box], out=bhi[box])
            torch.where(better, nlo, blo[box], out=blo[box])
            torch.minimum(bbest, d2, out=bbest)  # where(better, d2, best)
            del d2, better
    return new_hi, new_lo


def _wide_chunk(n: int, budget: int) -> int:
    """Planes a z-chunk of a wide step or output pass takes within
    `budget` bytes of temporaries (at least one)."""
    return max(1, min(n, budget // (_WIDE_TEMP_BYTES * n * n)))


def _use_stepped_xla(n: int, encoding: str) -> bool:
    """Above 1024 the wide encoding is mandatory (`jfa.py:435-438`):
    where voxtpu steps its XLA flood one dispatch a stride, the port's
    ``"cuda"`` route takes the wide torch flood (`jfa_wide`)."""
    return n > _MAX_PACKED_N and encoding in ("auto", "wide")


def seed_encoding(n: int, encoding: str = "auto", *, backend: str = "plain") -> str:
    """The seed encoding that `jfa` floods an N^3 grid with on `backend`
    (``"plain"`` or ``"cuda"``), checked as voxtpu's `jfa_xla` checks it
    (`jfa.py:260-272`): ``"auto"`` is packed up to N = 1024 and wide
    above. The ``"cuda"`` route runs the packed kernels up to 1024 and
    the wide flood above (voxtpu's `jfa_pallas` routing), so it refuses
    ``"wide"`` at N <= 1024, which only ``"plain"`` honours."""
    resolved = encoding
    if encoding == "auto":
        resolved = "packed" if n <= _MAX_PACKED_N else "wide"
    if resolved not in ("packed", "wide"):
        # A typo falling through to the packed branch would silently
        # corrupt seeds at n > 1024 (10-bit field collisions).
        raise ValueError(f"unknown encoding {encoding!r}; use 'packed', 'wide' or 'auto'")
    if resolved == "packed" and n > _MAX_PACKED_N:
        raise ValueError("packed seeds are 10-bit fields (N <= 1024); "
                         "use encoding='wide' or 'auto'")
    if n > _MAX_WIDE_N:
        raise ValueError("wide seeds compare exact int32 voxel distances (N <= 16384)")
    if backend == "cuda":
        if resolved == "wide" and not _use_stepped_xla(n, encoding):
            raise ValueError(f"backend 'cuda' floods N <= {_MAX_PACKED_N} on the packed "
                             "kernels; encoding='wide' there needs backend='plain'")
    elif backend != "plain":
        raise ValueError(f"seed encodings apply to backends 'plain' and 'cuda', "
                         f"not {backend!r}")
    return resolved


def jfa_wide(occ: torch.Tensor, spec: GridSpec, *, budget: int = WIDE_BUDGET) -> torch.Tensor:
    """Signed squared distance field through the wide encoding, torch ops
    on `occ`'s device (the wide half of voxtpu's `jfa_xla_stepped`,
    `jfa.py:397-432`): seed init, one `_flood_step_seed_wide` a stride
    k = N/2 ... 1, then the output pass, sign(occ) * `_seed_d2_wide`.

    Steps and the output pass run in z-chunks whose temporaries take
    about `budget` bytes. Each step writes a new pair beside the old one,
    which is freed when the step returns, so the peak is about 17 N^3
    bytes (two pairs and `occ`) plus a chunk's temporaries. Nothing is
    retried elsewhere: a device out of memory raises."""
    n = spec.n
    if tuple(occ.shape) != (n, n, n) or occ.dtype != torch.bool:
        raise ValueError(f"occupancy {tuple(occ.shape)} {occ.dtype} is not a bool "
                         f"grid of N={n}")
    if n > _MAX_WIDE_N:
        raise ValueError("wide seeds compare exact int32 voxel distances (N <= 16384)")
    from voxtpu_torch.ops.jfa_cuda import org_tensor

    chunk = _wide_chunk(n, budget)
    with span("jfa.seed_init", device=occ.device):
        hi, lo = jfa_init_seed_wide(occ)
    with span("jfa.flood", device=occ.device):
        zz, yy, xx = _int_coords((n, n, n), device=occ.device)
        k = n // 2
        while k >= 1:
            hi, lo = _flood_step_seed_wide(hi, lo, k, n, zz, yy, xx, chunk=chunk)
            k //= 2
        return _sdf_from_seed_wide(hi, lo, occ, org_tensor(spec, occ.device), chunk=chunk)


def _sdf_from_seed_wide(hi: torch.Tensor, lo: torch.Tensor, occ: torch.Tensor,
                        org: torch.Tensor, *, chunk: int, z0: int = 0) -> torch.Tensor:
    """`jfa_wide`'s output pass, in z-chunks of `chunk` planes: sign(occ)
    * `_seed_d2_wide`, float32 of `occ`'s shape, +1 where occupied, -1
    elsewhere (`_final_wide_jit`, `jfa.py:304-307`). `occ` is (planes,
    n, n), the grid's planes from `z0` on (a sharded Z-slab's)."""
    from voxtpu_torch.ops.jfa_cuda import _corners

    planes, n = occ.shape[0], occ.shape[1]
    px, py, pz = _corners(n, org)
    one = torch.ones((), dtype=torch.float32, device=occ.device)
    out = torch.empty(tuple(occ.shape), dtype=torch.float32, device=occ.device)
    for c0 in range(0, planes, chunk):
        c1 = min(c0 + chunk, planes)
        d2 = _seed_d2_wide(hi[c0:c1], lo[c0:c1], org, px, py, pz[z0 + c0:z0 + c1])
        torch.mul(torch.where(occ[c0:c1], one, -one), d2, out=out[c0:c1])
    return out


def jfa(grid: VoxelGrid | torch.Tensor, spec: GridSpec | None = None,
        backend: str = "cuda", pipe: bool | None = None,
        encoding: str = "auto") -> torch.Tensor:
    """Signed squared distance field of an occupancy grid, on the grid's
    device. Accepts a packed VoxelGrid or a dense bool tensor (+ spec).

    `encoding` (``"auto"``, ``"packed"`` or ``"wide"``) is the seed
    layout of the ``"plain"`` and ``"cuda"`` floods (`seed_encoding`:
    ``"cuda"`` takes the packed kernels up to N = 1024 and the wide
    flood above, and refuses an encoding it cannot honour); the oracle
    and the native flood have no seed choice and take ``"auto"`` only.
    `pipe` (``"cuda"`` only) takes voxtpu's pipelined flood step B6
    where it applies (`ops/jfa_cuda.py`); None reads `JFA_PIPE` there,
    as voxtpu's `jfa_pallas` does."""
    if pipe and backend != "cuda":
        raise ValueError(f"pipe=True needs backend 'cuda', not {backend!r}")
    if isinstance(grid, VoxelGrid):
        with span("jfa.unpack", device=grid.words.device):
            occ = grid.to_dense()
        spec = grid.spec() if spec is None else spec
    else:
        occ = grid.bool()
        if spec is None:
            raise ValueError("spec required for dense input")
    if backend in ("reference", "native"):
        if encoding != "auto":
            raise ValueError(f"backend {backend!r} has no seed encoding; got {encoding!r}")
        if backend == "native":
            from voxtpu_torch.native import native_jfa as host_jfa
        else:
            from voxtpu_torch.ops.reference import jfa_ref as host_jfa

        return torch.from_numpy(host_jfa(occ.cpu().numpy(), spec)).to(occ.device)
    if backend == "cuda":
        from voxtpu_torch.ops.jfa_cuda import jfa_cuda

        return jfa_cuda(occ, spec, pipe=pipe, encoding=encoding)
    if backend == "plain":
        from voxtpu_torch.ops.jfa_cuda import jfa_plain

        return jfa_plain(occ, spec, encoding=encoding)
    raise ValueError(f"unknown backend {backend!r} (expected one of {BACKENDS})")
