"""Sharded JFA: Z slabs with halos exchanged between ranks.

Port of `voxtpu/parallel/sharded_jfa.py` (XLA code in voxtpu, torch ops
here; no kernel). The grid is cut into Z slabs over the mesh's "z"
axis; a flood step at stride k needs the best-seed planes at z +/- k:

- **k < slab**: each rank sends its top k planes up and its bottom k
  planes down (`_halo_exchange`, send/recv within the z group) and runs
  the 26-neighbour step on the slab extended by both halos
  (`_step_local`). 2 k N^2 4 bytes a state array a step.
- **k >= slab**: k and slab are powers of two, so k is a whole number of
  slabs and the z -/+ k planes are the whole slabs of ranks z -/+ k /
  slab (`_fetch_slab`, `_step_strided`). 2 slab N^2 4 bytes a state
  array a step.

The state is the packed int32 seed grid (-1 = no seed) up to N = 1024,
or the wide (hi, lo) pair up to N = 16384 (`ops/jfa.py`), with GLOBAL
seed coordinates, so halos need no re-basing. Selection is the single-
device flood's: each voxel takes the nearest of its own seed and its 26
candidates in voxtpu's order with a strict `<`, by the reference's
float32 world distance for packed (`ops/jfa_cuda.py::_seed_d2`) and by
the exact integer voxel distance for wide (`ops/jfa.py::
_seed_d2i_wide`). Past the grid's ends a halo is the no-seed sentinel,
whose distance never wins.

The packed step (N <= 1024, a slab a card holds whole) builds
halo-extended and shifted copies of the slab. The wide step exists for
grids no card holds, so it takes `ops/jfa.py::_flood_step_seed_wide`'s
form (`_wide_step`): each candidate is read as a box of the slab, of a
received halo or of a fetched slab (a *region*: planes at known local z,
no extended or shifted copy), in z-chunks whose temporaries stay within
a byte `budget`, written straight into the new pair; the running best
distance is one int32 slab. For k >= slab one neighbour slab is held at
a time: rank z - k/slab's for the nine dz = -1 offsets, then rank
z + k/slab's for the nine dz = +1 ones (voxtpu's candidate order runs
dz outermost, so each voxel still sees its candidates in that order).
A slab voxel then needs occ 1 byte, the pair 8, the new pair 8, the
halos or one fetched slab at most 8 and the best 4: `WIDE_SLAB_BYTES`,
29, beside a chunk's temporaries (`WIDE_BUDGET`).
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from voxtpu_torch.grids.voxel_grid import GridSpec
from voxtpu_torch.ops.jfa import (_MAX_PACKED_N, _MAX_WIDE_N, _OFFSETS, WIDE_BUDGET,
                                  _int_coords, _sdf_from_seed_wide, _seed_d2i_wide)
from voxtpu_torch.ops.jfa import _wide_chunk as _grid_chunk
from voxtpu_torch.ops.jfa_cuda import _corners, _seed_d2, _shift_into, org_tensor
from voxtpu_torch.parallel import collectives as C

# Fill past the grid's ends, one a state array.
_FILLS = {"packed": (-1,), "wide": (-1, 0)}
# Bytes a slab voxel of the wide flood holds at a step's peak, beside a
# chunk's temporaries: occ 1, the (hi, lo) pair 8, the new pair 8, the
# halos (k <= slab / 2) or one fetched slab 8, the running best 4.
WIDE_SLAB_BYTES = 29


def check_jfa_sharded(n: int, dz: int, encoding: str = "auto") -> str:
    """The encoding `jfa_sharded` floods an N^3 grid with over a z axis
    of `dz` ranks, with voxtpu's refusals and messages
    (`sharded_jfa.py:220-244`); needs no process group."""
    if encoding == "auto":
        encoding = "packed" if n <= _MAX_PACKED_N else "wide"
    if encoding not in ("packed", "wide"):
        raise ValueError(f"unknown encoding {encoding!r}; "
                         "use 'packed', 'wide' or 'auto'")
    if encoding == "packed" and n > _MAX_PACKED_N:
        raise ValueError("packed seeds are 10-bit fields (N <= 1024); "
                         "use encoding='wide' or 'auto'")
    if n > _MAX_WIDE_N:
        raise ValueError("wide seeds compare exact int32 voxel distances "
                         "(N <= 16384)")
    if n % dz != 0:
        raise ValueError(f"N={n} must divide by z axis {dz}")
    if dz & (dz - 1):
        # The strided exchange fetches the slabs at z -/+ k/slab, exact
        # only when every k >= slab is a whole number of slabs: true iff
        # dz is a power of two. dz = 6 would flood from the wrong planes.
        raise ValueError(f"z-axis device count must be a power of two (got {dz})")
    return encoding


def _halos(arr: torch.Tensor, k: int, group, z: int, dz: int):
    """(k planes from rank z - 1, k planes from rank z + 1), None past
    the grid's ends: the send/recv of one halo exchange."""
    up = z + 1 if z + 1 < dz else None
    down = z - 1 if z > 0 else None
    return (C.permute(arr[-k:], group, up, down),    # rank z - 1's top planes
            C.permute(arr[:k], group, down, up))     # rank z + 1's bottom planes


def _halo_exchange(arr: torch.Tensor, k: int, group, z: int, dz: int, fill) -> torch.Tensor:
    """[k planes from rank z - 1, arr, k planes from rank z + 1] along
    dim 0 (the fill past the grid's ends)."""
    lower, upper = _halos(arr, k, group, z, dz)
    if lower is None:
        lower = torch.full_like(arr[:k], fill)
    if upper is None:
        upper = torch.full_like(arr[:k], fill)
    return torch.cat([lower, arr, upper])


def _fetch_slab(arr: torch.Tensor, shift: int, group, z: int, dz: int, fill) -> torch.Tensor:
    """The whole slab of rank z + shift (the fill past the grid's ends)."""
    dst, src = z - shift, z + shift
    got = C.permute(arr, group, dst if 0 <= dst < dz else None,
                    src if 0 <= src < dz else None)
    return torch.full_like(arr, fill) if got is None else got


def _shifted_yx(a: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[z, y, x] = a[z, y + dy, x + dx], the fill outside the grid."""
    return _shift_into(torch.full_like(a, fill), a, (0, dy, dx))


def _minimize(state, views, sel_fn):
    """The 26-neighbour minimization (`sharded_jfa.py:88-100`):
    `views(dz, dy, dx)` gives a candidate state tuple, `sel_fn` its
    selection distance; strict `<` in voxtpu's candidate order."""
    best = sel_fn(state)
    for dz, dy, dx in _OFFSETS:
        cand = views(dz, dy, dx)
        d2 = sel_fn(cand)
        better = d2 < best
        best = torch.where(better, d2, best)
        state = tuple(torch.where(better, c, s) for c, s in zip(cand, state))
    return state


def _step_local(state, fills, sel_fn, k: int, slab: int, group, z: int, dz: int):
    """One flood step on a Z slab with k-plane halos (k < slab)."""
    ext = [_halo_exchange(s, k, group, z, dz, f) for s, f in zip(state, fills)]

    def views(oz, oy, ox):
        z0 = k + oz * k
        return tuple(_shifted_yx(e[z0:z0 + slab], oy * k, ox * k, f)
                     for e, f in zip(ext, fills))

    return _minimize(state, views, sel_fn)


def _step_strided(state, fills, sel_fn, k: int, slab: int, group, z: int, dz: int):
    """One flood step for k >= slab: the z -/+ k planes are the whole
    slabs of ranks z -/+ k / slab."""
    m = k // slab
    blocks = {oz: state if oz == 0 else
              tuple(_fetch_slab(s, oz * m, group, z, dz, f) for s, f in zip(state, fills))
              for oz in (-1, 0, 1)}

    def views(oz, oy, ox):
        return tuple(_shifted_yx(b, oy * k, ox * k, f) for b, f in zip(blocks[oz], fills))

    return _minimize(state, views, sel_fn)


def comm_bytes_per_step(n: int, dz: int, encoding: str, k: int,
                        gathered: bool = False) -> int:
    """Bytes a rank sends in one flood step (`sharded_jfa.py:152-162`;
    `gathered` gives voxtpu's replaced all-gather of the whole grid)."""
    arrays = len(_FILLS[encoding])
    slab = n // dz
    if k < slab:
        return 2 * k * n * n * 4 * arrays
    if gathered:
        return (dz - 1) * slab * n * n * 4 * arrays
    return 2 * slab * n * n * 4 * arrays


def _init_local(occ: torch.Tensor, n: int, slab: int, group, z: int, dz: int,
                encoding: str):
    """Seeds of a Z slab (boundary voxels: occupied with an empty or
    out-of-grid 26-neighbour, the neighbours across the slab's faces
    taken from a 1-plane halo); state tuple out, GLOBAL z."""
    h = _halo_exchange(occ.to(torch.uint8), 1, group, z, dz, 0)
    hp = torch.zeros((slab + 2, n + 2, n + 2), dtype=torch.bool, device=occ.device)
    hp[:, 1:-1, 1:-1] = h.bool()
    all_n = torch.ones_like(occ)
    for oz, oy, ox in _OFFSETS:
        all_n &= hp[1 + oz:1 + oz + slab, 1 + oy:1 + oy + n, 1 + ox:1 + ox + n]
    boundary = occ & ~all_n
    zz, yy, xx = _int_coords((slab, n, n), z * slab, device=occ.device)
    no_seed = torch.full((), -1, dtype=torch.int32, device=occ.device)
    if encoding == "wide":
        return (torch.where(boundary, (zz << 16) | yy, no_seed),
                torch.where(boundary, xx, torch.zeros_like(no_seed)))
    return (torch.where(boundary, (zz << 20) | (yy << 10) | xx, no_seed),)


def _wide_chunk(n: int, slab: int, budget: int) -> int:
    """Planes of a slab a z-chunk of the wide step or output pass takes
    within `budget` bytes of temporaries (at least one)."""
    return min(slab, _grid_chunk(n, budget))


def _relax(new, best, regions, offsets, k: int, n: int, coords, chunk: int) -> None:
    """Relax the new pair `new` and its distances `best` (an int32 slab)
    against `offsets` at stride k, in z-chunks of `chunk` planes: voxel
    z of the slab takes the candidate at local z + dz k from the region
    (z_start, (hi, lo)) whose planes hold it, as a box (no copy); a
    candidate in no region (past the grid's ends) is the sentinel and is
    skipped, as `ops/jfa.py::_flood_step_seed_wide` skips it."""
    new_hi, new_lo = new
    zz, yy, xx = coords
    slab = best.shape[0]
    for c0 in range(0, slab, chunk):
        c1 = min(c0 + chunk, slab)
        for dz, dy, dx in offsets:
            oz, oy, ox = dz * k, dy * k, dx * k
            ya, yb = max(0, -oy), min(n, n - oy)
            xa, xb = max(0, -ox), min(n, n - ox)
            if ya >= yb or xa >= xb:
                continue
            for r0, (rhi, rlo) in regions:
                za, zb = max(c0, r0 - oz), min(c1, r0 + rhi.shape[0] - oz)
                if za >= zb:
                    continue
                src = (slice(za + oz - r0, zb + oz - r0), slice(ya + oy, yb + oy),
                       slice(xa + ox, xb + ox))
                box = (slice(za, zb), slice(ya, yb), slice(xa, xb))
                nhi, nlo, bbest = rhi[src], rlo[src], best[box]
                d2 = _seed_d2i_wide(nhi, nlo, zz[za:zb], yy[:, ya:yb], xx[..., xa:xb])
                better = d2 < bbest
                torch.where(better, nhi, new_hi[box], out=new_hi[box])
                torch.where(better, nlo, new_lo[box], out=new_lo[box])
                torch.minimum(bbest, d2, out=bbest)  # where(better, d2, best)
                del d2, better


def _wide_step(state, k: int, flood: "SlabFlood"):
    """One wide flood step on a Z slab (see the module docstring):
    returns the new (hi, lo) pair."""
    hi, lo = state
    n, slab, chunk, coords = flood.n, flood.slab, flood.chunk, flood.coords
    group, z, dz = flood.group, flood.z, flood.dz
    new = (torch.empty_like(hi), torch.empty_like(lo))
    best = torch.empty_like(hi)
    for c0 in range(0, slab, chunk):
        c1 = min(c0 + chunk, slab)
        new[0][c0:c1].copy_(hi[c0:c1])
        new[1][c0:c1].copy_(lo[c0:c1])
        best[c0:c1] = _seed_d2i_wide(new[0][c0:c1], new[1][c0:c1], coords[0][c0:c1],
                                     *coords[1:])
    if k < slab:
        (lo_hi, up_hi), (lo_lo, up_lo) = (_halos(a, k, group, z, dz) for a in state)
        regions = [(0, state)]
        if lo_hi is not None:
            regions.insert(0, (-k, (lo_hi, lo_lo)))
        if up_hi is not None:
            regions.append((slab, (up_hi, up_lo)))
        _relax(new, best, regions, _OFFSETS, k, n, coords, chunk)
        return new
    m = k // slab
    for side in (-1, 0, 1):
        offsets = [o for o in _OFFSETS if o[0] == side]
        if side == 0:
            _relax(new, best, [(0, state)], offsets, k, n, coords, chunk)
            continue
        got = [C.permute(a, group, z - side * m if 0 <= z - side * m < dz else None,
                         z + side * m if 0 <= z + side * m < dz else None) for a in state]
        if got[0] is not None:
            _relax(new, best, [(side * k, tuple(got))], offsets, k, n, coords, chunk)
        del got
    return new


class SlabFlood:
    """A rank's flood over its Z slab, in the pieces `jfa_sharded` runs:
    `init(occ)` the seed state, `strides()` the strides k = N/2 ... 1,
    `step(state, k)` one flood step, `output(state, occ)` the signed
    squared distances. Every rank of the z group calls each piece alike
    (the exchanges are collective)."""

    def __init__(self, spec: GridSpec, device_mesh: DeviceMesh, axis_name: str,
                 encoding: str, device, budget: int):
        n = spec.n
        dz = device_mesh.size(device_mesh.mesh_dim_names.index(axis_name))
        self.encoding = check_jfa_sharded(n, dz, encoding)
        self.n, self.dz, self.slab = n, dz, n // dz
        self.group = device_mesh.get_group(axis_name)
        self.z = device_mesh.get_local_rank(axis_name)
        self.fills = _FILLS[self.encoding]
        self.org = org_tensor(spec, device)
        self.coords = _int_coords((self.slab, n, n), self.z * self.slab, device=device)
        self.chunk = _wide_chunk(n, self.slab, budget)

    def strides(self):
        k = self.n // 2
        while k >= 1:
            yield k
            k //= 2

    def init(self, occ: torch.Tensor):
        return _init_local(occ, self.n, self.slab, self.group, self.z, self.dz,
                           self.encoding)

    def step(self, state, k: int):
        if self.encoding == "wide":
            return _wide_step(state, k, self)
        step = _step_local if k < self.slab else _step_strided
        return step(state, self.fills, self._packed_d2, k, self.slab, self.group, self.z,
                    self.dz)

    def _packed_d2(self, st):
        px, py, pz = _corners(self.n, self.org)
        z0 = self.z * self.slab
        return _seed_d2(st[0], self.org, px, py, pz[z0:z0 + self.slab])

    def output(self, state, occ: torch.Tensor) -> torch.Tensor:
        if self.encoding == "wide":
            return _sdf_from_seed_wide(*state, occ, self.org, chunk=self.chunk,
                                       z0=self.z * self.slab)
        one = torch.ones((), dtype=torch.float32, device=occ.device)
        return torch.where(occ, one, -one) * self._packed_d2(state)


def jfa_sharded(occ: torch.Tensor, spec: GridSpec, device_mesh: DeviceMesh,
                axis_name: str = "z", encoding: str = "auto", *,
                budget: int = WIDE_BUDGET) -> torch.Tensor:
    """Z-sharded JFA (`sharded_jfa.py:197-257`): `occ` is this rank's Z
    slab, (n / dz, n, n) bool on its device (or a DTensor of it); returns
    its slab of the signed squared distance field, float32, +d2 where
    occupied and -d2 elsewhere.

    encoding: ``"packed"`` (N <= 1024), ``"wide"`` (N <= 16384, twice the
    state and traffic) or ``"auto"``. The wide step and output pass run
    in z-chunks whose temporaries take about `budget` bytes (as
    `ops/jfa.py::jfa_wide`'s); the peak a rank is then about
    `WIDE_SLAB_BYTES` a slab voxel beside them. Nothing is retried
    elsewhere: a device out of memory raises."""
    if hasattr(occ, "to_local"):
        occ = occ.to_local()
    flood = SlabFlood(spec, device_mesh, axis_name, encoding, occ.device, budget)
    n, slab = spec.n, flood.slab
    if tuple(occ.shape) != (slab, n, n) or occ.dtype != torch.bool:
        raise ValueError(f"occupancy slab {tuple(occ.shape)} {occ.dtype} is not a bool "
                         f"({slab}, {n}, {n}) slab")
    state = flood.init(occ)
    for k in flood.strides():
        state = flood.step(state, k)
    return flood.output(state, occ)
