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
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from voxtpu_torch.grids.voxel_grid import GridSpec
from voxtpu_torch.ops.jfa import (_MAX_PACKED_N, _MAX_WIDE_N, _OFFSETS, _int_coords,
                                  _seed_d2_wide, _seed_d2i_wide)
from voxtpu_torch.ops.jfa_cuda import _corners, _seed_d2, _shift_into, org_tensor
from voxtpu_torch.parallel import collectives as C

# Fill past the grid's ends, one a state array.
_FILLS = {"packed": (-1,), "wide": (-1, 0)}


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


def _metrics(spec: GridSpec, slab: int, z: int, encoding: str, device):
    """(sel_fn, out_fn) of a slab: the selection distance and the output
    pass's squared world distance of a state tuple."""
    n = spec.n
    org = org_tensor(spec, device)
    px, py, pz = _corners(n, org)
    pz = pz[z * slab:(z + 1) * slab]
    if encoding == "wide":
        zz, yy, xx = _int_coords((slab, n, n), z * slab, device=device)
        return (lambda st: _seed_d2i_wide(st[0], st[1], zz, yy, xx),
                lambda st: _seed_d2_wide(st[0], st[1], org, px, py, pz))
    sel = lambda st: _seed_d2(st[0], org, px, py, pz)  # noqa: E731
    return sel, sel


def flood_steps(spec: GridSpec, dz: int):
    """The strides k = N/2 ... 1 with the step each takes."""
    n, slab = spec.n, spec.n // dz
    k = n // 2
    while k >= 1:
        yield k, (_step_local if k < slab else _step_strided)
        k //= 2


def jfa_sharded(occ: torch.Tensor, spec: GridSpec, device_mesh: DeviceMesh,
                axis_name: str = "z", encoding: str = "auto") -> torch.Tensor:
    """Z-sharded JFA (`sharded_jfa.py:197-257`): `occ` is this rank's Z
    slab, (n / dz, n, n) bool on its device (or a DTensor of it); returns
    its slab of the signed squared distance field, float32, +d2 where
    occupied and -d2 elsewhere.

    encoding: ``"packed"`` (N <= 1024), ``"wide"`` (N <= 16384, twice the
    state and traffic) or ``"auto"``."""
    if hasattr(occ, "to_local"):
        occ = occ.to_local()
    n = spec.n
    dz = device_mesh.size(device_mesh.mesh_dim_names.index(axis_name))
    encoding = check_jfa_sharded(n, dz, encoding)
    slab = n // dz
    if tuple(occ.shape) != (slab, n, n) or occ.dtype != torch.bool:
        raise ValueError(f"occupancy slab {tuple(occ.shape)} {occ.dtype} is not a bool "
                         f"({slab}, {n}, {n}) slab")
    group, z = device_mesh.get_group(axis_name), device_mesh.get_local_rank(axis_name)
    fills = _FILLS[encoding]
    sel_fn, out_fn = _metrics(spec, slab, z, encoding, occ.device)
    state = _init_local(occ, n, slab, group, z, dz, encoding)
    for k, step in flood_steps(spec, dz):
        state = step(state, fills, sel_fn, k, slab, group, z, dz)
    one = torch.ones((), dtype=torch.float32, device=occ.device)
    return torch.where(occ, one, -one) * out_fn(state)
