"""Flood-step probe P1: variants of one flood step (B3) that split its
cost into candidate reads and arithmetic.

Port of the kernel of voxtpu's `scripts/probe_jfa_micro.py` (`_kernel`,
`_step`); its runner is `tools/probe_jfa_micro.py`. `flood_probe(seed,
org, k, variant)` launches `csrc/jfa_probe.cu::vt_flood_probe` (for
``"legacy"``, B3's own `vt_flood_step`) on a CUDA tensor and the
variant's plain torch version on a CPU tensor. The plain versions
follow voxtpu's kernel form (lane and sublane rolls, masks); the z
plane of a candidate is voxtpu's block index map, z + dz*k clamped into
the grid:

- ``"legacy"``: B3 (`flood_step_plain`).
- ``"hoist"``: B3 with the lane roll of each plane taken once per dx
  and reused across dy; the same fold, so bitwise B3.
- ``"hoistv"``: hoist with validity folded into one +inf select on d2;
  bitwise B3.
- ``"rolls"``: the data movement alone: the integer min of the own seed
  and the 26 candidates, rolled around the plane in x and y, no masks.
- ``"alu"``: the arithmetic alone: 26 distance folds over the clamped
  plane's seed at the voxel's own (y, x) XOR i, i = 1..26 in candidate
  order (the XOR keeps the folds from collapsing), strict `<`.
"""

from __future__ import annotations

import torch

from voxtpu_torch import _build
from voxtpu_torch.ops.jfa import _OFFSETS
from voxtpu_torch.ops.jfa_cuda import _check_seed, _corners, _seed_d2, flood_step_plain

VARIANTS = ("legacy", "hoist", "hoistv", "rolls", "alu")


def _planes(seed: torch.Tensor, k: int) -> dict:
    """dz -> the grid of planes clamp(z + dz*k) (voxtpu's block index
    map `jnp.clip(z + dz * k, 0, n - 1)`)."""
    n = seed.shape[0]
    z = torch.arange(n, device=seed.device)
    return {dz: seed[(z + dz * k).clamp(0, n - 1)] for dz in (-1, 0, 1)}


def _in_grid(n: int, d: int, device) -> torch.Tensor:
    idx = torch.arange(n, device=device) + d
    return (idx >= 0) & (idx < n)


def _fold(best, best_d2, cand, d2):
    better = d2 < best_d2
    return torch.where(better, cand, best), torch.where(better, d2, best_d2)


def _hoist_plain(seed, org, k, fold_validity: bool):
    n, dev = seed.shape[0], seed.device
    px, py, pz = _corners(n, org)
    planes = _planes(seed, k)
    inf = torch.full((), float("inf"), device=dev)
    best = planes[0]
    best_d2 = _seed_d2(best, org, px, py, pz)
    for dz in (-1, 0, 1):
        zok = _in_grid(n, dz * k, dev).view(n, 1, 1)
        rx = {dx: torch.roll(planes[dz], -dx * k, dims=2) if dx else planes[dz]
              for dx in (-1, 0, 1)}
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dz == 0 and dy == 0 and dx == 0:
                    continue
                cand = torch.roll(rx[dx], -dy * k, dims=1) if dy else rx[dx]
                valid = (zok & _in_grid(n, dy * k, dev).view(1, n, 1)
                         & _in_grid(n, dx * k, dev).view(1, 1, n))
                if fold_validity:
                    d2 = torch.where(valid & (cand >= 0), _seed_d2(cand, org, px, py, pz),
                                     inf)
                else:
                    cand = torch.where(valid, cand, -1)
                    d2 = _seed_d2(cand, org, px, py, pz)
                best, best_d2 = _fold(best, best_d2, cand, d2)
    return best


def _rolls_plain(seed, org, k):
    planes = _planes(seed, k)
    best = planes[0]
    for dz, dy, dx in _OFFSETS:
        best = torch.minimum(best, torch.roll(planes[dz], (-dy * k, -dx * k), dims=(1, 2)))
    return best


def _alu_plain(seed, org, k):
    px, py, pz = _corners(seed.shape[0], org)
    planes = _planes(seed, k)
    best = planes[0]
    best_d2 = _seed_d2(best, org, px, py, pz)
    for i, (dz, _, _) in enumerate(_OFFSETS, 1):
        cand = planes[dz] ^ i
        best, best_d2 = _fold(best, best_d2, cand, _seed_d2(cand, org, px, py, pz))
    return best


PLAIN = {
    "legacy": flood_step_plain,
    "hoist": lambda seed, org, k: _hoist_plain(seed, org, k, False),
    "hoistv": lambda seed, org, k: _hoist_plain(seed, org, k, True),
    "rolls": _rolls_plain,
    "alu": _alu_plain,
}


def flood_probe_plain(seed: torch.Tensor, org: torch.Tensor, k: int,
                      variant: str) -> torch.Tensor:
    """Plain torch version of P1's `variant` (any device)."""
    return PLAIN[variant](seed, org, k)


def flood_probe(seed: torch.Tensor, org: torch.Tensor, k: int,
                variant: str) -> torch.Tensor:
    """P1: one flood step's `variant` (`VARIANTS`) at stride k over a
    packed (n, n, n) int32 seed grid; `org` = (ox, oy, oz, voxel_size)
    float32. Returns a new grid.

    Replaces scripts/probe_jfa_micro.py::_kernel. A CPU tensor takes the
    plain version, a CUDA tensor launches the kernel."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (expected one of {VARIANTS})")
    n = _check_seed(seed, org)
    if not 1 <= k < max(n, 2):
        raise ValueError(f"stride k={k} outside [1, {n})")
    if not _build.on_cuda(seed, org):
        return flood_probe_plain(seed, org, k, variant)
    out = torch.empty_like(seed)
    if variant == "legacy":
        _build.launch("vt_flood_step", seed.data_ptr(), out.data_ptr(), org.data_ptr(), n,
                      k, _build.stream_of(out))
    else:
        _build.launch("vt_flood_probe", seed.data_ptr(), out.data_ptr(), org.data_ptr(), n,
                      k, VARIANTS.index(variant), _build.stream_of(out))
    flood_probe.launches += 1
    return out


flood_probe.launches = 0
