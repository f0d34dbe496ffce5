#!/usr/bin/env python3
"""voxtpu_torch's wide (hi, lo) JFA above the packed limit, on one CUDA card.

    python3 tools/check_jfa_wide.py              # from the repository root
    python3 tools/check_jfa_wide.py 1280 1536    # chosen sizes (and no largest N)

Grids: `tools/check_jfa_1024.py`'s thick spherical shell plus a rod
along z, scaled to each N, on a non-dyadic grid of the same extent.

1. N = 1024: the wide flood (`jfa(backend="plain", encoding="wide")` on
   CUDA tensors) against the packed kernels' field (`jfa(backend=
   "cuda")`, B4 and B5): on the non-dyadic grid its largest relative
   difference and the share of voxels beyond rtol 1e-5 are printed;
   on a dyadic grid of the same shapes, where every float distance is
   exact and orders seeds as the integer metric does, the two must be
   bitwise equal. Both fields pass `check_wide_field`.
2. N = 1280, 1536 and the largest multiple of 32 whose reckoned peak,
   `wide_peak`, fits the card's free memory: `jfa(backend="cuda")` must
   take the wide flood (no launch of B3-B6); its wall time and peak
   device memory are printed, and the field must pass
   `check_wide_field`. Then the same flood, driven piece by piece (seed
   init, each step, the output pass; CUDA events), gives the time of
   each step and must give the same field (int32 checksum).

`check_wide_field` (also run by `chip_smoke.py`'s phase 4d): signs
follow occupancy, sdf == 0 exactly on the boundary mask and nowhere
else, and on 1024 seeded sample voxels |sdf| is never below the
brute-force minimum over all boundary seeds (same float formula, term
for term), and exceeds it by more than rtol 1e-5 at under 1% of them
(voxtpu's `tests/test_jfa.py:93-101`).

Prints the card's name and power limit first. Exits non-zero if a
check fails; a device out of memory is raised, not caught.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from voxtpu_torch.grids.voxel_grid import GridSpec  # noqa: E402
from voxtpu_torch.ops import jfa as W  # noqa: E402
from voxtpu_torch.ops import jfa_cuda  # noqa: E402
from voxtpu_torch.ops.jfa import jfa  # noqa: E402

SIZES = (1280, 1536)
EXTENT = 1024 * 0.0031     # check_jfa_1024.py's grid: 1024 voxels of 0.0031
ORIGIN = (0.1, -0.23, 0.37)
DYADIC = dict(origin=(0.5, -2.0, 1.25), voxel_size=2.0 ** -9)
SAMPLES = 1024
RTOL = 1e-5
ABOVE_MAX = 0.01           # share of samples above the brute force by > RTOL
SLAB = 64                  # planes a chunk of the whole-grid checks
SEED_CHUNK = 1 << 18       # seeds a chunk of the brute force (1 GiB a temporary)


class CheckFailed(Exception):
    """A check of this tool failed."""


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def shell_and_rod(n: int, dev) -> torch.Tensor:
    """check_jfa_1024.py's shapes at N: a shell of radii 0.2 N and 0.3 N
    about the centre, and a rod along z of radius 40/1024 N at x =
    100/1024 N, y = 900/1024 N."""
    idx = torch.arange(n, device=dev, dtype=torch.float32)
    z, y, x = idx.view(n, 1, 1), idx.view(1, n, 1), idx.view(1, 1, n)
    c = (n - 1) / 2
    r2 = (z - c) ** 2 + (y - c) ** 2 + (x - c) ** 2
    occ = (r2 <= (0.3 * n) ** 2) & ~(r2 <= (0.2 * n) ** 2)
    s = n / 1024
    occ |= (x - 100 * s) ** 2 + (y - 900 * s) ** 2 <= (40 * s) ** 2
    return occ


def wide_peak(n: int) -> int:
    """Reckoned peak bytes of the wide flood: two (hi, lo) pairs and occ
    (17 N^3), plus twice the chunk budget (the output pass's float
    temporaries take more a voxel than a step's)."""
    return 17 * n ** 3 + 2 * W.WIDE_BUDGET


def largest_n(free: int) -> int:
    n = 32
    while wide_peak(n + 32) <= free:
        n += 32
    return n


def _world(idx: torch.Tensor, org: torch.Tensor) -> torch.Tensor:
    """Voxel corners origin + idx * voxel_size, float32, (m, 3) xyz from
    (m, 3) zyx indices: the JFA's own float formula."""
    f = idx.flip(1).to(torch.float32)
    return org[:3] + f * org[3]


def sign_zero_counts(sdf: torch.Tensor, occ: torch.Tensor, boundary: torch.Tensor):
    """(voxels whose sign does not follow occ, voxels where sdf == 0 and
    the boundary mask differ), over planes of a grid or a slab, SLAB
    planes at a time."""
    bad_sign = zero_off = 0
    for z0 in range(0, sdf.shape[0], SLAB):
        s, o, b = sdf[z0:z0 + SLAB], occ[z0:z0 + SLAB], boundary[z0:z0 + SLAB]
        bad_sign += int(((s < 0) & o).sum()) + int(((s >= 0) & ~o).sum())
        zero_off += int(((s == 0) != b).sum())
    return bad_sign, zero_off


def sample_voxels(n: int, samples: int, seed: int) -> torch.Tensor:
    """The (samples, 3) zyx voxels the brute force checks, seeded (on the
    host, so every rank of a sharded check draws the same)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, n, (samples, 3), generator=g)


def brute_min(pick: torch.Tensor, seeds: torch.Tensor, org: torch.Tensor) -> torch.Tensor:
    """Per sample voxel (zyx, (m, 3)), the least squared world distance to
    `seeds` (zyx, (s, 3)): the JFA's float formula, SEED_CHUNK seeds at a
    time; +inf without a seed."""
    pw, sw = _world(pick, org), _world(seeds, org)
    brute = torch.full((pick.shape[0],), float("inf"), device=org.device)
    for i in range(0, sw.shape[0], SEED_CHUNK):
        part = sw[i:i + SEED_CHUNK]
        dx = pw[:, None, 0] - part[None, :, 0]
        dy = pw[:, None, 1] - part[None, :, 1]
        dz = pw[:, None, 2] - part[None, :, 2]
        brute = torch.minimum(brute, (dx * dx + dy * dy + dz * dz).min(dim=1).values)
        del dx, dy, dz
    return brute


def judge(seeds: int, bad_sign: int, zero_off: int, got: torch.Tensor,
          brute: torch.Tensor) -> dict:
    """The checks' verdict from their counts and the samples' |sdf| (`got`)
    beside the brute force; raises CheckFailed naming the first failure."""
    below = int((got < brute).sum())
    above = float((got > brute * (1 + RTOL)).float().mean())
    out = dict(seeds=seeds, bad_sign=bad_sign, zero_off=zero_off, below=below,
               above_share=above, finite_share=float(torch.isfinite(got).float().mean()))
    require(bad_sign == 0, f"{bad_sign} voxels with the wrong sign")
    require(zero_off == 0, f"sdf == 0 differs from the boundary mask at {zero_off} voxels")
    require(below == 0, f"{below} samples below the brute-force nearest seed")
    require(above < ABOVE_MAX, f"{above:.4f} of the samples above brute force by > {RTOL}")
    return out


def check_wide_field(sdf: torch.Tensor, occ: torch.Tensor, spec: GridSpec, *,
                     samples: int = SAMPLES, seed: int = 0) -> dict:
    """Checks of a JFA field against its grid (see the module docstring).
    Returns the counts; raises CheckFailed naming the first failure."""
    n, dev = spec.n, sdf.device
    boundary = W._boundary_mask(occ)
    bad_sign, zero_off = sign_zero_counts(sdf, occ, boundary)
    seeds = torch.nonzero(boundary)
    del boundary
    pick = sample_voxels(n, samples, seed).to(dev)
    brute = brute_min(pick, seeds, jfa_cuda.org_tensor(spec, dev))
    got = sdf[pick[:, 0], pick[:, 1], pick[:, 2]].abs()
    return judge(seeds.shape[0], bad_sign, zero_off, got, brute)


def _launches() -> dict:
    return {name: getattr(jfa_cuda, fn).launches for name, fn in (
        ("B3", "flood_step"), ("B4", "flood_step_rows"), ("B5", "sdf_from_seed"),
        ("B6", "flood_step_pipe"))}


def _checksum(sdf: torch.Tensor) -> int:
    return int(sdf.view(torch.int32).to(torch.int64).sum())


def _event() -> torch.cuda.Event:
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def stepped(occ: torch.Tensor, spec: GridSpec) -> tuple:
    """`jfa_wide`'s flood driven piece by piece: (field, init ms, step ms
    by stride, output pass ms)."""
    n = spec.n
    chunk = W._wide_chunk(n, W.WIDE_BUDGET)
    t0 = _event()
    hi, lo = W.jfa_init_seed_wide(occ)
    coords = W._int_coords((n, n, n), device=occ.device)
    marks, k = [(None, _event())], n // 2
    while k >= 1:
        hi, lo = W._flood_step_seed_wide(hi, lo, k, n, *coords, chunk=chunk)
        marks.append((k, _event()))
        k //= 2
    sdf = W._sdf_from_seed_wide(hi, lo, occ, jfa_cuda.org_tensor(spec, occ.device),
                                chunk=chunk)
    end = _event()
    end.synchronize()
    steps = {k: a.elapsed_time(b) for (_, a), (k, b) in zip(marks, marks[1:])}
    return sdf, t0.elapsed_time(marks[0][1]), steps, marks[-1][1].elapsed_time(end)


def at_1024(dev) -> None:
    n = 1024
    occ = shell_and_rod(n, dev)
    for name, spec in (("non-dyadic", GridSpec(n=n, origin=ORIGIN, voxel_size=EXTENT / n)),
                       ("dyadic", GridSpec(n=n, **DYADIC))):
        before = _launches()
        packed = jfa(occ, spec, backend="cuda")
        b4 = _launches()["B4"] - before["B4"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wide = jfa(occ, spec, backend="plain", encoding="wide")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rel = ((wide - packed).abs() / packed.abs()).nan_to_num(0.0)  # inf - inf: equal
        beyond = float((rel > RTOL).float().mean())
        bitwise = torch.equal(wide.view(torch.int32), packed.view(torch.int32))
        print(f"1024^3 {name}: wide flood {wall:.3f} s; packed (B4 x {b4}, B5) against "
              f"wide: bitwise {bitwise}, largest relative difference "
              f"{float(rel.max()):.3e}, share beyond rtol {RTOL}: {beyond:.3e}", flush=True)
        del rel
        require(name != "dyadic" or bitwise,
                "on dyadic geometry the wide field must equal the packed one")
        for label, field in (("packed", packed), ("wide", wide)):
            print(f"  {label}: {check_wide_field(field, occ, spec)}", flush=True)
        del packed, wide
        torch.cuda.empty_cache()


def at_size(n: int, dev) -> None:
    spec = GridSpec(n=n, origin=ORIGIN, voxel_size=EXTENT / n)
    occ = shell_and_rod(n, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = _launches()
    t0 = time.perf_counter()
    sdf = jfa(occ, spec, backend="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    steps = n.bit_length() - 1  # strides n/2, n/4, ..., 1
    require(_launches() == before, f"jfa at {n}^3 launched a packed kernel")
    print(f"{n}^3: jfa(backend='cuda') took the wide flood: {wall:.3f} s, {steps} steps, "
          f"peak {peak / 2**30:.3f} GiB beyond occ (reckoned {wide_peak(n) / 2**30:.3f} "
          f"GiB, occ {occ.numel() / 2**30:.3f} GiB)", flush=True)
    print(f"  {check_wide_field(sdf, occ, spec)}", flush=True)
    want = _checksum(sdf)
    del sdf
    torch.cuda.empty_cache()
    got, init_ms, step_ms, out_ms = stepped(occ, spec)
    same = _checksum(got) == want
    del got
    torch.cuda.empty_cache()
    print(f"  piece by piece: init {init_ms:.1f} ms, steps (k: ms) "
          + ", ".join(f"{k}: {ms:.1f}" for k, ms in step_ms.items())
          + f", output pass {out_ms:.1f} ms; mean step "
          f"{sum(step_ms.values()) / len(step_ms):.1f} ms; same field {same}", flush=True)
    require(same, f"the stepped flood differs from jfa at {n}^3")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("check_jfa_wide: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    free, total = torch.cuda.mem_get_info(dev)
    sizes = [int(a) for a in argv] or [*SIZES, largest_n(free)]
    print(f"free {free / 2**30:.3f} of {total / 2**30:.3f} GiB; largest N whose "
          f"reckoned peak fits: {largest_n(free)}; sizes {sizes}", flush=True)
    try:
        if not argv:
            at_1024(dev)
        for n in sizes:
            at_size(n, dev)
            torch.cuda.empty_cache()
    except CheckFailed as e:
        print(f"FAIL: {e}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
