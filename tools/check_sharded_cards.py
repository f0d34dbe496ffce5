#!/usr/bin/env python3
"""voxtpu_torch.parallel on the cards of one host over NCCL, one rank a card.

    python3 tools/check_sharded_cards.py            # from the repository root, 4 cards
    python3 tools/check_sharded_cards.py --worlds 1 2 --wide-n 0   # 2 cards, no wide part
    python3 tools/check_sharded_cards.py --backend gloo --wide-n 0  # one card: every
                                           # rank on it, collectives staged through the host

Every rank is a process with its own card, which `init_distributed`
picks (the rank modulo the host's cards; nothing passes a card).

1. Worlds 1, 2 and 4 on NCCL through `chip_smoke.py`'s phase 6b rank
   body and checks (`chip_smoke.run_worlds`, `check_world`): phase 4's
   two washers (1,348,128 faces each) and phase 6's torus, target and
   start at 512^3. `voxelize_sharded` on (1, W), (W, 1) and (2, 2),
   ring and gather, xor popcount 0 against the single-card banded
   grids; `jfa_sharded` on (1, W) and (2, 2), packed and wide, bitwise
   the single-card fields; the cuda (B13), fused (B7/B8) and seg
   (B9-B11) sharded fits on (1, W) and (2, 2), 3 steps: the first loss
   the single-device engine's (world 1's), the gradient within 1e-3 x
   max|g| of world 1's, the coordinates bitwise equal on every rank, the
   loss falling; the plain engine and the d axis at 128^3. Under NCCL
   also: each rank on its own card, `collectives.staged_bytes() == 0`
   on every rank, every counted kernel launched on every rank.
2. voxtpu's `dryrun_multichip(4)` (`python -m voxtpu_torch.parallel.
   dryrun 4`): its line.
3. The SDF no single card holds, on (1, 4) (`--wide-ranks`): the two
   washers' union through `voxelize_sharded` (ring) and
   `jfa_sharded(encoding="wide")`. First at CALIBRATE_N, where the peak
   a rank is measured against the reckoning (`step_peak`); then at
   CHECK_N = 1024, where the field, gathered on rank 0, must be bitwise
   the single-card `jfa_wide` of the gathered grid; then at `--wide-n`
   (2048 by default): a rank's reckoned peak (`sharded_wide_peak`, at
   the larger of STEP_BYTES and the calibration's bytes a slab voxel)
   must fit every rank's free memory, or the run fails and prints the
   largest N that would have fitted. The field is checked in place, a
   slab a rank (`check_slab`: `tools/check_jfa_wide.py`'s checks: signs,
   the zero set against the boundary mask, whose planes across a slab's
   faces come from its neighbours, and 1024 samples against the brute
   force over every rank's boundary seeds, the least distance
   all-reduced).

Prints every card's name and power limit first, and a summary last:
fit-step walls per engine and world, the JFA's time a step with the
bytes a rank sent and the rate over the step's wall, `voxelize_sharded`
walls, peaks a rank, the wide flood's N, wall and peak. Host-clock
times end in `torch.cuda.synchronize()` and a barrier on every rank.
Exits non-zero if any check fails.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import pickle
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from voxtpu_torch.ops.jfa import _WIDE_TEMP_BYTES, WIDE_BUDGET  # noqa: E402
from voxtpu_torch.parallel.sharded_jfa import _wide_chunk  # noqa: E402

WIDE_RANKS = 4
CALIBRATE_N = 512
CHECK_N = 1024   # the sharded wide field against the single-card jfa_wide
WIDE_N = 2048
# A slab voxel's bytes at a wide step's peak (`sharded_jfa._wide_step`),
# beside its chunk's temporaries: occ 1; the (hi, lo) pair 8; the new
# pair 8; the received halos (k <= slab / 2) or the one fetched slab 8;
# the running best distance 4. `sharded_jfa.WIDE_SLAB_BYTES`.
STEP_BYTES = 29
HEADROOM = 4 << 30  # the CUDA context, NCCL's buffers, the allocator's rounding


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


smoke = _load("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))


def step_peak(n: int, dz: int, per_voxel: float = STEP_BYTES) -> float:
    """Reckoned peak bytes a rank of a wide step at N^3 over a z axis of
    `dz` ranks holds beyond the CUDA context: `per_voxel` a slab voxel
    and a chunk's temporaries (`_WIDE_TEMP_BYTES` a voxel of a chunk of
    `sharded_jfa._wide_chunk` planes at the default budget)."""
    slab = n // dz
    return per_voxel * slab * n * n + _WIDE_TEMP_BYTES * _wide_chunk(n, slab, WIDE_BUDGET) * n * n


def sharded_wide_peak(n: int, dz: int, per_voxel: float = STEP_BYTES) -> float:
    """`step_peak` and the headroom: what a rank must have free."""
    return step_peak(n, dz, per_voxel) + HEADROOM


def largest_wide_n(free: int, dz: int, per_voxel: float) -> int:
    """The largest multiple of 32 and of `dz`, at most WIDE_N, whose
    reckoned peak fits `free` bytes (0 if none does)."""
    best, n = 0, 32
    while n <= WIDE_N:
        if n % dz == 0 and sharded_wide_peak(n, dz, per_voxel) <= free:
            best = n
        n += 32
    return best


def _wide_flood(rank, dz, dmesh, meshes, n):
    """This rank's occupancy slab of the two washers' union at n
    (voxelize_sharded, ring) and its wide field slab; (occ, sdf, spec,
    flood wall s, peak bytes of the flood beyond occ)."""
    import numpy as np

    from voxtpu_torch.grids.voxel_grid import GridSpec, unpack_bits
    from voxtpu_torch.parallel.sharded_jfa import jfa_sharded
    from voxtpu_torch.parallel.sharded_vox import voxelize_sharded

    spec = GridSpec.fit(np.concatenate([m.coords for m in meshes]), n)
    t0 = time.perf_counter()
    words = None
    for m in meshes:
        w = voxelize_sharded(m, spec, dmesh).words
        words = w if words is None else words | w
    occ = unpack_bits(words)
    del words, w
    smoke.barrier(dz)
    vox_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sdf = jfa_sharded(occ, spec, dmesh, encoding="wide")
    smoke.barrier(dz)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    smoke.world_log(rank, dz, f"{n}^3: voxelize_sharded (two washers) {vox_s:.2f} s; "
                    f"jfa_sharded wide {wall:.2f} s, peak {peak / 2**30:.3f} GiB beyond occ "
                    f"(reckoned {step_peak(n, dz) / 2**30:.3f} GiB: {STEP_BYTES} bytes a slab "
                    "voxel and a chunk)")
    return occ, sdf, spec, wall, peak


def check_slab(checker, sdf, occ, spec, group, z: int, dz: int, *, samples: int = 1024,
               seed: int = 0) -> dict:
    """`tools/check_jfa_wide.py`'s checks of a wide field, each rank on
    its own Z slab: the boundary mask from the slab and its neighbours'
    facing planes (empty past the grid), signs and the zero set counted
    on the slab, the samples' |sdf| taken by the rank whose slab holds
    them, and the brute force's least distance over every rank's seeds
    (each rank's own minimum, all-reduced). Every rank gets the verdict;
    raises the checker's failure."""
    import torch.distributed as dist

    from voxtpu_torch.ops.jfa import _boundary_mask
    from voxtpu_torch.ops.jfa_cuda import org_tensor
    from voxtpu_torch.parallel import collectives as C
    from voxtpu_torch.parallel.sharded_jfa import _halos

    n, slab, dev = spec.n, occ.shape[0], occ.device
    below, above = _halos(occ.to(torch.uint8), 1, group, z, dz)
    empty = torch.zeros((1, n, n), dtype=torch.uint8, device=dev)
    ext = torch.cat([empty if below is None else below, occ.to(torch.uint8),
                     empty if above is None else above]).bool()
    # The mask over the extended planes; the ends are planes past the
    # grid (z = -1, n: out of grid, empty) or a neighbour's own plane,
    # whose mask is not this slab's to count.
    boundary = _boundary_mask(ext)[1:-1]
    del ext
    bad_sign, zero_off = checker.sign_zero_counts(sdf, occ, boundary)
    seeds = torch.nonzero(boundary)
    del boundary
    seeds[:, 0] += z * slab
    pick = checker.sample_voxels(n, samples, seed).to(dev)
    org = org_tensor(spec, dev)
    brute = C.all_reduce(checker.brute_min(pick, seeds, org), group, op=dist.ReduceOp.MIN)
    mine = (pick[:, 0] >= z * slab) & (pick[:, 0] < (z + 1) * slab)
    local = pick[:, 0].clamp(z * slab, (z + 1) * slab - 1) - z * slab
    got = torch.where(mine, sdf[local, pick[:, 1], pick[:, 2]].abs(),
                      torch.zeros((), device=dev))
    got = C.all_reduce(got, group)  # each sample lies in one rank's slab
    counts = C.all_reduce(torch.tensor([bad_sign, zero_off, seeds.shape[0]], device=dev,
                                       dtype=torch.int64), group)
    return checker.judge(int(counts[2]), int(counts[0]), int(counts[1]), got, brute)


def wide_rank(rank: int, dz: int, n_req: int, directory: str) -> int:
    """A rank of part 3: calibrate at CALIBRATE_N; at CHECK_N the field
    against the single-card jfa_wide on rank 0; at n_req, if its
    reckoned peak fits every rank, the flood and its slab checks."""
    import torch.distributed as dist

    from voxtpu_torch.ops.jfa import jfa_wide
    from voxtpu_torch.parallel import collectives as C
    from voxtpu_torch.parallel.distributed import (global_mesh, init_distributed,
                                                   shutdown_distributed)

    init_distributed(f"file://{directory}/rendezvous", dz, rank)
    dev = torch.device("cuda", torch.cuda.current_device())
    checker = _load("check_jfa_wide", os.path.join(ROOT, "tools", "check_jfa_wide.py"))
    try:
        dmesh = global_mesh(("d", "z"), (1, dz))
        group = dmesh.get_group("z")
        meshes = smoke.washer_meshes()
        res = {}
        # Calibration: the bytes a slab voxel took beyond a chunk's temporaries.
        occ, sdf, _, _, peak = _wide_flood(rank, dz, dmesh, meshes, CALIBRATE_N)
        del occ, sdf
        temps = step_peak(CALIBRATE_N, dz, 0)
        measured = torch.tensor([(peak - temps) / (CALIBRATE_N ** 3 / dz)], device=dev)
        measured = float(C.all_reduce(measured, group, op=dist.ReduceOp.MAX))
        res["measured"] = measured

        occ, sdf, spec, wall, _ = _wide_flood(rank, dz, dmesh, meshes, CHECK_N)
        slab = CHECK_N // dz
        full = full_occ = None
        if rank == 0:
            full = torch.empty((CHECK_N,) * 3, dtype=torch.float32, device=dev)
            full_occ = torch.empty((CHECK_N,) * 3, dtype=torch.bool, device=dev)
        for src, dst in ((sdf, full), (occ, full_occ)):
            parts = None if rank else [dst[r * slab:(r + 1) * slab] for r in range(dz)]
            dist.gather(src, parts, dst=0)
        del occ, sdf
        res["check_wall"] = wall
        if rank == 0:
            single = jfa_wide(full_occ, spec)
            res["bitwise"] = torch.equal(single.view(torch.int32), full.view(torch.int32))
            smoke.world_log(rank, dz, f"{CHECK_N}^3: the sharded wide field against the "
                            f"single-card jfa_wide: bitwise {res['bitwise']}")
            del single
        del full, full_occ
        torch.cuda.empty_cache()
        smoke.barrier(dz)

        free = torch.tensor([float(torch.cuda.mem_get_info(dev)[0])], device=dev)
        free = float(C.all_reduce(free, group, op=dist.ReduceOp.MIN))
        per_voxel = max(STEP_BYTES, measured)
        need = sharded_wide_peak(n_req, dz, per_voxel)
        fits = largest_wide_n(int(free), dz, per_voxel)
        res.update(n=n_req, free=free, need=need, fits=fits)
        smoke.world_log(rank, dz, f"measured {measured:.2f} bytes a slab voxel at "
                        f"{CALIBRATE_N}^3 beyond a chunk (reckoned {STEP_BYTES}); {n_req}^3 "
                        f"needs {need / 2**30:.2f} GiB a rank, {free / 2**30:.2f} GiB free; "
                        f"the largest N that fits: {fits}")
        if need <= free:
            occ, sdf, spec, wall, peak = _wide_flood(rank, dz, dmesh, meshes, n_req)
            res.update(wall=wall, peak=peak)
            t0 = time.perf_counter()
            try:
                res["checks"] = check_slab(checker, sdf, occ, spec, group,
                                           dmesh.get_local_rank("z"), dz)
            except checker.CheckFailed as e:
                res["failed"] = str(e)
            res["check_s"] = time.perf_counter() - t0
            smoke.world_log(rank, dz, f"{n_req}^3 field, checked a slab a rank: "
                            f"{res.get('checks', res.get('failed'))} "
                            f"({res['check_s']:.1f} s)")
            del occ, sdf
        res["peak_all"] = torch.cuda.max_memory_allocated()
        smoke.barrier(dz)
        with open(os.path.join(directory, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        shutdown_distributed()
    return 0


def warm(walls) -> str:
    """Steps 2.. of a fit (step 1 holds one-time set-up)."""
    return ", ".join(f"{w:.3f}" for w in walls[1:]) if len(walls) > 1 else "-"


def summary(results, card_lines) -> None:
    print("\n=== summary (" + "; ".join(card_lines) + ") ===")
    for world, res in results.items():
        r0 = res[0]
        fits = [k for k in r0 if isinstance(k, str) and k.split("@")[0] in
                ("cuda", "fused", "seg")]
        for key in fits:
            print(f"world {world} fit {key} at {smoke.MAIN_N}^3: step walls "
                  + ", ".join(f"{w:.3f}" for w in r0[key]["walls"]) + f" s (warm "
                  f"{warm(r0[key]['walls'])}); peak a rank "
                  + ", ".join(f"{r[key]['peak']:.2f}" for r in res) + " GiB")
        for key, val in r0.items():
            if isinstance(key, tuple) and key[0] == "jfa":
                line = (f"world {world} jfa_sharded {key[2]} on {key[1]}: {val['wall']:.3f} s; "
                        f"peak a rank " + ", ".join(f"{r[key]['peak']:.2f}" for r in res)
                        + " GiB")
                if "steps" in val:
                    line += "; steps " + ", ".join(
                        f"k={k} {t * 1e3:.1f} ms" + (f" (sends {b / 1e9:.3f} GB, alone "
                                                    f"{x * 1e3:.2f} ms, {b / x / 1e9:.1f} GB/s)"
                                                    if b else "")
                        for k, t, b, x in val["steps"])
                print(line)
            elif isinstance(key, tuple) and key[0] == "vox":
                print(f"world {world} voxelize_sharded washer {key[1]} on {key[2]} {key[3]}: "
                      f"{val['wall']:.3f} s; peak a rank "
                      + ", ".join(f"{r[key]['peak']:.2f}" for r in res) + " GiB")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--worlds", type=int, nargs="*", default=[1, 2, 4])
    p.add_argument("--backend", default="nccl", choices=("nccl", "gloo"),
                   help="gloo puts every rank of parts 1 and 2 on card 0 (one-card runs)")
    p.add_argument("--wide-n", type=int, default=WIDE_N,
                   help=f"N of part 3's flood (0 skips part 3; default {WIDE_N})")
    p.add_argument("--wide-ranks", type=int, default=WIDE_RANKS,
                   help="ranks (cards) of part 3, its z axis (default 4)")
    p.add_argument("--wide-rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--dir", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.wide_rank is not None:
        return wide_rank(args.wide_rank, args.wide_ranks, args.wide_n, args.dir)
    if not torch.cuda.is_available():
        print("check_sharded_cards: no CUDA device is available", file=sys.stderr)
        return 2
    cards = torch.cuda.device_count()
    dz = args.wide_ranks
    need = max(([1] if args.backend == "gloo" else args.worlds)
               + ([dz] if args.wide_n != 0 else []))
    card_lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    for line in card_lines:
        print(line)
    if cards < need:
        print(f"check_sharded_cards: needs {need} cards, this host has {cards}",
              file=sys.stderr)
        return 2
    from voxtpu_torch import _build

    built = _build.build()
    _build.library()
    print(f"built the kernels in {built.seconds:.2f} s", flush=True)
    from voxtpu_torch.grids.voxel_grid import pack_bits

    t_all = time.perf_counter()
    try:
        dev = torch.device("cuda", 0)
        washers = smoke.washer_meshes()
        mesh, spec_t, start, target, _ = smoke.torus_case(dev)
        fit_case = {"coords": mesh.coords, "faces": mesh.faces, "start": start,
                    "spec": (spec_t.n, spec_t.origin, spec_t.voxel_size),
                    "target": pack_bits(target.bool()).cpu().numpy()}
        del target
        spec, want = smoke.sharded_references(dev, washers)
        torch.cuda.empty_cache()
        worlds = [(w, "nccl" if w == 1 else args.backend, 900)
                  for w in sorted(set([1] + args.worlds))]
        with tempfile.TemporaryDirectory(prefix="voxtpu_torch_cards_") as tmp:
            results = smoke.run_worlds(worlds, washers, spec, want, fit_case, tmp,
                                       steps1=smoke.SHARDED_STEPS)
        if 4 in args.worlds and args.backend == "nccl":
            smoke.dryrun_on_card(4)
        wide = None
        if args.wide_n != 0:
            with tempfile.TemporaryDirectory(prefix="voxtpu_torch_wide_") as tmp:
                wdir = os.path.join(tmp, "wide")
                script = os.path.abspath(__file__)
                wide = smoke.run_world(
                    dz, "nccl", wdir, 1500,
                    argv=lambda r: [sys.executable, script, "--wide-rank", str(r),
                                    "--wide-ranks", str(dz), "--wide-n", str(args.wide_n),
                                    "--dir", wdir])
    except smoke.SmokeFailure as e:
        print(f"check_sharded_cards: FAILED: {e}", file=sys.stderr)
        return 1
    summary(results, card_lines)
    if wide is not None:
        w0, n = wide[0], args.wide_n
        print(f"wide flood on (1, {dz}): {CALIBRATE_N}^3 measured {w0['measured']:.2f} bytes a "
              f"slab voxel beyond a chunk (reckoned {STEP_BYTES}); {CHECK_N}^3 "
              f"{w0['check_wall']:.2f} s, bitwise the single-card jfa_wide: {w0['bitwise']}")
        if not w0["bitwise"]:
            print(f"check_sharded_cards: FAILED: the sharded wide field at {CHECK_N}^3 differs "
                  "from the single-card jfa_wide", file=sys.stderr)
            return 1
        if w0["need"] > w0["free"]:
            print(f"check_sharded_cards: FAILED: {n}^3 needs {w0['need'] / 2**30:.2f} GiB a "
                  f"rank, {w0['free'] / 2**30:.2f} GiB free; the largest N that fits is "
                  f"{w0['fits']}", file=sys.stderr)
            return 1
        print(f"wide flood on (1, {dz}) at {n}^3: wall {w0['wall']:.2f} s, peak a rank "
              + ", ".join(f"{r['peak'] / 2**30:.2f}" for r in wide)
              + f" GiB beyond occ (reckoned {step_peak(n, dz) / 2**30:.2f}; whole run "
              + ", ".join(f"{r['peak_all'] / 2**30:.2f}" for r in wide)
              + f" GiB); checks a slab a rank: {w0.get('checks', w0.get('failed'))}")
        if "failed" in w0:
            print(f"check_sharded_cards: FAILED: {w0['failed']}", file=sys.stderr)
            return 1
    print(f"check_sharded_cards: every check passed in {time.perf_counter() - t_all:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
