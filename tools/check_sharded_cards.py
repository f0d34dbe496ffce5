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
3. The SDF no single card holds: on (1, 4) (`--wide-ranks`)
   `voxelize_sharded` of the two
   washers and `jfa_sharded(encoding="wide")` of their union at the
   largest N (a multiple of 32, at most 2048) whose reckoned peak a
   rank (`sharded_wide_peak`, checked first against the peak measured
   at 512^3) fits every rank's free memory; the field is gathered on
   rank 0 and must pass `tools/check_jfa_wide.py::check_wide_field`
   (signs, zero set, 1024 samples against brute force).

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

WIDE_RANKS = 4
CALIBRATE_N = 512
MAX_WIDE_N = 2048
# A slab voxel's peak bytes in one wide step of `sharded_jfa._step_local`
# (k = slab / 2, the widest halos), from the code: occ 1; the state
# (hi, lo) 8; the halo-extended copies 16; the best distance 4; a
# candidate pair 8; its distance 4 (with `_seed_d2i_wide`'s int32
# temporary and mask, 5 more, gone before the compare); the better mask
# 1; the new state 8 while the old one lives. 50 a voxel.
STEP_BYTES = 50
HEADROOM = 4 << 30  # the CUDA context, NCCL's buffers, the allocator's rounding


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


smoke = _load("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))


def sharded_wide_peak(n: int, dz: int, per_voxel: float = STEP_BYTES) -> float:
    """Reckoned peak bytes a rank of the wide sharded flood at N^3 over
    a z axis of `dz` ranks."""
    return per_voxel * n ** 3 / dz + HEADROOM


def largest_wide_n(free: int, dz: int, per_voxel: float) -> int:
    """The largest multiple of 32 (and of `dz`), at most MAX_WIDE_N,
    whose reckoned peak fits `free` bytes."""
    n = 32 * dz
    while n + 32 <= MAX_WIDE_N and sharded_wide_peak(n + 32, dz, per_voxel) <= free:
        n += 32
    return n - n % dz


def _wide_flood(rank, dz, dmesh, meshes, n):
    """This rank's occupancy slab of the two washers' union at n
    (voxelize_sharded, ring) and its wide field slab; (occ, sdf, spec,
    flood wall s, peak bytes of the flood)."""
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
                    f"({peak / (n ** 3 / dz):.2f} bytes a slab voxel; reckoned "
                    f"{sharded_wide_peak(n, dz) / 2**30:.3f} GiB with the headroom)")
    return occ, sdf, spec, wall, peak


def wide_rank(rank: int, dz: int, n_req: int, directory: str) -> int:
    """A rank of part 3: calibrate at CALIBRATE_N, pick N, flood, gather
    the field on rank 0, which checks it."""
    import torch.distributed as dist

    from voxtpu_torch.parallel import collectives as C
    from voxtpu_torch.parallel.distributed import (global_mesh, init_distributed,
                                                   shutdown_distributed)

    init_distributed(f"file://{directory}/rendezvous", dz, rank)
    dev = torch.device("cuda", torch.cuda.current_device())
    checker = _load("check_jfa_wide", os.path.join(ROOT, "tools", "check_jfa_wide.py"))
    try:
        dmesh = global_mesh(("d", "z"), (1, dz))
        meshes = smoke.washer_meshes()
        occ, sdf, _, _, peak = _wide_flood(rank, dz, dmesh, meshes, CALIBRATE_N)
        del occ, sdf
        torch.cuda.empty_cache()
        measured = torch.tensor([peak / (CALIBRATE_N ** 3 / dz)], device=dev)
        free = torch.tensor([float(torch.cuda.mem_get_info(dev)[0])], device=dev)
        measured = C.all_reduce(measured, dist.group.WORLD, op=dist.ReduceOp.MAX)
        free = C.all_reduce(free, dist.group.WORLD, op=dist.ReduceOp.MIN)
        per_voxel = max(STEP_BYTES, float(measured))
        n = n_req or largest_wide_n(int(free) - 2 * 2**30, dz, per_voxel)
        need = sharded_wide_peak(MAX_WIDE_N, dz, per_voxel)
        smoke.world_log(rank, dz, f"measured {float(measured):.2f} bytes a slab voxel "
                        f"at {CALIBRATE_N}^3 (reckoned {STEP_BYTES}); {MAX_WIDE_N}^3 needs "
                        f"{need / 2**30:.1f} GiB a rank, {float(free) / 2**30:.1f} GiB free: "
                        f"N = {n}")
        occ, sdf, spec, wall, peak = _wide_flood(rank, dz, dmesh, meshes, n)
        slab = n // dz
        full = full_occ = None
        if rank == 0:
            full = torch.empty((n, n, n), dtype=torch.float32, device=dev)
            full_occ = torch.empty((n, n, n), dtype=torch.bool, device=dev)
        for src, dst in ((sdf, full), (occ, full_occ)):
            parts = None if rank else [dst[r * slab:(r + 1) * slab] for r in range(dz)]
            dist.gather(src, parts, dst=0)
        del occ, sdf
        res = {"n": n, "wall": wall, "peak": peak, "measured": float(measured),
               "free": float(free)}
        if rank == 0:
            t0 = time.perf_counter()
            res["checks"] = checker.check_wide_field(full, full_occ, spec, samples=1024,
                                                     seed=0)
            res["check_s"] = time.perf_counter() - t0
            smoke.world_log(rank, dz, f"{n}^3 field on rank 0: {res['checks']} (checked "
                            f"in {res['check_s']:.1f} s)")
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
    p.add_argument("--wide-n", type=int, default=None,
                   help="N of part 3 (0 skips it; default: the largest that fits)")
    p.add_argument("--wide-ranks", type=int, default=WIDE_RANKS,
                   help="ranks (cards) of part 3, its z axis (default 4)")
    p.add_argument("--wide-rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--dir", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.wide_rank is not None:
        return wide_rank(args.wide_rank, args.wide_ranks, args.wide_n or 0, args.dir)
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
                                    "--wide-ranks", str(dz), "--wide-n", str(args.wide_n or 0),
                                    "--dir", wdir])
    except smoke.SmokeFailure as e:
        print(f"check_sharded_cards: FAILED: {e}", file=sys.stderr)
        return 1
    summary(results, card_lines)
    if wide is not None:
        w0 = wide[0]
        print(f"wide flood on (1, {dz}) at {w0['n']}^3: wall {w0['wall']:.2f} s, peak a "
              "rank " + ", ".join(f"{r['peak'] / 2**30:.2f}" for r in wide)
              + f" GiB beyond occ; measured {w0['measured']:.2f} bytes a slab voxel at "
              f"{CALIBRATE_N}^3; check_wide_field {w0['checks']}")
    print(f"check_sharded_cards: every check passed in {time.perf_counter() - t_all:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
