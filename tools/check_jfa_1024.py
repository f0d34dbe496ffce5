#!/usr/bin/env python3
"""voxtpu_torch's packed-seed JFA at its limit, N = 1024, on one CUDA card.

    python3 tools/check_jfa_1024.py      # from the repository root

A thick spherical shell plus a rod along z on a non-dyadic 1024^3 grid.
At N = 1024 `jfa_cuda` runs B4 (the row-band flood step). At every
stride k this holds B4 against B3 (bitwise) and, at k = 512, 64 and 1,
against B4's band-wise plain version; then B5 against its plain
version, and times each B4 and B3 step (CUDA events; the first
includes the kernel build) and three whole `jfa_cuda` calls, which must
launch B4 and not B3. The band-wise plain version keeps the peak to a
band's temporaries (the whole-grid plain flood needed about 67 GiB).
Exits non-zero if a check fails.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from voxtpu_torch.grids.voxel_grid import GridSpec  # noqa: E402
from voxtpu_torch.ops import jfa_cuda  # noqa: E402
from voxtpu_torch.ops.jfa import jfa_init_seed  # noqa: E402

N = 1024


def main() -> int:
    if not torch.cuda.is_available():
        print("check_jfa_1024: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    spec = GridSpec(n=N, origin=(0.1, -0.23, 0.37), voxel_size=0.0031)
    idx = torch.arange(N, device=dev, dtype=torch.float32)
    z, y, x = idx.view(N, 1, 1), idx.view(1, N, 1), idx.view(1, 1, N)
    c = (N - 1) / 2
    r2 = (z - c) ** 2 + (y - c) ** 2 + (x - c) ** 2
    occ = (r2 <= (0.3 * N) ** 2) & ~(r2 <= (0.2 * N) ** 2)
    occ |= (x - 100) ** 2 + (y - 900) ** 2 <= 40 ** 2
    org = jfa_cuda.org_tensor(spec, dev)
    seed = jfa_init_seed(occ)
    ok = True
    b4_ms, b3_ms = [], []

    def timed(fn, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        end.synchronize()
        return out, round(start.elapsed_time(end), 3)

    k = N // 2
    while k >= 1:
        got, ms = timed(jfa_cuda.flood_step_rows, seed, org, k)
        b4_ms.append(ms)
        want, ms = timed(jfa_cuda.flood_step, seed, org, k)
        b3_ms.append(ms)
        same = torch.equal(got, want)
        if k in (512, 64, 1):
            plain = torch.equal(got, jfa_cuda.flood_step_rows_plain(seed, org, k))
            print(f"k={k}: B4 == B3: {same}, B4 == plain: {plain}")
            same &= plain
        ok &= same
        seed = got
        del want
        k //= 2
    print("B4 step ms (k=512..1):", b4_ms)
    print("B3 step ms (k=512..1):", b3_ms)
    sdf = jfa_cuda.sdf_from_seed(seed, occ, org)
    want = jfa_cuda.sdf_from_seed_plain(seed, occ, org)
    same = torch.equal(sdf.view(torch.int32), want.view(torch.int32))
    print("B5 == plain:", same)
    ok &= same
    del want
    print(f"finite share {float(torch.isfinite(sdf).float().mean())}, "
          f"occupied {int(occ.sum())}")
    b3, b4 = jfa_cuda.flood_step.launches, jfa_cuda.flood_step_rows.launches
    for rep in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        jfa_cuda.jfa_cuda(occ, spec)
        torch.cuda.synchronize()
        print(f"jfa_cuda wall ms, run {rep}: {(time.perf_counter() - t0) * 1e3:.3f}")
    routed = (jfa_cuda.flood_step.launches == b3
              and jfa_cuda.flood_step_rows.launches == b4 + 3 * (N.bit_length() - 1))
    print("jfa_cuda ran B4 at every step and B3 never:", routed)
    ok &= routed
    print(f"peak device memory GiB {torch.cuda.max_memory_allocated() / 2**30:.3f}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
