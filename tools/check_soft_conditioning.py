#!/usr/bin/env python3
"""How far rounding moves the soft engines' coordinate gradients.

    python3 tools/check_soft_conditioning.py                # on the card
    python3 tools/check_soft_conditioning.py --device cpu --n 256

A torus (48 x 24 segments, 2,304 faces) turned off every axis, its hard
grid at n the target, the start half a voxel off along x plus 0.1 voxel
of seeded jitter (phase 6's pattern at a smaller size), soft plan pad 2,
VoxelFit's temperatures (0.5, 0.5). For each engine (plain, cuda, fused,
seg) it prints how far the coordinate gradient of soft_iou_loss moves
when the loss is scaled by 1 + 1e-6 (a linear map: exact arithmetic
would move it by 1e-6 of itself), as a share of max|g|. It also
evaluates both formulas in float64, the fused one (seg's too) through
its plain versions (tables, occupancy cotangent, table cotangents), the
plain one (cuda's too) on float64 coordinates, and prints each float32
gradient's distance from its formula's. Kernels run on CUDA tensors,
their plain versions on CPU ones.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SCALE = 1e-6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import numpy as np
    import torch

    from voxtpu_torch.grids.voxel_grid import GridSpec
    from voxtpu_torch.mesh import procedural
    from voxtpu_torch.mesh.mesh import Mesh
    from voxtpu_torch.models.fit import soft_iou_loss
    from voxtpu_torch.ops import soft_vox_fused as F
    from voxtpu_torch.ops.soft_vox import clip01, make_soft_plan, soft_voxelize
    from voxtpu_torch.ops.soft_vox_cuda import SoftCudaPlan, soft_voxelize_cuda
    from voxtpu_torch.ops.soft_vox_seg import SegSoftPlan, soft_voxelize_seg
    from voxtpu_torch.ops.vox import voxelize

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("check_soft_conditioning: no CUDA device (pass --device cpu)", file=sys.stderr)
        return 2
    n = args.n
    c, f = procedural.torus(1.0, 0.35, 48, 24)
    ax, ay, az = 0.3, 0.5, 0.7
    rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)], [0, np.sin(ax), np.cos(ax)]])
    ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0], [-np.sin(ay), 0, np.cos(ay)]])
    rz = np.array([[np.cos(az), -np.sin(az), 0], [np.sin(az), np.cos(az), 0], [0, 0, 1]])
    c = (c.astype(np.float64) @ (rz @ ry @ rx).T).astype(np.float32)
    spec = GridSpec.fit(c, n)
    vs = spec.voxel_size
    start = (c + np.float32([0.5 * vs, 0.0, 0.0])
             + np.random.default_rng(0).normal(0, 0.1 * vs, c.shape)).astype(np.float32)
    target = voxelize(Mesh(name="torus", coords=c, faces=f, faces_normals=f), spec,
                      "plain", device=dev).to_dense().float()
    plan = make_soft_plan(Mesh(name="start", coords=start, faces=f, faces_normals=f), spec,
                          pad_window=2)
    tau = dict(tau_edge_frac=0.5, tau_x_frac=0.5)
    fused = F.FusedSoftPlan(plan, dev)
    engines = {
        "plain": lambda x: soft_voxelize(x, plan, **tau),
        "cuda": lambda x: soft_voxelize_cuda(x, SoftCudaPlan(plan, dev), **tau),
        "fused": lambda x: F.soft_voxelize_fused(x, fused, **tau),
    }
    if n >= 256 and n % 128 == 0:
        engines["seg"] = lambda x: soft_voxelize_seg(x, SegSoftPlan(plan, start, dev), **tau)

    def grad(fwd, factor):
        x = torch.from_numpy(start).to(dev).requires_grad_(True)
        (soft_iou_loss(fwd(x), target) * factor).backward()
        return x.grad.double()

    print(f"torus {len(f)} faces at n={n} on {dev}; loss scaled by 1 + {SCALE:g}")
    grads = {}
    for name, fwd in engines.items():
        g1, g2 = grad(fwd, 1.0), grad(fwd, 1.0 + SCALE)
        top = float(g1.abs().max())
        moved = float((g2 / (1.0 + SCALE) - g1).abs().max())
        grads[name] = g1
        print(f"{name}: max|g| {top:.6g}; moved {moved / top:.3e} x max|g|")

    # The fused formula in float64: tables, B7's and B8's plain versions.
    prm = fused.prm(0.5, 0.5)
    x = torch.from_numpy(start).to(dev).double().requires_grad_(True)
    tables = F.tables_of(x, fused)
    occ = F.fused_fwd_plain(tables.detach(), fused.cells_d, fused.tblidx_d,
                            fused.batch_tile_d, n=n, tc=fused.tc, prm=prm).double()
    leaf = occ.requires_grad_(True)
    soft_iou_loss(clip01(leaf), target.double()).backward()
    dtab = F.fused_bwd_plain(tables.detach(), fused.cells_d, fused.tblidx_d,
                             fused.batch_tile_d, leaf.grad.contiguous(), n=n, tc=fused.tc,
                             prm=prm)
    tables.backward(dtab)
    fused64 = x.grad
    # The plain engine on float64 coordinates (its occupancy rounds to
    # float32 once, its backward runs in float64).
    x = torch.from_numpy(start).to(dev).double().requires_grad_(True)
    soft_iou_loss(soft_voxelize(x, plan, **tau), target).backward()
    plain64 = x.grad
    top = float(plain64.abs().max())
    print(f"float64: the fused formula {float((fused64 - plain64).abs().max()) / top:.3e} x "
          f"max|g| from the plain one")
    for name, g in grads.items():
        ref = plain64 if name in ("plain", "cuda") else fused64
        print(f"{name} (float32) against its formula in float64: "
              f"{float((g - ref).abs().max()) / top:.3e} x max|g|")
    return 0


if __name__ == "__main__":
    sys.exit(main())
