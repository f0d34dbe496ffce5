"""Differentiable voxelization demo: recover perturbed vertices.

Port of `examples/fit_vertices.py`. Voxelizes a target mesh (hard
parity grid), perturbs its vertices, then descends the soft-IoU loss of
the soft voxelization back toward the target. Without ``--mesh`` the
target is a procedural icosphere.

    python -m voxtpu_torch.examples.fit_vertices [--mesh m.obj] [--n 64]
        [--steps 100] [--noise 0.02] [--lr 5e-3]
        [--engine auto|plain|cuda|fused|seg] [--device cuda|cpu] [--out f.obj]

Prints the hard-occupancy IoU against the target before and after. The
run is on the card unless ``--device cpu`` asks for the CPU; without a
card it exits with a message that says so.
"""

from __future__ import annotations

import argparse
import sys


def run_device(ap, args):
    """The run's torch device, ``--device`` (default cuda). Without a
    CUDA device, cuda is refused through `ap.error`, never replaced by
    the CPU. On a card the target and the IoU come from the packed
    voxelizer (B1/B2), which needs N % 32 == 0; only the CPU has the
    NumPy oracle for other N."""
    import torch

    device = torch.device(args.device)
    if args.n % 32 and device.type != "cpu":
        ap.error(f"--n {args.n} on {device}: the packed voxelizer needs a multiple "
                 "of 32 (any --n runs with --device cpu)")
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error(f"--device {args.device}: no CUDA device is available "
                 "(--device cpu runs the plain torch versions)")
    return device


def hard_occupancy(mesh, spec, device):
    """(n, n, n) bool occupancy: the banded voxelizer (B1/B2 on a card)
    where N % 32 == 0; otherwise the NumPy oracle, on the CPU only."""
    import torch

    from voxtpu_torch.ops.reference import voxelize_ref
    from voxtpu_torch.ops.vox import voxelize

    if spec.n % 32 == 0:
        return voxelize(mesh, spec, "cuda", device=device).to_dense()
    if torch.device(device).type != "cpu":
        raise ValueError(f"N = {spec.n} on {device}: the packed voxelizer needs "
                         "N % 32 == 0")
    return torch.from_numpy(voxelize_ref(mesh, spec))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default=None,
                    help="target .obj (default: a procedural icosphere)")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--noise", type=float, default=0.02)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "plain", "cuda", "fused", "seg"],
                    help="soft-voxelization engine (auto: seg on a card for "
                         "256 <= --n <= 512, fused for other --n, plain on the "
                         "CPU; seg needs --n >= 256 and a multiple of 128)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; exits when there is no "
                         "card) or cpu; on cuda --n must be a multiple of 32")
    ap.add_argument("--out", default=None, help="export the fitted mesh .obj")
    args = ap.parse_args(argv)
    if args.engine == "seg" and (args.n < 256 or args.n % 128):
        ap.error(f"--engine seg needs --n >= 256 and a multiple of 128 "
                 f"(got {args.n})")

    import numpy as np
    import torch

    from voxtpu_torch import GridSpec, export_mesh, import_mesh
    from voxtpu_torch.mesh import procedural
    from voxtpu_torch.mesh.mesh import Mesh
    from voxtpu_torch.models.fit import VoxelFit
    from voxtpu_torch.ops.soft_vox import make_soft_plan

    device = run_device(ap, args)
    if args.mesh:
        mesh = import_mesh(args.mesh)
    else:
        coords, faces = procedural.icosphere(3)
        mesh = Mesh(name="icosphere", coords=coords, faces=faces,
                    faces_normals=faces)
    spec = GridSpec.fit(mesh.coords, args.n)
    target_occ = hard_occupancy(mesh, spec, device)

    rng = np.random.default_rng(0)
    scale = float(np.ptp(mesh.coords, axis=0).max())
    noisy = mesh.coords + rng.normal(
        0, args.noise * scale, mesh.coords.shape).astype(np.float32)

    def with_coords(coords, name):
        return Mesh(name=name, coords=np.asarray(coords, np.float32),
                    faces=mesh.faces, faces_normals=mesh.faces_normals)

    # Plan windows from the noisy geometry so the raster stays covered.
    plan = make_soft_plan(with_coords(noisy, "noisy"), spec, pad_window=2)
    fit = VoxelFit(plan, target_occ.float(), learning_rate=args.lr,
                   engine=args.engine)
    state = fit.init(noisy)
    with torch.no_grad():
        l0 = float(fit.loss(state.coords))
    metrics = {"loss": torch.tensor(l0)}
    for i in range(args.steps):
        state, metrics = fit.step(state)
        if (i + 1) % max(1, args.steps // 10) == 0:
            print(f"step {i + 1:4d}  loss={float(metrics['loss']):.4f}  "
                  f"|grad|={float(metrics['grad_norm']):.4f}", flush=True)

    # Success metric: hard-occupancy IoU of the fitted mesh against the
    # target (vertices may slide along the surface without changing the
    # volume the loss optimizes, so vertex error means little).
    def hard_iou(coords):
        occ = hard_occupancy(with_coords(coords, "m"), spec, device)
        return float((occ & target_occ).sum()) / max(float((occ | target_occ).sum()), 1.0)

    fitted = state.coords.cpu().numpy()
    print(f"engine {fit.engine} on {device}; soft-IoU loss: {l0:.4f} -> "
          f"{float(metrics['loss']):.4f}")
    iou0, iou1 = hard_iou(noisy), hard_iou(fitted)
    print(f"hard occupancy IoU vs target: {iou0:.4f} -> {iou1:.4f} "
          f"({'improved' if iou1 > iou0 else 'NOT improved'})")
    if args.out:
        export_mesh(args.out, Mesh(name="fitted", coords=fitted, faces=mesh.faces,
                                   faces_normals=mesh.faces_normals,
                                   normals=mesh.normals, colors=mesh.colors))
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
