"""Gradients through CSG booleans: fit several part meshes at once.

Port of `examples/csg_fit_parts.py`. Both parts' vertices are perturbed,
then descended together against the soft-IoU loss of the soft CSG union
against the hard union of the unperturbed parts. Without ``--mesh-a`` /
``--mesh-b`` the parts are a procedural icosphere and an icosahedron.

    python -m voxtpu_torch.examples.csg_fit_parts [--mesh-a a.obj]
        [--mesh-b b.obj] [--n 48] [--steps 60] [--noise 0.01] [--lr 5e-3]
        [--device cuda|cpu]

Exits 0 when the loss fell.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh-a", default=None,
                    help="first part .obj (default: a procedural icosphere)")
    ap.add_argument("--mesh-b", default=None,
                    help="second part .obj (default: a procedural icosahedron)")
    ap.add_argument("--n", type=int, default=48)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--noise", type=float, default=0.01)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda if available, else cpu); "
                         "on cuda --n must be a multiple of 32")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from voxtpu_torch import GridSpec, import_mesh
    from voxtpu_torch.examples.fit_vertices import hard_occupancy, run_device
    from voxtpu_torch.mesh import procedural
    from voxtpu_torch.mesh.mesh import Mesh
    from voxtpu_torch.models.csg_fit import CSGFit, CSGPart
    from voxtpu_torch.ops.soft_vox import make_soft_plan

    device = run_device(ap, args)

    def load(path, make, name):
        if path:
            return import_mesh(path)
        coords, faces = make()
        return Mesh(name=name, coords=coords, faces=faces, faces_normals=faces)

    meshes = [load(args.mesh_a, lambda: procedural.icosphere(2, 0.8), "sphere"),
              load(args.mesh_b, lambda: procedural.icosahedron(0.8, (0.7, 0.1, 0.2)),
                   "d20")]
    all_coords = np.concatenate([m.coords for m in meshes])
    spec = GridSpec.fit(all_coords, args.n)

    # The hard union of the unperturbed parts is the target.
    target = hard_occupancy(meshes[0], spec, device) | hard_occupancy(
        meshes[1], spec, device)

    rng = np.random.default_rng(0)
    scale = float(np.ptp(all_coords, axis=0).max())
    noisy = [m.coords + rng.normal(0, args.noise * scale, m.coords.shape)
             .astype(np.float32) for m in meshes]
    parts = [
        CSGPart(plan=make_soft_plan(
            Mesh(name=m.name, coords=c, faces=m.faces,
                 faces_normals=m.faces_normals), spec, pad_window=2), op="union")
        for m, c in zip(meshes, noisy)]
    fit = CSGFit(parts, target.float(), learning_rate=args.lr)
    coords_list, opt_state = fit.init(noisy)
    with torch.no_grad():
        l0 = float(fit.loss(coords_list))
    l1 = l0
    for i in range(args.steps):
        coords_list, opt_state, metrics = fit.step(coords_list, opt_state)
        l1 = float(metrics["loss"])
        if (i + 1) % max(1, args.steps // 6) == 0:
            print(f"step {i + 1:4d}  loss={l1:.4f}  refreshes={fit.refresh_count}",
                  flush=True)
    print(f"soft-IoU loss: {l0:.4f} -> {l1:.4f} "
          f"({'improved' if l1 < l0 else 'NOT improved'})")
    return 0 if l1 < l0 else 1


if __name__ == "__main__":
    sys.exit(main())
