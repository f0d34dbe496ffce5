#!/usr/bin/env python3
"""What torch.distributed offers two ranks that share one CUDA card.

    python3 tools/check_one_card_backends.py

Starts two worlds of two processes each on cuda:0 (a file rendezvous
in a temporary directory, a timeout of its own per world):

- NCCL: one all_reduce of a CUDA tensor. NCCL refuses two ranks on one
  device, so this world is expected to fail; the error each rank read is
  printed.
- gloo: a (1, 2) device mesh of type "cuda" (`init_device_mesh`), then
  reduce_scatter_tensor, all_gather_into_tensor, all_reduce and a
  two-rank ring of batch_isend_irecv, each on host copies of CUDA
  tensors (what `voxtpu_torch.parallel.collectives` stages), checked
  against the sums they must give.

Prints torch's and CUDA's versions and the card's name and power limit;
exits 0 when the gloo world passed.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import traceback


def worker(backend: str, rank: int, init: str) -> None:
    import torch
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=init, world_size=2, rank=rank)
    try:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        x = torch.full((4,), float(rank + 1), device=dev)
        if backend == "nccl":
            dist.all_reduce(x)
            torch.cuda.synchronize()
            print(f"rank {rank}: nccl all_reduce gave {x.tolist()}", flush=True)
            return
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cuda", (1, 2), mesh_dim_names=("d", "z"))
        z = mesh.get_group("z")
        full = torch.arange(8, dtype=torch.float32, device=dev) * (rank + 1)
        out = torch.empty(4)
        dist.reduce_scatter_tensor(out, full.cpu(), group=z)
        want = (torch.arange(8.0) * 3)[4 * rank:4 * rank + 4]
        assert torch.equal(out, want), (out, want)
        gathered = torch.empty(8)
        dist.all_gather_into_tensor(gathered, x.cpu(), group=z)
        assert torch.equal(gathered, torch.tensor([1.0] * 4 + [2.0] * 4)), gathered
        s = x.cpu()
        dist.all_reduce(s, group=z)
        assert torch.equal(s, torch.full((4,), 3.0)), s
        peer = dist.get_global_rank(z, 1 - mesh.get_local_rank("z"))
        got = torch.empty(4)
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x.cpu(), peer, z),
                                       dist.P2POp(dist.irecv, got, peer, z)])
        for r in reqs:
            r.wait()
        assert torch.equal(got, torch.full((4,), float(2 - rank))), got
        print(f"rank {rank}: gloo on a cuda mesh: reduce_scatter_tensor, "
              f"all_gather_into_tensor, all_reduce, batch_isend_irecv ok", flush=True)
    finally:
        dist.destroy_process_group()


def world(backend: str, timeout: float) -> bool:
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen([sys.executable, __file__, "--worker", backend, str(r), init],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                  env=env) for r in range(2)]
        ok = True
        for r, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                out, _ = p.communicate()
                out += f"\n(timed out after {timeout} s)"
            ok &= p.returncode == 0
            tail = "\n".join(out.strip().splitlines()[-6:])
            print(f"--- {backend} rank {r}: exit {p.returncode}\n{tail}", flush=True)
        return ok


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--worker":
        try:
            worker(sys.argv[2], int(sys.argv[3]), sys.argv[4])
        except Exception:
            traceback.print_exc()
            return 1
        return 0
    import torch

    if not torch.cuda.is_available():
        print("check_one_card_backends: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {card.stdout.strip()}")
    nccl = world("nccl", 120)
    print(f"NCCL, two ranks on one card: {'ran' if nccl else 'refused'}")
    gloo = world("gloo", 120)
    print(f"gloo, two ranks on one card: {'ok' if gloo else 'FAILED'}")
    return 0 if gloo else 1


if __name__ == "__main__":
    sys.exit(main())
