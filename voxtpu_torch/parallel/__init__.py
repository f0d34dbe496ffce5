"""Multi-process sharding on `torch.distributed` (port of
`voxtpu/parallel`).

Every rank runs the body of voxtpu's `shard_map` programs (SPMD):
sharded_vox / sharded_jfa / sharded_fit and the three sharded kernel
engines (sharded_soft_pallas, sharded_soft_fused, sharded_soft_seg);
`collectives` holds their collectives; `distributed` starts the process
group.
"""

from voxtpu_torch.parallel.distributed import (global_from_local, global_mesh,
                                               init_distributed, local_from_global,
                                               shutdown_distributed)

__all__ = [
    "global_from_local",
    "global_mesh",
    "init_distributed",
    "local_from_global",
    "shutdown_distributed",
]
