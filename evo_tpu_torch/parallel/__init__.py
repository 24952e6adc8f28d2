"""Data parallelism over torch.distributed, one process per card
(counterpart: evo_tpu/parallel/)."""

from evo_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    DataMesh,
    get_mesh,
    make_mesh,
    shard_blocked,
    replicate,
    pprint,
    gather_to_host,
)
from evo_tpu_torch.parallel.distributed import (  # noqa: F401
    init_distributed,
    make_global_array,
    make_global_data,
    distribute_tree,
    distribute_estate,
    gather_global,
    global_init_stats,
    process_device,
)
