"""Data parallelism over a torch.distributed process group: the batch split
over the ranks, the table row-sharded (mesh.py), and the train step that
calls the collectives (train_step.py); on a ('data', 'model') mesh also
tensor parallelism over 'model' (tp.py); the owner-compute gather over
all-to-alls (gather.py), the halo hop (halo.py), the sharded SAGE encoder
and its train step (deep.py); the multi-host start (multihost.py)."""

from graphqembed_tpu_torch.parallel.deep import (  # noqa: F401
    ShardedNeighborTables,
    make_sharded_deep_train_step,
    sage_encode_sharded,
)
from graphqembed_tpu_torch.parallel.gather import (  # noqa: F401
    gather_capacity,
    sharded_gather,
    sharded_gather_with_overflow,
)
from graphqembed_tpu_torch.parallel.halo import (  # noqa: F401
    build_union_neighbor_table,
    expand_hop,
    expand_hop_reference,
)
from graphqembed_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_sharding,
    gather_table,
    make_mesh,
    make_mesh_2d,
    mesh_consistent,
    pad_table_rows,
    param_shardings,
    replicated,
    shard_params,
    spawn_on_mesh,
    table_sharding,
    unshard_model,
)
from graphqembed_tpu_torch.parallel.multihost import (  # noqa: F401
    global_batch_from_local,
    initialize_multihost,
)
from graphqembed_tpu_torch.parallel.tp import (  # noqa: F401
    TensorParallel,
    model_parallel,
)
from graphqembed_tpu_torch.parallel.train_step import (  # noqa: F401
    make_sharded_scan_train_step,
    make_sharded_train_step,
)
