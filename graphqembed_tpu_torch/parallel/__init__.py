"""Data parallelism over a torch.distributed process group: the batch split
over the ranks, the table row-sharded (mesh.py), and the train step that
calls the collectives (train_step.py); on a ('data', 'model') mesh also
tensor parallelism over 'model' (tp.py)."""

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
from graphqembed_tpu_torch.parallel.tp import (  # noqa: F401
    TensorParallel,
    model_parallel,
)
from graphqembed_tpu_torch.parallel.train_step import (  # noqa: F401
    make_sharded_scan_train_step,
    make_sharded_train_step,
)
