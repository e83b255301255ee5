from graphqembed_tpu_torch.data.queries import (  # noqa: F401
    STRUCT_SHAPE,
    Formula,
    Query,
    QueryBatch,
    group_by_formula,
    make_batch,
)
from graphqembed_tpu_torch.data.sampling import QuerySampler, answers  # noqa: F401
