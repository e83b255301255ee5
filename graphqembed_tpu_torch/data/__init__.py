from graphqembed_tpu_torch.data.queries import STRUCT_SHAPE, Formula, Query  # noqa: F401
from graphqembed_tpu_torch.data.sampling import QuerySampler, answers  # noqa: F401
