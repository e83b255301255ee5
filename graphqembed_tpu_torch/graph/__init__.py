from graphqembed_tpu_torch.graph.schema import Relation, Schema, reverse_relation  # noqa: F401
from graphqembed_tpu_torch.graph.graph import Graph  # noqa: F401
from graphqembed_tpu_torch.graph.synthetic import (  # noqa: F401
    holdout_edges,
    synthetic_graph,
    synthetic_schema,
)
