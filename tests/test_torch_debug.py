"""The port's debug checks (graphqembed_tpu_torch/utils/debug.py) beside
the JAX package's (tests/test_debug.py's two cases): the same ids are
accepted and refused by both validators, and the checked margin loss
gives JAX's value (rtol 1e-5) on JAX's parameters carried across, and
raises on both sides once a table row the batch reads is NaN."""

import jax
import numpy as np
import pytest
import torch

from graphqembed_tpu.config import GQEConfig as JaxConfig
from graphqembed_tpu.data.queries import group_by_formula, make_batch
from graphqembed_tpu.data.sampling import QuerySampler
from graphqembed_tpu.models.params import init_params, params_to_numpy
from graphqembed_tpu.utils import checked_margin_loss as jax_checked
from graphqembed_tpu.utils import validate_ids as jax_validate
from graphqembed_tpu_torch.config import GQEConfig
from graphqembed_tpu_torch.models.params import params_from_jax
from graphqembed_tpu_torch.utils import checked_margin_loss, validate_ids


@pytest.mark.parametrize("ok,ids", [
    (True, lambda n: [0, n - 1]),
    (False, lambda n: [0, n]),
    (False, lambda n: [-1]),
    (True, lambda n: []),
])
def test_validate_ids(graph, ok, ids):
    n = graph.schema.n_nodes
    a = np.array(ids(n), dtype=np.int64)
    for fn in (jax_validate, validate_ids):
        for x in (a, torch.from_numpy(a)) if fn is validate_ids else (a,):
            if ok:
                fn(x, n)
            else:
                with pytest.raises(ValueError, match="out-of-range"):
                    fn(x, n)


def _batch(graph):
    s = QuerySampler(graph, np.random.default_rng(0), max_negs=5)
    qs = max(group_by_formula(s.sample_many("1p", 20)).values(), key=len)
    return make_batch(graph.schema, qs, batch_size=len(qs), neg_width=1,
                      rng=np.random.default_rng(0))


def test_checked_loss_clean_and_poisoned(graph):
    jcfg = JaxConfig(embed_dim=16, projection="transe")
    cfg = GQEConfig(embed_dim=16, projection="transe")
    jparams = init_params(jcfg, graph.schema, jax.random.key(0))
    params = params_from_jax(params_to_numpy(jparams), device="cpu")
    b = _batch(graph)
    args = ("1p", b.anchors, b.rels, np.int32(b.inter_mode_id), b.targets,
            b.negs[:, 0], b.row_mask)
    want = float(jax_checked(jcfg)(jparams, *args))
    got = float(checked_margin_loss(cfg)(params, *args).detach())
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)

    row = int(b.anchors[0, 0])
    jpoisoned = dict(jparams, table=jparams["table"].at[row].set(np.nan))
    with pytest.raises(Exception):  # checkify JaxRuntimeError
        jax_checked(jcfg)(jpoisoned, *args)
    poisoned = dict(params, table=params["table"].detach().clone())
    poisoned["table"][row] = float("nan")
    with pytest.raises(FloatingPointError, match="not finite"):
        checked_margin_loss(cfg)(poisoned, *args)

    bad = b.targets.copy()
    bad[0] = graph.schema.n_nodes
    with pytest.raises(ValueError, match="targets: out-of-range"):
        checked_margin_loss(cfg)(params, "1p", b.anchors, b.rels,
                                 np.int32(b.inter_mode_id), bad, b.negs[:, 0],
                                 b.row_mask)
