"""The edge-partitioned hop expansion of the port (parallel/halo.py) on 4
gloo ranks of this CPU, started once by `spawn_on_mesh`, against the JAX
package's on its 4-device CPU mesh: tests/test_halo.py's cases.

- build_union_neighbor_table gives JAX's table bit for bit on the
  conftest's graph (the port's copy of graph/ and numpy's default_rng).
- One hop of 64 frontier ids (16 a rank) within 1e-6 of JAX's expand_hop
  and within JAX's 2e-6 of the port's one-process expand_hop_reference.
- Two hops compose (the second hop's frontier is each node's first
  neighbor, gathered sharded): within 2e-6 of the reference composition
  and of JAX's, unit-norm rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_mesh_workers as workers
from jax.sharding import NamedSharding, PartitionSpec as P

from graphqembed_tpu.parallel import make_mesh
from graphqembed_tpu.parallel.gather import sharded_gather as jax_gather
from graphqembed_tpu.parallel.halo import build_union_neighbor_table as jax_union
from graphqembed_tpu.parallel.halo import expand_hop as jax_hop
from graphqembed_tpu_torch.graph.synthetic import synthetic_graph
from graphqembed_tpu_torch.parallel import spawn_on_mesh
from graphqembed_tpu_torch.parallel.halo import (
    build_union_neighbor_table,
    expand_hop_reference,
)

D = 4
TIMEOUT = 120
TOL = dict(rtol=2e-6, atol=2e-6)


@pytest.fixture(scope="module")
def inputs(graph):
    """tests/test_halo.py's setup at a mesh of 4, drawn with numpy: the
    table padded to a multiple of 4, the union table (S = 4, seed 1), the
    two weights and 64 frontier ids."""
    n = graph.schema.n_nodes
    pad = (-n) % D
    rng = np.random.default_rng(0)
    table = rng.normal(size=(n + pad, 16)).astype(np.float32)
    nbrs = jax_union(graph, sample_size=4, seed=1)
    nbrs = np.concatenate([nbrs, np.full((pad, 4), -1, np.int32)])
    w_self = (rng.normal(size=(16, 16)) / 4).astype(np.float32)
    w_nb = (rng.normal(size=(16, 16)) / 4).astype(np.float32)
    ids = rng.integers(0, n, size=64).astype(np.int32)
    return table, nbrs, ids, w_self, w_nb


@pytest.fixture(scope="module")
def ranks(inputs):
    return spawn_on_mesh(workers.run_cases, D, {"halo": ("case_halo",) + inputs},
                         device="cpu", timeout=TIMEOUT)["halo"]


@pytest.fixture(scope="module")
def jax_hops(inputs):
    table, nbrs, ids, w_self, w_nb = inputs
    mesh = make_mesh(D)
    rows = NamedSharding(mesh, P("data", None))
    t = jax.device_put(jnp.asarray(table), rows)
    nb = jax.device_put(jnp.asarray(nbrs), rows)
    i = jax.device_put(jnp.asarray(ids), NamedSharding(mesh, P("data")))
    # one program per hop (eager, every op on the sharded arrays compiles
    # its own); the second hop reuses the first's
    hop = jax.jit(lambda t, nb, i: jax_hop(mesh, t, nb, i, w_self, w_nb))
    first = jax.jit(lambda nb, i: jnp.maximum(
        jax_gather(mesh, nb, i)[:, 0], 0).astype(jnp.int32))
    return np.asarray(hop(t, nb, i)), np.asarray(hop(t, nb, first(nb, i)))


def test_union_neighbor_table_is_jax_s(graph):
    port_graph = synthetic_graph(**workers.DEEP_GRAPH)
    for s, seed in ((4, 1), (8, 0)):
        want = jax_union(graph, sample_size=s, seed=seed)
        got = build_union_neighbor_table(port_graph, sample_size=s, seed=seed)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_hop_matches_jax(ranks, jax_hops):
    np.testing.assert_allclose(ranks["hop1"], jax_hops[0], rtol=1e-6, atol=1e-6)


def test_hop_matches_reference(inputs, ranks):
    table, nbrs, ids, w_self, w_nb = inputs
    want = expand_hop_reference(*(torch.from_numpy(x) for x in
                                  (table, nbrs, ids, w_self, w_nb))).numpy()
    np.testing.assert_allclose(ranks["hop1"], want, **TOL)
    # each rank's hop against the reference on its own frontier
    np.testing.assert_allclose(ranks["hop1"], ranks["ref1"], **TOL)


def test_two_hops_compose(ranks, jax_hops):
    np.testing.assert_allclose(ranks["hop2"], ranks["ref2"], **TOL)
    np.testing.assert_allclose(ranks["hop2"], jax_hops[1], **TOL)
    np.testing.assert_allclose(np.linalg.norm(ranks["hop2"], axis=-1), 1.0,
                               rtol=1e-5)
