"""The owner-compute sharded gather of the port (parallel/gather.py over
parallel/mesh.py::all_to_all) on 4 gloo ranks of this CPU, started once by
`spawn_on_mesh`, against the JAX package's `sharded_gather` on its 4-device
CPU mesh with the same numpy-seeded tables and ids: tests/test_sharded_gather.py's
cases at a mesh of 4.

- Forward bit for bit against JAX's and against a plain take, also when
  every request names one owner (the worst-case capacity) and for an
  integer table (an adjacency keeps its dtype).
- Gradient of Σ rows·w within 1e-6 of the dense take's, the reference
  JAX's own test holds its gradient to (JAX's gradients are not taken
  here: each compiles for tens of seconds on this CPU).
- Capacity-bounded: factor 2 at perfectly balanced ownership drops
  nothing; factor 1 on a hotspot drops the SAME positions as JAX (its
  argsort is stable, and so is the port's) and the overflow equals JAX's
  psum; a factor at the worst case gives the dense gradient.
- Collectives: two all-to-alls forward and one backward per gather of a
  float table, one all-reduce for the overflow.
- `gather_capacity` equals JAX's over a grid of b, shards and factors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_mesh_workers as workers
from jax.sharding import NamedSharding, PartitionSpec as P

from graphqembed_tpu.parallel import make_mesh
from graphqembed_tpu.parallel.gather import gather_capacity as jax_capacity
from graphqembed_tpu.parallel.gather import (
    sharded_gather_with_overflow as jax_gather_overflow,
)
from graphqembed_tpu_torch.parallel import spawn_on_mesh
from graphqembed_tpu_torch.parallel.gather import gather_capacity

D = 4
TIMEOUT = 120


def _table(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _ids(n, b, seed):
    return np.random.default_rng(seed).integers(0, n, size=b).astype(np.int32)


# balanced: rank k's 4 requests hit owners 0..3 once each (8 rows a shard)
BALANCED = np.array([[o * 8 + k for o in range(D)] for k in range(D)],
                    np.int32).reshape(-1)

INPUTS = {
    "random": (_table(64, 16, 0), _ids(64, 32, 1), None, 0.0),
    "grad": (_table(64, 16, 3), _ids(64, 32, 4), _table(32, 16, 9), 0.0),
    "hotspot": (_table(64, 8, 0), np.full(32, 3, np.int32), None, 0.0),
    "seed5": (_table(64, 16, 5), _ids(64, 32, 6), None, 0.0),
    "int_table": (np.random.default_rng(7).integers(-1, 64, size=(64, 4)),
                  _ids(64, 32, 8), None, 0.0),
    "balanced": (_table(32, 8, 0), BALANCED, None, 2.0),
    "overflow": (_table(64, 8, 0), np.full(64, 3, np.int32), None, 1.0),
    "capped_grad": (_table(64, 16, 5), _ids(64, 32, 6), _table(32, 16, 11),
                    float(D)),
}


@pytest.fixture(scope="module")
def ranks():
    cases = {k: ("case_gather",) + v for k, v in INPUTS.items()}
    return spawn_on_mesh(workers.run_cases, D, cases, device="cpu",
                         timeout=TIMEOUT)


def _jax(name):
    """JAX's rows and overflow for INPUTS[name] on its 4-device mesh."""
    table, ids, _, factor = INPUTS[name]
    mesh = make_mesh(D)
    t = jax.device_put(jnp.asarray(table), NamedSharding(mesh, P("data", None)))
    i = jax.device_put(jnp.asarray(ids, jnp.int32), NamedSharding(mesh, P("data")))
    rows, over = jax_gather_overflow(mesh, t, i, capacity_factor=factor)
    return {"rows": np.asarray(rows), "overflow": int(over)}


def _dense_grad(name):
    table, ids, w, _ = INPUTS[name]
    g = np.zeros_like(table)
    np.add.at(g, ids, w)
    return g


def test_forward_matches_take(ranks):
    table, ids, _, _ = INPUTS["random"]
    got = ranks["random"]
    np.testing.assert_array_equal(got["rows"], table[ids])
    np.testing.assert_array_equal(got["rows"], _jax("random")["rows"])
    assert got["overflow"] == 0


def test_forward_single_owner_hotspot(ranks):
    """All ids on one shard: the worst-case capacity path."""
    table, ids, _, _ = INPUTS["hotspot"]
    np.testing.assert_array_equal(ranks["hotspot"]["rows"], table[ids])
    assert ranks["hotspot"]["overflow"] == 0


def test_gradient_matches_dense(ranks):
    got = ranks["grad"]
    np.testing.assert_allclose(got["grad"], _dense_grad("grad"), rtol=1e-6,
                               atol=1e-6)
    # two all-to-alls forward, the rows' one backward; the integer
    # requests have no gradient
    assert got["collectives"]["all_to_all"] == 3


def test_repeat_seed_and_integer_table(ranks):
    """JAX's jit case (seed 5) as a plain call, and an integer table (the
    adjacency's route) gathered exactly in its own dtype."""
    table, ids, _, _ = INPUTS["seed5"]
    np.testing.assert_array_equal(ranks["seed5"]["rows"], table[ids])
    itable, iids, _, _ = INPUTS["int_table"]
    assert ranks["int_table"]["dtype"] == "torch.int64"
    np.testing.assert_array_equal(ranks["int_table"]["rows"], itable[iids])


def test_capacity_bounded_uniform_no_overflow(ranks):
    """factor 2 at perfectly balanced ownership: no drop, the exact rows,
    and C = ceil(4/4·2) = 2 against the worst case's 4."""
    table, ids, _, _ = INPUTS["balanced"]
    got = ranks["balanced"]
    assert got["overflow"] == 0
    np.testing.assert_array_equal(got["rows"], table[ids])
    assert gather_capacity(len(ids) // D, D, 2.0) == 2
    assert gather_capacity(len(ids) // D, D, 0.0) == 4


def test_capacity_bounded_hotspot_overflows(ranks):
    """All ids on one owner at factor 1: 16 requests a rank, capacity 4,
    12 dropped on each rank; the served rows exact and the dropped ones 0,
    at JAX's positions."""
    table, ids, _, _ = INPUTS["overflow"]
    got, want = ranks["overflow"], _jax("overflow")
    assert got["overflow"] == want["overflow"] == D * 12
    served = np.abs(got["rows"]).sum(axis=1) > 0
    np.testing.assert_array_equal(served, np.abs(want["rows"]).sum(axis=1) > 0)
    assert served.sum() == D * 4
    np.testing.assert_array_equal(got["rows"], want["rows"])
    np.testing.assert_array_equal(got["rows"][served],
                                  np.tile(table[3], (D * 4, 1)))


def test_capacity_bounded_gradient_flows(ranks):
    """A factor of D is the worst case at D ranks: no drop, so the capped
    route's gradient is the dense one."""
    got = ranks["capped_grad"]
    assert got["overflow"] == 0
    np.testing.assert_allclose(got["grad"], _dense_grad("capped_grad"),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("factor", [-1.0, 0.0, 0.25, 1.0, 1.5, 2.0, 4.0, 9.0])
def test_gather_capacity_matches_jax(factor):
    for b in (1, 3, 8, 17, 64, 512):
        for n_shards in (1, 2, 4, 8):
            assert gather_capacity(b, n_shards, factor) == jax_capacity(
                b, n_shards, factor), (b, n_shards, factor)
