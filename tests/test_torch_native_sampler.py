"""The port's native C++ sampler (graphqembed_tpu_torch.native), its
parallel_sample and the array-to-pool path, against the JAX package's on
the CPU, on the same graph (synthetic_graph seed 7, scale 0.5, degree 6).

- The cases of tests/test_native_sampler.py on the port: invariants per
  structure (the target is an answer; negatives are non-answers of the
  target mode; hard negatives are partial matches that are not answers),
  determinism, dedup, exhaustive negatives, all_edges_1p's coverage with
  threads and subsampling, the clean sampler. Exact.
- native_sample_arrays, native_sample_clean_arrays and native_all_edges_1p
  equal to the JAX binding's arrays element for element (the same source,
  seed and graph encoding).
- parallel_sample equal to the JAX package's query for query on both
  engines, with 1 and 4 workers.
- device_pool_from_arrays and DeviceTrainData.from_pools equal to the JAX
  package's pools, and to DevicePool built from the same queries. Exact.
- A failed build raises, on every engine of parallel_sample, and is never
  replaced by the Python sampler.
"""

import numpy as np
import pytest

from graphqembed_tpu.data import sampling as jax_sampling
from graphqembed_tpu.graph.synthetic import holdout_edges as jax_holdout
from graphqembed_tpu.graph.synthetic import synthetic_graph as jax_graph
from graphqembed_tpu.native import binding as jax_binding
from graphqembed_tpu.training import device_data as jax_dd
from graphqembed_tpu_torch.config import STRUCTURES
from graphqembed_tpu_torch.data.sampling import (
    answers,
    branch_answer_sets,
    is_answer,
    parallel_sample,
    project_set,
)
from graphqembed_tpu_torch.graph.synthetic import holdout_edges, synthetic_graph
from graphqembed_tpu_torch.native import binding
from graphqembed_tpu_torch.native import (
    native_all_edges_1p,
    native_sample_arrays,
    native_sample_clean_arrays,
    native_sample_clean_many,
    native_sample_many,
)
from graphqembed_tpu_torch.training.device_data import (
    POOL_FIELDS,
    DevicePool,
    DeviceTrainData,
    device_pool_from_arrays,
)
from jax_native_build import load_jax_native

ARRAY_KEYS = ("rels", "anchors", "targets", "negs", "neg_counts", "hard",
              "hard_counts")


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX package's sampler library, built under a lock before any test
    here calls it (see jax_native_build.py)."""
    return load_jax_native()


@pytest.fixture(scope="module")
def graphs():
    """The same graph in the port's and the JAX package's types."""
    return (synthetic_graph(seed=7, scale=0.5, avg_degree=6.0),
            jax_graph(seed=7, scale=0.5, avg_degree=6.0))


@pytest.fixture(scope="module")
def g(graphs):
    return graphs[0]


def _valid(pool: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """The pool with every entry past its row's count set to -1: the JAX
    binding leaves that padding uninitialised."""
    pool = np.array(pool)
    pool[np.arange(pool.shape[1])[None, :] >= np.asarray(counts)[:, None]] = -1
    return pool


def _assert_arrays_equal(a: dict, b: dict):
    assert a["structure"] == b["structure"]
    for k in ARRAY_KEYS:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
    for k in ("rels", "anchors", "targets", "neg_counts", "hard_counts"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k, c in (("negs", "neg_counts"), ("hard", "hard_counts")):
        np.testing.assert_array_equal(_valid(a[k], a[c]), _valid(b[k], b[c]),
                                      err_msg=k)
        # the port's padding is zeros
        assert not (a[k] - np.maximum(_valid(a[k], a[c]), 0)).any(), k


@pytest.mark.parametrize("structure", STRUCTURES)
def test_native_invariants(g, structure):
    qs = native_sample_many(g, structure, 30, seed=1, max_negs=25)
    assert len(qs) >= 10, f"starved for {structure}"
    for q in qs[:10]:
        ans = answers(g, q.formula, q.anchors)
        assert q.target in ans
        assert not (set(q.neg_samples.tolist()) & ans)
        lo, hi = g.schema.mode_range(q.formula.target_mode)
        assert np.all((q.neg_samples >= lo) & (q.neg_samples < hi))
        if q.hard_neg_samples is not None:
            hard = set(q.hard_neg_samples.tolist())
            assert not (hard & ans)
            branches = branch_answer_sets(g, q.formula, q.anchors)
            partial = set.union(*branches)
            if structure == "ip":
                partial = project_set(g, partial, q.formula.rels[2])
            assert hard <= partial


def test_native_deterministic_dedup_exhaustive(g):
    a = native_sample_many(g, "2i", 20, seed=7)
    b = native_sample_many(g, "2i", 20, seed=7)
    c = native_sample_many(g, "2i", 20, seed=8)
    assert [q.serialize() for q in a] == [q.serialize() for q in b]
    assert [q.serialize() for q in a] != [q.serialize() for q in c]
    qs = native_sample_many(g, "1p", 200, seed=0, max_negs=10)
    assert len({q.dedup_key() for q in qs}) == len(qs)
    for q in native_sample_many(g, "1p", 5, seed=2, exhaustive_negs=True):
        ans = answers(g, q.formula, q.anchors)
        lo, hi = g.schema.mode_range(q.formula.target_mode)
        # every non-answer of the target mode is a negative
        assert len(q.neg_samples) == (hi - lo) - len(ans & set(range(lo, hi)))


def test_all_edges_1p_full_coverage_and_threads(g):
    """Every directed edge exactly once as a 1p query, whatever the thread
    count; negatives are exact non-answers."""
    schema = g.schema
    n_edges = g.num_edges()
    ref = None
    for nt in (1, 2, 3):
        arr = native_all_edges_1p(g, seed=5, max_negs=8, n_threads=nt)
        assert len(arr["targets"]) == n_edges
        rows = np.stack([arr["anchors"][:, 0], arr["rels"][:, 0],
                         arr["targets"]], axis=1)
        key = rows[np.lexsort(rows.T[::-1])]
        assert len(np.unique(key, axis=0)) == n_edges
        if ref is None:
            ref = key
        np.testing.assert_array_equal(key, ref)
        for i in np.random.default_rng(0).choice(n_edges, size=50, replace=False):
            a, r, t = (int(arr["anchors"][i, 0]), int(arr["rels"][i, 0]),
                       int(arr["targets"][i]))
            nbrs = set(g.neighbors(a, schema.relations[r]).tolist())
            assert t in nbrs
            c = int(arr["neg_counts"][i])
            lo, hi = schema.mode_range(schema.relations[r][2])
            assert c > 0
            assert all(lo <= n < hi and int(n) not in nbrs
                       for n in arr["negs"][i, :c])


def test_all_edges_1p_subsample(g):
    cap = g.num_edges() // 3
    arr = native_all_edges_1p(g, cap=cap, seed=5, max_negs=8, n_threads=4)
    got = len(arr["targets"])
    assert 0.5 * cap <= got <= cap, (got, cap)
    for i in range(0, got, max(1, got // 40)):
        rel = g.schema.relations[int(arr["rels"][i, 0])]
        assert int(arr["targets"][i]) in set(
            g.neighbors(int(arr["anchors"][i, 0]), rel).tolist())


@pytest.mark.parametrize("structure", ["1p", "3p", "3i", "ip", "pi"])
def test_native_clean_sampler_invariants(g, structure):
    """Answerable on the full graph, not on the train graph; negatives and
    hard negatives are full-graph non-answers."""
    train, _ = holdout_edges(g, 0.1, seed=1)
    qs = native_sample_clean_many(g, train, structure, 30, seed=3, max_negs=10)
    assert len(qs) > 0
    for q in qs[:12]:
        assert is_answer(g, q.formula, q.anchors, q.target)
        assert not is_answer(train, q.formula, q.anchors, q.target)
        for neg in q.neg_samples[:4]:
            assert not is_answer(g, q.formula, q.anchors, int(neg))
        if q.hard_neg_samples is not None:
            for h in q.hard_neg_samples[:4]:
                assert not is_answer(g, q.formula, q.anchors, int(h))


@pytest.mark.parametrize("structure,exhaustive", [
    (s, False) for s in STRUCTURES] + [("2p", True), ("pi", True)])
def test_sample_arrays_equal_jax(graphs, structure, exhaustive):
    g, gj = graphs
    kw = dict(seed=11, max_negs=20, exhaustive_negs=exhaustive)
    _assert_arrays_equal(native_sample_arrays(g, structure, 60, **kw),
                         jax_binding.native_sample_arrays(gj, structure, 60, **kw))


@pytest.mark.parametrize("structure", ["1p", "2p", "3i", "ip", "pi"])
def test_clean_arrays_equal_jax(graphs, structure):
    g, gj = graphs
    t, _ = holdout_edges(g, 0.1, seed=1)
    tj, _ = jax_holdout(gj, 0.1, seed=1)
    kw = dict(seed=3, max_negs=10)
    _assert_arrays_equal(
        native_sample_clean_arrays(g, t, structure, 30, **kw),
        jax_binding.native_sample_clean_arrays(gj, tj, structure, 30, **kw))
    kw = dict(seed=4, exhaustive_negs=True)
    _assert_arrays_equal(
        native_sample_clean_arrays(g, t, structure, 10, **kw),
        jax_binding.native_sample_clean_arrays(gj, tj, structure, 10, **kw))


@pytest.mark.parametrize("cap,n_threads", [(None, 1), (None, 3), (500, 2)])
def test_all_edges_1p_equal_jax(graphs, cap, n_threads):
    g, gj = graphs
    kw = dict(cap=cap, seed=5, max_negs=8, n_threads=n_threads)
    _assert_arrays_equal(native_all_edges_1p(g, **kw),
                         jax_binding.native_all_edges_1p(gj, **kw))


@pytest.mark.parametrize("engine,n_workers", [
    ("native", 1), ("native", 4), ("python", 1), ("python", 4), ("auto", 4)])
def test_parallel_sample_equals_jax(graphs, engine, n_workers):
    g, gj = graphs
    for structure, n, exhaustive in (("1p", 60, False), ("3i", 40, False),
                                     ("pi", 40, False), ("2p", 12, True)):
        kw = dict(n_workers=n_workers, seed=5, exhaustive_negs=exhaustive,
                  max_negs=20, engine=engine)
        qs = parallel_sample(g, structure, n, **kw)
        qj = jax_sampling.parallel_sample(gj, structure, n, **kw)
        assert 0 < len(qs) <= n
        assert [q.serialize() for q in qs] == [q.serialize() for q in qj]
        assert len({q.dedup_key() for q in qs}) == len(qs)


@pytest.mark.parametrize("structure", ["1p", "2p", "3i", "ip", "pi"])
def test_pools_from_arrays_equal_jax_and_query_pools(graphs, structure):
    g, gj = graphs
    arrays = native_sample_arrays(g, structure, 40, seed=3, max_negs=16)
    pool = device_pool_from_arrays(g.schema, arrays, device="cpu")
    pool_j = jax_dd.device_pool_from_arrays(
        gj.schema, jax_binding.native_sample_arrays(gj, structure, 40, seed=3,
                                                    max_negs=16))
    assert pool.structure == pool_j.structure and pool.n == pool_j.n
    for k in POOL_FIELDS:
        a, b = getattr(pool, k).numpy(), np.asarray(getattr(pool_j, k))
        if k in ("negs", "hard"):   # past each row's count: padding
            c = getattr(pool, "neg_counts" if k == "negs" else "hard_counts")
            a, b = _valid(a, c.numpy()), _valid(b, c.numpy())
        np.testing.assert_array_equal(a, b, err_msg=k)
    # the same queries through Query objects: the pools' widths hold every
    # negative here (16 of at most 16), so both routes keep the same pools
    qs = native_sample_many(g, structure, 40, seed=3, max_negs=16)
    by_q = DevicePool(g.schema, structure, qs, device="cpu")
    for k in ("anchors", "rels", "inter_modes", "targets", "neg_counts"):
        np.testing.assert_array_equal(getattr(pool, k).numpy(),
                                      getattr(by_q, k).numpy(), err_msg=k)
    data = DeviceTrainData.from_pools({structure: pool}, device="cpu")
    data_j = jax_dd.DeviceTrainData.from_pools({structure: pool_j})
    assert data.weights == data_j.weights == {structure: pool.n}
    assert data.structures == [structure]


def test_failed_build_raises_on_every_engine(graphs, tmp_path, monkeypatch):
    """A broken source raises with g++'s message; parallel_sample does not
    fall back to the Python sampler."""
    g = graphs[0]
    broken = tmp_path / "sampler.cpp"
    broken.write_text("this is not C++;\n")
    monkeypatch.setattr(binding, "SOURCE", broken)
    monkeypatch.setattr(binding, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(binding, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_sample_arrays(g, "1p", 5)
    for engine in ("auto", "native"):
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            parallel_sample(g, "2i", 10, n_workers=2, engine=engine)
    assert not list((tmp_path / "build").glob("*.so"))  # nothing half-built


def test_without_gxx_auto_is_python_and_native_raises(graphs, tmp_path,
                                                      monkeypatch):
    g = graphs[0]
    monkeypatch.setattr(binding, "_gxx", lambda: None)
    monkeypatch.setattr(binding, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(binding, "_LIB", None)
    assert not binding.native_available()
    kw = dict(n_workers=1, seed=2, max_negs=10)
    assert ([q.serialize() for q in parallel_sample(g, "2p", 20, **kw)]
            == [q.serialize() for q in
                parallel_sample(g, "2p", 20, engine="python", **kw)])
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        parallel_sample(g, "2p", 20, engine="native", **kw)


def test_library_builds_into_build_dir(tmp_path, monkeypatch, graphs):
    """The library is built at first use under BUILD_DIR, named by a hash of
    the source and the flags."""
    monkeypatch.setattr(binding, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(binding, "_LIB", None)
    path = binding.lib_path()
    assert path.parent == tmp_path / "build" and not path.exists()
    assert path.name.startswith("libgqe_sampler-")
    assert len(native_sample_arrays(graphs[0], "1p", 5)["targets"]) == 5
    assert path.exists()
    assert [p.name for p in (tmp_path / "build").iterdir()] == [path.name]


def test_library_name_covers_the_host_target(monkeypatch):
    """A host whose -march=native resolves to other instructions gets a
    library of another name, never one built for this host's CPU."""
    here = binding.lib_path()
    monkeypatch.setattr(binding, "_host_target", lambda gxx: "-march=other")
    assert binding.lib_path() != here
    assert binding.lib_path().parent == here.parent


def test_pool_entry_points_default_to_the_card(graphs):
    """device=None means the card: without one, both raise."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    g = graphs[0]
    arrays = native_sample_arrays(g, "2p", 10, seed=1, max_negs=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_pool_from_arrays(g.schema, arrays)
    pool = device_pool_from_arrays(g.schema, arrays, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceTrainData.from_pools({"2p": pool})
