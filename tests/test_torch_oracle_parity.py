"""The port's oracle-parity bar (graphqembed_tpu_torch.experiments.
oracle_parity) against the JAX package's on the CPU, at a small size (scale
0.3, d = 32, B = 128, 400 steps), through the functions
chip_smoke.py calls:

- the bar's data: the port's parallel_sample (native, 8 threads, seed 7,
  50 negatives) equals the JAX package's query for query, and so does its
  SHA-256;
- the bar's init: the port's parameters carried to JAX as numpy arrays
  arrive bit for bit;
- with the MEAN intersection, the final parameters of the port's host loop
  equal JAX run_train's from the same init after 400 steps: each leaf's
  relative error in the Frobenius norm below 1e-4. The schedules are the
  same and one step agrees to an ulp or two, but Adam's normalised step
  lets roundoff grow over the run (3.1e-5 on the intersection leaves, 4.4e-6
  on the table, here); tests/test_torch_loop.py holds a few steps
  elementwise;
- with the MIN intersection (Adam turns roundoff at min ties into real
  steps, so parameters part), macro AUC and APR within 0.01 of JAX's.

Run as a script, the file computes the references chip_smoke.py holds the
card to, for one family at the bar's full settings (the JAX package's
parallel_sample data, the port's init carried across, the float64 oracle and
JAX run_train on the CPU; about 9 minutes a family, both families at once
on an 8-core host):

    python tests/test_torch_oracle_parity.py --reference bio-latent
"""

import os
import sys

if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from graphqembed_tpu.config import GQEConfig as JaxConfig  # noqa: E402
from graphqembed_tpu.data.sampling import parallel_sample as jax_parallel_sample  # noqa: E402
from graphqembed_tpu.graph.synthetic import synthetic_graph as jax_bio  # noqa: E402
from graphqembed_tpu.graph.synthetic import (  # noqa: E402
    synthetic_graph_latent as jax_latent,
)
from graphqembed_tpu.training import eval_apr as jax_eval_apr  # noqa: E402
from graphqembed_tpu.training import eval_auc as jax_eval_auc  # noqa: E402
from graphqembed_tpu.training import loop as jloop  # noqa: E402
from graphqembed_tpu_torch.experiments import oracle_parity as op  # noqa: E402
from graphqembed_tpu_torch.models.params import params_to_numpy, tree_paths  # noqa: E402
from jax_native_build import load_jax_native  # noqa: E402

SMALL = dict(scale=0.3, n_train=200, n_val=50)
SMALL_CFG = dict(steps=400, burn_in=100, lr=0.03, embed_dim=32, batch_size=128)
JAX_GRAPHS = {"bio": jax_bio, "bio-latent": jax_latent}


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX package's sampler library, built under a lock before any test
    here calls it (see jax_native_build.py)."""
    return load_jax_native()


@pytest.fixture(autouse=True)
def one_thread():
    """Eager PyTorch at these widths is launch-bound: one intra-op thread
    per test process keeps it fast when other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_config(cfg) -> JaxConfig:
    """The JAX package's config with the port config's fields."""
    import dataclasses
    return JaxConfig(**dataclasses.asdict(cfg))


def jax_bar_data(dataset, scale, n_train, n_val):
    graph = JAX_GRAPHS[dataset](seed=0, scale=scale, avg_degree=8.0)
    return graph, op.bar_data(graph, n_train, n_val, sample=jax_parallel_sample)


def _jax_leaves(params):
    return [np.asarray(x) for x in jax.tree.leaves(params)]


def _port_leaves(params):
    return [leaf.detach().float().numpy() for _, leaf in tree_paths(params)]


@pytest.fixture(scope="module")
def small():
    """The bar's pipeline at the small size on both sides: port graph, data
    and init; JAX graph and data."""
    graph = op.bar_graph("bio-latent", SMALL["scale"])
    port = op.bar_data(graph, SMALL["n_train"], SMALL["n_val"])
    jgraph, jdata = jax_bar_data("bio-latent", **SMALL)
    return graph, port, jgraph, jdata


def test_bar_data_equals_jax(small):
    _, (train, val, every), _, (jtrain, jval, jevery) = small
    assert len(every) == len(jevery) > 1500  # some structures run short here
    assert [q.serialize() for q in every] == [q.serialize() for q in jevery]
    assert [q.serialize() for q in val] == [q.serialize() for q in jval]
    assert len(train) == len(jtrain)
    assert op.queries_sha256(every) == op.queries_sha256(jevery)


def test_bar_init_carries_to_jax_bit_for_bit(small):
    graph = small[0]
    cfg = op.bar_config(**SMALL_CFG)
    p0 = op.bar_init(cfg, graph.schema)
    again = op.bar_init(cfg, graph.schema)
    np0 = params_to_numpy(p0)
    jp = jax.tree.map(jax.numpy.asarray, np0)
    for a, b, c in zip(_port_leaves(p0), _jax_leaves(jp), _port_leaves(again)):
        assert a.dtype == b.dtype == np.float32
        assert a.tobytes() == b.tobytes() == c.tobytes()
    assert op.params_sha256(np0) == op.params_sha256(
        jax.tree.map(np.asarray, jp))


def _both(small, intersection):
    graph, (train, val, _), jgraph, (jtrain, jval, _) = small
    cfg = op.bar_config(**SMALL_CFG, intersection=intersection)
    p0 = op.bar_init(cfg, graph.schema)
    # a copy: params_to_numpy shares memory with CPU tensors, which the
    # port's optimizer updates in place
    np0 = jax.tree.map(np.copy, params_to_numpy(p0))
    report, res = op.run_bar(cfg, graph.schema, p0, train, val, device="cpu")
    jcfg = jax_config(cfg)
    res_j = jloop.run_train(jcfg, jgraph.schema,
                            jax.tree.map(jax.numpy.asarray, np0), jtrain,
                            val_queries=jval)
    assert res.steps == res_j.steps == SMALL_CFG["steps"]
    assert res.burn_in_steps == res_j.burn_in_steps == SMALL_CFG["burn_in"]
    assert ([s for s, _ in res.val_history]
            == [s for s, _ in res_j.val_history] == [100, 200, 300, 400])
    return cfg, jcfg, report, res, res_j, jgraph, jval


def test_bar_mean_intersection_params_match_jax(small):
    cfg, _, report, res, res_j, _, _ = _both(small, "mean")
    assert report["launches"] == {k: 0 for k in report["launches"]}  # CPU
    for a, b in zip(_port_leaves(res.params), _jax_leaves(res_j.params)):
        rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        assert rel < 1e-4, rel


def test_bar_min_intersection_quality_matches_jax(small):
    cfg, jcfg, report, res, res_j, jgraph, jval = _both(small, "min")
    auc_j = jax_eval_auc(jcfg, res_j.best_params, jgraph.schema, jval,
                         seed=op.EVAL_SEED)
    apr_j = jax_eval_apr(jcfg, res_j.best_params, jgraph.schema, jval,
                         max_negs=op.APR_NEGS)
    assert report["auc"]["macro"] > 0.6, report["auc"]
    assert abs(report["auc"]["macro"] - auc_j["macro"]) < 0.01, (
        report["auc"], auc_j)
    assert abs(report["apr"]["macro"] - apr_j["macro"]) < 0.01, (
        report["apr"], apr_j)


# ---------- the references of chip_smoke.py's oracle_parity phase ----------

def _windows(losses: dict, k: int = 100) -> dict:
    """Per structure: the mean of its first and of its last k losses."""
    return {s: [float(np.mean(v[:k])), float(np.mean(v[-k:]))]
            for s, v in losses.items() if len(v) >= 2 * k}


def reference(dataset: str) -> dict:
    """The bar's references for one family at its full settings: the data
    and init digests, then the float64 oracle's and JAX run_train's results
    (per-structure and macro AUC, APR, hard AUC) from the port's init on the
    JAX package's data."""
    from graphqembed_tpu.oracle.train import (
        eval_apr_oracle,
        eval_auc_oracle,
        run_train_oracle,
    )

    load_jax_native()
    t0 = time.time()
    jgraph, (train, val, every) = jax_bar_data(
        dataset, op.BAR["scale"], op.BAR["n_train"], op.BAR["n_val"])
    data_sha = op.queries_sha256(every)
    cfg = op.bar_config()
    jcfg = jax_config(cfg)
    p0 = params_to_numpy(op.bar_init(cfg, op.bar_graph(dataset).schema))
    out = {"dataset": dataset, "n_queries": len(every),
           "data_sha256": data_sha, "init_sha256": op.params_sha256(p0),
           "sample_s": time.time() - t0}
    print(json.dumps(out), flush=True)

    def metrics(auc, apr, hard):
        return {"auc": auc, "apr": apr, "hard_auc": hard}

    t1 = time.time()
    res_o = run_train_oracle(jcfg, jgraph.schema, p0, train, val_queries=val)
    out["oracle"] = {
        **metrics(eval_auc_oracle(jcfg, res_o.best_params, jgraph.schema, val,
                                  seed=op.EVAL_SEED),
                  eval_apr_oracle(jcfg, res_o.best_params, jgraph.schema, val,
                                  max_negs=op.APR_NEGS),
                  eval_auc_oracle(jcfg, res_o.best_params, jgraph.schema, val,
                                  seed=op.EVAL_SEED, hard=True)),
        "steps": res_o.steps, "train_s": time.time() - t1}
    print(json.dumps({"oracle": out["oracle"]}), flush=True)

    t1 = time.time()
    res_j = jloop.run_train(jcfg, jgraph.schema,
                            jax.tree.map(jax.numpy.asarray, p0), train,
                            val_queries=val)
    out["jax_cpu"] = {
        **metrics(jax_eval_auc(jcfg, res_j.best_params, jgraph.schema, val,
                               seed=op.EVAL_SEED),
                  jax_eval_apr(jcfg, res_j.best_params, jgraph.schema, val,
                               max_negs=op.APR_NEGS),
                  jax_eval_auc(jcfg, res_j.best_params, jgraph.schema, val,
                               seed=op.EVAL_SEED, hard=True)),
        "steps": res_j.steps, "train_s": time.time() - t1,
        "loss_windows": _windows(res_j.losses)}
    return out


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--reference", required=True, choices=op.DATASETS)
    print(json.dumps(reference(ap.parse_args().reference), indent=1))
