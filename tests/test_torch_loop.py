"""The port's host training loop (graphqembed_tpu_torch.training.loop)
against the JAX package's on the CPU.

- `check_conv`: the same answers on a table of series. Exact.
- `TrainData`: the same batches for the same seed, all 7 structures, with
  and without hard negatives. Exact (both draw from numpy in one order).
- `run_train` under SGD for 20 steps from the same parameters
  (`params_from_jax`) on the same queries: parameters within atol 1e-5,
  the bar tests/test_oracle_trained.py sets for the PyTorch oracle against
  JAX (the batch schedule is the same; float32 gradients agree to a few
  ulps, tests/test_torch_gqe_formula.py).
- `run_train` under Adam with the MEAN intersection for 6 steps: rtol 1e-4
  and atol 1e-5 × the leaf's largest magnitude, as for the scan step
  (tests/test_torch_device_data.py, which says why the min intersection is
  held for one step only under Adam).
- A small full protocol (burn-in, multitask over 7 structures, evals, best
  parameters) from the same parameters: macro AUC above 0.6 on both sides
  and within 0.03 of JAX's. The schedules are the same, but Adam steps on
  roundoff-level gradients (min intersection) part the trajectories, so
  only the metric is compared, with the oracle test's macro tolerance.
- Resume: a run checkpointed and resumed ends bit-identical to the
  uninterrupted run.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from graphqembed_tpu.config import STRUCTURES as JAX_STRUCTURES
from graphqembed_tpu.config import GQEConfig as JaxConfig
from graphqembed_tpu.data.sampling import QuerySampler as JaxSampler
from graphqembed_tpu.graph.synthetic import synthetic_graph as jax_graph
from graphqembed_tpu.models.params import init_params as jax_init_params
from graphqembed_tpu.models.params import params_to_numpy as jax_to_numpy
from graphqembed_tpu.training import eval_auc as jax_eval_auc
from graphqembed_tpu.training import loop as jloop
from graphqembed_tpu_torch.config import STRUCTURES, GQEConfig
from graphqembed_tpu_torch.data.sampling import QuerySampler
from graphqembed_tpu_torch.graph.synthetic import synthetic_graph
from graphqembed_tpu_torch.models.params import params_from_jax, tree_paths
from graphqembed_tpu_torch.training import eval_auc
from graphqembed_tpu_torch.training import loop as tloop
from graphqembed_tpu_torch.training.checkpoint import CheckpointManager
from graphqembed_tpu_torch.training.device_data import FusedAdamOpt, SGDOpt


@pytest.fixture(autouse=True)
def one_thread():
    """Eager PyTorch at these widths is launch-bound: one intra-op thread
    per test process keeps it fast when other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(structures, n_per, seed=0, scale=0.5, avg_degree=8.0, max_negs=30,
          n_val=0):
    """The same graph and queries in both packages' types."""
    out = []
    for gen, sampler in ((jax_graph, JaxSampler), (synthetic_graph, QuerySampler)):
        g = gen(seed=seed, scale=scale, avg_degree=avg_degree)
        s = sampler(g, np.random.default_rng(seed), max_negs=max_negs)
        train, val = [], []
        for st in structures:
            qs = s.sample_many(st, n_per + n_val)
            train += qs[:n_per]
            val += qs[n_per:]
        out.append((g, train, val))
    return out


def _leaves(params):
    return [np.asarray(x) for x in jax.tree.leaves(params)]


def _port_leaves(params):
    return [leaf.detach().float().numpy() for _, leaf in tree_paths(params)]


SERIES = [
    ([1.0] * 10, 10, 1e-3),
    (list(np.linspace(1.0, 0.1, 40)), 10, 1e-3),
    (list(np.linspace(1.0, 0.1, 30)) + [0.1] * 20, 10, 1e-3),
    ([0.5, 0.4, 0.6, 0.5, 0.55, 0.45], 3, 0.0),
    ([2.0, 1.0, 0.0, 0.0], 2, 0.5),
    ([0.0, 0.0, 0.0, 0.0], 2, 1e-6),
    (list(np.random.default_rng(3).random(200)), 50, 1e-6),
    (list(np.linspace(3.0, 2.9, 400)), 100, 1e-2),
]


@pytest.mark.parametrize("i", range(len(SERIES)))
def test_check_conv_matches_jax(i):
    losses, window, tol = SERIES[i]
    assert tloop.check_conv(losses, window, tol) == jloop.check_conv(
        losses, window, tol)
    for k in range(1, len(losses) + 1):
        assert tloop.check_conv(losses[:k], window, tol) == jloop.check_conv(
            losses[:k], window, tol)


@pytest.fixture(scope="module")
def seven():
    (gj, qj, _), (gt, qt, _) = _data(STRUCTURES, 40, seed=3, max_negs=10)
    return gj, qj, gt, qt


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("structure", list(STRUCTURES))
def test_train_data_batches_match_jax(seven, structure, hard):
    gj, qj, gt, qt = seven
    # 64: every formula has fewer queries, so they are drawn with
    # replacement; 8: some formulas have more, drawn without
    dj = jloop.TrainData(gj.schema, qj, batch_size=64, seed=11)
    dt = tloop.TrainData(gt.schema, qt, batch_size=64, seed=11)
    assert dt.structures == dj.structures == list(JAX_STRUCTURES)
    assert dt.struct_weights == dj.struct_weights
    for _ in range(3):
        assert dt.pick_structure(True) == dj.pick_structure(True)
        for a, b in zip(dt.sample_batch(structure, hard=hard),
                        dj.sample_batch(structure, hard=hard)):
            np.testing.assert_array_equal(a, b)
    small_t = tloop.TrainData(gt.schema, qt, batch_size=8, seed=4)
    small_j = jloop.TrainData(gj.schema, qj, batch_size=8, seed=4)
    for a, b in zip(small_t.sample_batch(structure, hard=hard),
                    small_j.sample_batch(structure, hard=hard)):
        np.testing.assert_array_equal(a, b)


def test_host_loop_sgd_matches_jax():
    """20 full protocol steps under SGD from the same parameters."""
    kw = dict(embed_dim=16, batch_size=32, max_iter=20, max_burn_in=8,
              val_every=10**9, tol=0.0, conv_window=10**6, lr=0.05)
    (gj, qj, _), (gt, qt, _) = _data(("1p", "2i"), 120)
    p0 = jax_to_numpy(jax_init_params(JaxConfig(**kw), gj.schema,
                                      jax.random.key(0)))
    res_j = jloop.run_train(JaxConfig(**kw), gj.schema,
                            jax.tree.map(jax.numpy.asarray, p0), qj,
                            optimizer=optax.sgd(kw["lr"]))
    res_t = tloop.run_train(GQEConfig(**kw), gt.schema,
                            params_from_jax(p0, device="cpu"), qt,
                            optimizer=SGDOpt(kw["lr"]), device="cpu")
    assert res_t.steps == res_j.steps == 20
    assert res_t.burn_in_steps == res_j.burn_in_steps == 8
    for s in res_j.losses:
        np.testing.assert_allclose(res_t.losses[s], res_j.losses[s],
                                   rtol=1e-5, atol=1e-6)
    for a, b in zip(_port_leaves(res_t.params), _leaves(res_j.params)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_host_loop_adam_mean_intersection_matches_jax():
    """A few Adam steps (the port's default FusedAdamOpt against optax.adam)
    with the mean intersection, on a chain and an intersection structure."""
    kw = dict(embed_dim=16, batch_size=32, max_iter=6, max_burn_in=2,
              val_every=10**9, tol=0.0, conv_window=10**6, lr=0.02,
              intersection="mean")
    (gj, qj, _), (gt, qt, _) = _data(("1p", "2p", "3i"), 80)
    p0 = jax_to_numpy(jax_init_params(JaxConfig(**kw), gj.schema,
                                      jax.random.key(1)))
    res_j = jloop.run_train(JaxConfig(**kw), gj.schema,
                            jax.tree.map(jax.numpy.asarray, p0), qj)
    res_t = tloop.run_train(GQEConfig(**kw), gt.schema,
                            params_from_jax(p0, device="cpu"), qt, device="cpu")
    assert res_t.steps == res_j.steps == 6
    for a, b in zip(_port_leaves(res_t.params), _leaves(res_j.params)):
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(b).max()))


def test_small_full_protocol_matches_jax_quality():
    """Burn-in, the weighted multitask phase over all 7 structures, two
    evals and the best parameters, from the same parameters and the same
    batch schedule in both packages."""
    kw = dict(embed_dim=32, projection="bilinear", batch_size=128,
              max_iter=1000, max_burn_in=200, val_every=500,
              conv_window=10**6, tol=0.0, lr=0.03, seed=2)
    (gj, qj, vj), (gt, qt, vt) = _data(STRUCTURES, 600, seed=7, scale=0.25,
                                       avg_degree=6.0, n_val=100)
    p0 = jax_to_numpy(jax_init_params(JaxConfig(**kw), gj.schema,
                                      jax.random.key(1)))
    res_j = jloop.run_train(JaxConfig(**kw), gj.schema,
                            jax.tree.map(jax.numpy.asarray, p0), qj,
                            val_queries=vj)
    res_t = tloop.run_train(GQEConfig(**kw), gt.schema,
                            params_from_jax(p0, device="cpu"), qt,
                            val_queries=vt, device="cpu")
    assert res_t.steps == res_j.steps == 1000
    assert res_t.burn_in_steps == res_j.burn_in_steps == 200
    assert [s for s, _ in res_t.val_history] == [500, 1000]
    assert all(len(res_t.losses[s]) > 0 for s in STRUCTURES)
    auc_t = eval_auc(GQEConfig(**kw), res_t.best_params, gt.schema, vt, seed=9)
    auc_j = jax_eval_auc(JaxConfig(**kw), res_j.best_params, gj.schema, vj,
                         seed=9)
    assert auc_t["macro"] > 0.6 and auc_j["macro"] > 0.6, (auc_t, auc_j)
    assert abs(auc_t["macro"] - auc_j["macro"]) < 0.03, (auc_t, auc_j)
    # the best parameters are a copy, not the parameters trained on in place
    for (_, b), (_, p) in zip(tree_paths(res_t.best_params),
                              tree_paths(res_t.params)):
        assert b.data_ptr() != p.data_ptr()


def test_run_train_resume_is_bit_identical(tmp_path):
    """Checkpoint every 10 steps, stop at 30, resume to 50: the parameters
    equal those of an uninterrupted 50-step run bit for bit (the numpy RNG
    state, Adam state and burn-in / hard-negative counters are restored)."""
    kw = dict(embed_dim=16, batch_size=32, max_burn_in=12, val_every=10**9,
              tol=0.0, conv_window=10**6, lr=0.02)
    _, (gt, qt, _) = _data(("1p", "2i", "3i"), 60)

    def run(max_iter, mgr=None, resume=False, ckpt_every=0):
        cfg = GQEConfig(**kw, max_iter=max_iter)
        params = params_from_jax(jax_to_numpy(jax_init_params(
            JaxConfig(**kw), gt.schema, jax.random.key(2))), device="cpu")
        return tloop.run_train(cfg, gt.schema, params, qt, ckpt_manager=mgr,
                               ckpt_every=ckpt_every, resume=resume,
                               device="cpu")

    full = run(50)
    mgr = CheckpointManager(tmp_path / "ckpts", keep=2)
    run(30, mgr, ckpt_every=10)
    resumed = run(50, mgr, resume=True, ckpt_every=10)
    assert resumed.steps == full.steps == 50
    assert resumed.burn_in_steps == full.burn_in_steps == 12
    for (path, a), (_, b) in zip(tree_paths(full.params),
                                 tree_paths(resumed.params)):
        assert torch.equal(a, b), path
    assert resumed.losses["2i"] == full.losses["2i"][-len(resumed.losses["2i"]):]


def test_train_step_takes_fused_adam_and_sgd_only():
    cfg = GQEConfig(embed_dim=8)
    tloop.make_train_step(cfg, FusedAdamOpt(0.01))
    tloop.make_train_step(cfg, SGDOpt(0.01))
    with pytest.raises(ValueError, match="FusedAdamOpt"):
        tloop.make_train_step(cfg, object())
    with pytest.raises(ValueError, match="stochastic-rounding"):
        tloop.make_train_step(GQEConfig(embed_dim=8, storage_dtype="bfloat16"),
                              SGDOpt(0.01))
    # the SAGE encoder reads neighbor tables: refused without them at
    # depth 1; not read at depth 0, as in JAX
    tloop.make_train_step(cfg, FusedAdamOpt(0.01), neighbor_tables=object())
    with pytest.raises(ValueError, match="neighbor_tables"):
        tloop.make_train_step(GQEConfig(embed_dim=8, depth=1),
                              FusedAdamOpt(0.01))


def test_metrics_writer_and_throughput_meter(tmp_path):
    """The JSONL stream, the TensorBoard scalars beside it, and the edge
    counts per structure (the JAX package's table)."""
    import json

    from graphqembed_tpu.training.metrics import EDGES_PER_QUERY as JAX_EDGES
    from graphqembed_tpu_torch.training.metrics import (
        EDGES_PER_QUERY,
        MetricsWriter,
        setup_logging,
    )

    assert EDGES_PER_QUERY == JAX_EDGES
    w = MetricsWriter(tmp_path / "run", tensorboard=True)
    w.write(10, **{"loss/1p": 0.5})
    w.write(20, **{"val_auc/macro": 0.75, "note": "x"})
    w.close()
    recs = [json.loads(line) for line in
            (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [10, 20]
    assert recs[0]["loss/1p"] == 0.5 and recs[1]["note"] == "x"
    assert (tmp_path / "run" / "tb").is_dir()
    log = setup_logging(tmp_path / "logs")
    log.info("hello")
    for h in log.handlers:
        h.flush()
    assert "hello" in (tmp_path / "logs" / "train.log").read_text()
    for h in list(log.handlers):
        if getattr(h, "baseFilename", "").startswith(str(tmp_path)):
            log.removeHandler(h)
            h.close()


def test_profiling_helpers_on_cpu(tmp_path):
    """trace writes a Chrome trace, carrying the program's spans."""
    from graphqembed_tpu_torch.training.profiling import span, trace

    with trace(tmp_path / "prof"):
        with span("gqe.operators", structure="2i"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    text = (tmp_path / "prof" / "trace.json").read_text()
    assert '"gqe.operators structure=2i"' in text
