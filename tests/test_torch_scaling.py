"""The port's scaling harness (graphqembed_tpu_torch/cli/scaling.py,
`gqe-torch-scaling`) on gloo ranks of this CPU, against the JAX package's
`cli/scaling.py`: `measure` and `measure_full_protocol` at 1 and 2 ranks
return JAX's keys (each run at one device of JAX's CPU mesh on the same
tiny data), `main` prints one JSON line per mesh size with JAX's
efficiency, and refuses to run without a card unless asked for the CPU.
The numbers are the harness's, not the hardware's: the ranks share this
host's cores."""

import json

import jax
import numpy as np
import pytest
import torch

from graphqembed_tpu.cli import scaling as jax_scaling
from graphqembed_tpu.config import GQEConfig as JaxConfig
from graphqembed_tpu.data.sampling import QuerySampler as JaxSampler
from graphqembed_tpu.graph.synthetic import synthetic_graph as jax_graph
from graphqembed_tpu_torch.cli import scaling
from graphqembed_tpu_torch.config import GQEConfig
from graphqembed_tpu_torch.data.sampling import QuerySampler
from graphqembed_tpu_torch.graph.synthetic import synthetic_graph

TINY = dict(embed_dim=16, projection="bilinear", batch_size=32, val_every=20)
GRAPH = dict(seed=0, scale=0.3, avg_degree=8.0)
STEPS = 8
FLAGS = ["--scale", "0.3", "--batch_size", "32", "--embed_dim", "16",
         "--n_queries", "60", "--steps", str(STEPS)]


def _data(graph, sampler_cls, full: bool):
    """JAX main's data at a tiny size: 2p + 3i (+ 1p and the val set)."""
    s = sampler_cls(graph, np.random.default_rng(0), max_negs=20)
    queries = s.sample_many("2p", 60) + s.sample_many("3i", 60)
    val = None
    if full:
        queries += s.sample_many("1p", 60)
        sv = sampler_cls(graph, np.random.default_rng(1), max_negs=20)
        val = sv.sample_many("1p", 20) + sv.sample_many("3i", 20)
    return queries, val


@pytest.fixture(scope="module")
def jax_keys():
    """The keys of JAX's measure and measure_full_protocol, from a run of
    each at one device of its CPU mesh. measure_full_protocol's own
    persistent-cache settings are skipped, so the test run's own cache
    (the conftest's) stays in place."""
    cfg = JaxConfig(**TINY)
    graph = jax_graph(**GRAPH)
    queries, _ = _data(graph, JaxSampler, False)
    raw = jax_scaling.measure(1, cfg, graph, queries, n_steps=STEPS)
    queries, val = _data(graph, JaxSampler, True)
    update = jax.config.update

    def keep_cache(name, value):
        if not name.startswith(("jax_compilation_cache", "jax_persistent_cache")):
            update(name, value)

    jax.config.update = keep_cache
    try:
        full = jax_scaling.measure_full_protocol(
            1, cfg, graph, queries, val, total_steps=STEPS,
            burn_in=max(10, STEPS // 4))
    finally:
        jax.config.update = update
    return {"raw": set(raw), "full": set(full)}


@pytest.fixture(scope="module")
def port_runs():
    cfg = GQEConfig(**TINY)
    graph = synthetic_graph(**GRAPH)
    raw_q, _ = _data(graph, QuerySampler, False)
    full_q, val = _data(graph, QuerySampler, True)
    return {n: {"raw": scaling.measure(n, cfg, graph, raw_q, n_steps=STEPS,
                                       device="cpu"),
                "full": scaling.measure_full_protocol(
                    n, cfg, graph, full_q, val, total_steps=STEPS,
                    burn_in=max(10, STEPS // 4), device="cpu")}
            for n in (1, 2)}


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("mode", ["raw", "full"])
def test_measure_returns_jax_keys(jax_keys, port_runs, n, mode):
    got = port_runs[n][mode]
    assert set(got) == jax_keys[mode]
    assert got["devices"] == n
    assert got["queries_per_sec"] > 0
    # edges/s is q/s times the mean edges per query of the structures run
    epq = got["edges_per_sec"] / got["queries_per_sec"]
    assert epq == pytest.approx(4.5 if mode == "raw" else 4.0, rel=1e-3)
    if mode == "full":
        assert got["mode"] == "full_protocol"
        assert got["steps"] >= STEPS and np.isfinite(got["val_auc"])


def test_main_prints_one_line_per_size_with_jax_efficiency(capsys):
    assert scaling.main(["--cpu", "--ranks", "2", *FLAGS]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["devices"] for r in rows] == [1, 2]
    base = rows[0]["edges_per_sec"]
    for r in rows:
        assert r["efficiency_vs_1dev"] == round(
            r["edges_per_sec"] / (base * r["devices"]), 3)
    assert rows[0]["efficiency_vs_1dev"] == 1.0


def test_main_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        scaling.main(FLAGS)
    with pytest.raises(SystemExit):   # --ranks sizes the CPU mesh only
        scaling.main(["--ranks", "2", *FLAGS])


def test_flags_and_defaults_are_jax_s():
    """Both parsers see the same flags and defaults (the port adds --cpu
    and --ranks)."""
    import argparse

    def parser_of(main):
        got = {}

        def capture(self, args=None, namespace=None):
            got.update(vars(parse(self, [], namespace)))
            raise SystemExit(0)

        parse = argparse.ArgumentParser.parse_args
        argparse.ArgumentParser.parse_args = capture
        try:
            with pytest.raises(SystemExit):
                main([])
        finally:
            argparse.ArgumentParser.parse_args = parse
        return got

    jax_defaults = parser_of(jax_scaling.main)
    port_defaults = parser_of(scaling.main)
    assert {k: v for k, v in port_defaults.items()
            if k not in ("cpu", "ranks")} == jax_defaults
    assert jax_defaults == {"scale": 4.0, "batch_size": 512, "embed_dim": 128,
                            "n_queries": 800, "steps": 60, "full": False}
