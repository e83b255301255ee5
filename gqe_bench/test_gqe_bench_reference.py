"""The benchmark's reference and counters against the port's CPU path at a
tiny size, and the control: the reference in the precision below the
configuration's fails the limits that the program passes.

    python -m pytest gqe_bench/ -q
"""

import json

import numpy as np
import pytest
import torch

from gqe_bench import data, harness, peaks
from gqe_bench.reference import gqe_ref

GRAPH = {"generator": "bio", "seed": 0, "scale": 1.0, "avg_degree": 6,
         "sampler_sample_size": 4}
# Larger, so that a plain negative answers a branch by chance less often: the
# hard negatives' and the control's tests.
SPARSE = dict(GRAPH, scale=8.0)
STRUCTURES = ("1p", "2p", "3p", "2i", "3i", "ip", "pi")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def cache(tmp_path, monkeypatch):
    monkeypatch.setattr(data, "CACHE_DIR", tmp_path)


def model(depth=0, d=16):
    m = harness.load_json("configs", "gqe-bio-d128")["model"]
    return dict(m, embed_dim=d, depth=depth)


def port_graph(graph=GRAPH):
    from graphqembed_tpu_torch.graph.synthetic import synthetic_graph

    return synthetic_graph(seed=graph["seed"], scale=graph["scale"],
                           avg_degree=graph["avg_degree"])


def test_graph_equals_the_ports_generator():
    g = port_graph()
    ref = data.RefGraph.load(GRAPH)
    assert g.schema.relations == ref.layout.relations
    assert g.schema.modes == ref.layout.modes
    n = ref.n
    keys = [(ref.layout.rel_id(r) * n + s) * n + d
            for r in g.schema.relations for s, ds in g.adj[r].items()
            for d in ds]
    assert np.array_equal(np.sort(np.asarray(keys, np.int64)), ref.keys)


def test_neighbor_tables_equal_the_ports():
    from graphqembed_tpu_torch.models.encoders import NeighborTables

    port = NeighborTables.build(port_graph(), sample_size=5, seed=0)
    ref = data.ref_neighbor_tables(GRAPH, 5, 0)["neighbors"]
    assert np.array_equal(port.neighbors.astype(np.int64), ref)


def _batch(structure, n, seed, n_steps=1, graph=GRAPH):
    """The [n_steps, n, ...] batches of one call of the port's on-device
    sampler, on the CPU."""
    from graphqembed_tpu_torch.config import GQEConfig
    from graphqembed_tpu_torch.training.device_sampler import (
        DeviceGraph,
        sample_dispatch,
        torch_draw,
    )

    cfg = GQEConfig(embed_dim=16, batch_size=n)
    dg = DeviceGraph.build(port_graph(graph), sample_size=4, device="cpu")
    g = torch.Generator().manual_seed(seed)
    return sample_dispatch(cfg, dg, torch_draw(g), structure, n_steps,
                           structure in ("2i", "3i", "ip", "pi"))


@pytest.mark.parametrize("structure", ["1p", "2p", "2i", "3i", "ip", "pi"])
def test_sampled_queries_hold_against_the_graph(structure):
    ref = data.RefGraph.load(GRAPH)
    arrays = ref.layout.arrays()
    b = {k: v[0].numpy() for k, v in _batch(structure, 256, 3).items()}
    assert b["mask"].sum() > 100
    assert gqe_ref.invalid_rows(ref, arrays, structure, b) == 0
    bad = dict(b, targets=(b["targets"] + 1) % ref.n)
    assert gqe_ref.invalid_rows(ref, arrays, structure, bad) > 0


@pytest.mark.parametrize("structure", ["2i", "3i", "ip", "pi"])
def test_hard_negatives_answer_a_branch(structure):
    """The port's second step of a call takes the partial-branch hard
    negative: it misses every branch of the query far less often than the
    first step's plain negative, or than the hard one shifted by one."""
    ref = data.RefGraph.load(SPARSE)
    arrays = ref.layout.arrays()
    both = _batch(structure, 512, 5, n_steps=2, graph=SPARSE)
    miss = []
    for t in (0, 1):
        b = {k: v[t].numpy() for k, v in both.items()}
        assert gqe_ref.invalid_rows(ref, arrays, structure, b) == 0
        a, r, _, neg, _ = gqe_ref.valid_rows(b)
        for c in ((neg,) if t == 0 else (neg, (neg + 1) % ref.n)):
            miss.append(1 - gqe_ref.branch_answers(ref, arrays, structure,
                                                   a, r, c).mean())
    plain, hard, moved = miss
    assert hard < 0.25 * plain and hard < 0.25 * moved, miss


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("structure", STRUCTURES)
def test_loss_and_gradient_equal_the_ports(structure, depth):
    from graphqembed_tpu_torch.config import GQEConfig
    from graphqembed_tpu_torch.models import gqe
    from graphqembed_tpu_torch.models.encoders import (
        NeighborTables,
        make_deep_encoder,
    )

    m = model(depth)
    lay = data.layout_of(GRAPH)
    flat = harness.init_params(m, lay.n_nodes, len(lay.relations),
                               len(lay.modes), 5, torch.device("cpu"))
    batch = {k: v[0] for k, v in _batch(structure, 64, 4).items()}
    cfg = GQEConfig(**m, batch_size=64)
    tree = harness.nest(flat)
    enc_fn = None
    nbrs = None
    if depth:
        tables = NeighborTables.build(port_graph(), sample_size=3).to("cpu")
        enc_fn = make_deep_encoder(cfg, tree, tables, depth)
        nbrs = torch.as_tensor(data.ref_neighbor_tables(GRAPH, 3)["neighbors"])
    loss = gqe.margin_loss_rows_onegather(
        cfg, tree, structure, batch["anchors"], batch["rels"],
        batch["inter_modes"], batch["targets"], batch["negs"], batch["mask"],
        encode_fn=enc_fn)
    g_port = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in flat.items()}
    enc = gqe_ref.Encoder(lay.arrays(), depth, nbrs)
    ref = gqe_ref.margin_loss(p, enc, structure, batch, m["margin"], 1.0)
    g_ref = torch.autograd.grad(ref, list(p.values()), allow_unused=True)
    assert abs(float(loss) - float(ref)) <= 1e-5 * abs(float(ref))
    for k, a, b in zip(flat, g_port, g_ref):
        a = torch.zeros_like(flat[k]) if a is None else a
        b = torch.zeros_like(flat[k]) if b is None else b
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-6 * float(
            b.abs().max() + 1e-30)), k


def test_flop_and_byte_counters_against_hand_counts():
    mfu = harness.load_metric("train_mfu")
    grad = harness.load_metric("table_grad_roofline")
    d = 128
    # 1p: one projection, 3 normalized nodes, the query's scoring
    assert mfu.query_flops("1p", d) == 2 * d * d + 3 * 3 * d + 7 * d
    # 3i: three projections, three pre-transforms, one post-transform
    assert mfu.query_flops("3i", d) == 7 * 2 * d * d + 5 * 3 * d + 7 * d
    # depth 1, one relation a node, 2 neighbours: W_self, mean, W_rel
    one = 2 * d * d + (2 * 3 * d + 2 * d + 2 * d * d) + 6 * d
    assert mfu.encode_flops(d, 1, 1.0, 2) == one
    assert peaks.adam_bytes(10) == 280
    assert peaks.scatter_cost(100, 7, 4, 4) == ((100 + 7) * 16 + 56, 28)
    ctx = {"model": {"embed_dim": 4, "depth": 2}, "batch_size": 2,
           "n_nodes": 100, "mode_rels": [1, 3], "neighbor_samples": 2}
    ids = 2 * (3 + 2)
    want = sum(peaks.scatter_cost(100, ids * 6 ** i, 4, 4)[0]
               for i in range(3))
    assert grad.step_bytes(ctx, "3i") == want


def test_control_fails_the_limits_the_program_passes():
    """The control (TF32 operands) and the half-batch fault, in the
    program's place, fail a training cell's limits, and so do the sampler's
    faults and the stale step count planted in the program; the program
    passes."""
    from gqe_bench import train_cell as tc

    cfg = harness.load_json("configs", "gqe-bio-d128")
    cfg["graph"] = SPARSE
    cfg["model"]["embed_dim"] = 32
    traffic = dict(harness.load_json("traffic", "train-onthefly-b65536"),
                   batch_size=128, check_rows=128)
    limits = harness.load_json("limits", "bio-d128.train-onthefly")
    dev = torch.device("cpu")
    seed = 2**33 + 1
    prog = tc.Program(cfg, traffic, dev, log=lambda m: None)
    checked = tc.check_steps(prog, seed)
    checked.pop("live")
    graph = data.RefGraph.load(SPARSE)
    enc, found, steps = tc.reference_side(cfg, traffic, checked, seed, dev,
                                          graph)
    p0, n = checked["p0"], tc.lengths_of(checked)
    assert n == [1, 2, 2, 2] and len(steps) == 7
    ref = tc.reference_train(enc, steps, p0, cfg["model"])
    sound = dict(tc.compare(checked, ref, p0, n), **found, loss_finite=0)
    assert harness.passed(harness.judge(sound, limits)), sound
    with gqe_ref.control():
        ctl = tc.reference_train(enc, steps, p0, cfg["model"])
    half = tc.reference_train(enc, steps, p0, cfg["model"], drop_half=True)
    for fault in (ctl, half):
        r = dict(tc.compare(tc.as_program(fault, p0, n), ref, p0, n),
                 **found, loss_finite=0)
        assert not harness.passed(harness.judge(r, limits)), r
    for name, r in tc.sampler_faults(prog, checked, graph, seed).items():
        r = dict(tc.compare(checked, ref, p0, n), **r, loss_finite=0)
        assert not harness.passed(harness.judge(r, limits)), (name, r)
    with tc.planted("stale_count"):
        stale = tc.check_steps(prog, seed)
    r = dict(tc.compare(stale, ref, p0, n), **found, loss_finite=0)
    assert not harness.passed(harness.judge(r, limits)), r
