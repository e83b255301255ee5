"""The port's spans and row counter (training/profiling.py) on the CPU:
off, a span is one shared null context and the counter counts nothing;
under the profiler, an on-the-fly dispatch records the seven `gqe.*`
spans, nested as the module says, and the counter counts n_steps × B
rows drawn and the row mask's own sum valid, adding no operation; the
autograd engine's backward functions link to the forward operations of
the encoder and the operators by `sequence_nr`."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from graphqembed_tpu_torch.config import GQEConfig
from graphqembed_tpu_torch.graph.synthetic import synthetic_graph
from graphqembed_tpu_torch.models import encoders
from graphqembed_tpu_torch.models.params import init_params
from graphqembed_tpu_torch.training import device_data as tdd
from graphqembed_tpu_torch.training import device_sampler as tds
from graphqembed_tpu_torch.training import profiling

STEP_SPANS = ("gqe.encode", "gqe.operators", "gqe.score", "gqe.backward",
              "gqe.optimizer")
BACKWARD = "autograd::engine::evaluate_function: "


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.counters()
    yield
    profiling.counters()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graph():
    g = synthetic_graph(seed=7, scale=0.5, avg_degree=6.0)
    return g, tds.DeviceGraph.build(g, sample_size=8, seed=0, device="cpu")


def _dispatch(graph, structure="2i", n_steps=2, depth=0, seed=3):
    """(run the dispatch, the generator state it draws from): one call of
    the on-the-fly step on fresh parameters."""
    g, dg = graph
    cfg = GQEConfig(embed_dim=16, batch_size=32, depth=depth)
    opt = tdd.default_optimizer(cfg)
    tables = (encoders.NeighborTables.build(g, sample_size=4) if depth
              else None)
    step = tds.make_onthefly_train_step(cfg, opt, dg, neighbor_tables=tables)
    params = init_params(cfg, g.schema, device="cpu")
    gen = tdd.derived_generator("cpu", seed, 0)
    state = gen.get_state()

    def run():
        return step(params, opt.init(params), structure, gen, n_steps, 1.0,
                    True)

    return cfg, run, state


def _events(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof.profiler.kineto_results.events()


def _spans(events):
    return [e for e in events if e.name().startswith("gqe.")]


def _inside(inner, outer):
    return (outer.start_thread_id() == inner.start_thread_id()
            and outer.start_ns() <= inner.start_ns()
            and inner.start_ns() + inner.duration_ns()
            <= outer.start_ns() + outer.duration_ns())


def test_off_a_span_is_one_null_context_and_nothing_is_counted(graph):
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("gqe.a") is profiling.span("gqe.b", steps=3)
    _, run, _ = _dispatch(graph)
    run()
    assert profiling.counters() == {"rows_drawn": 0, "rows_valid": 0,
                                    "scatter_runs_split": 0}


def test_a_dispatch_records_the_seven_spans_nested(graph):
    _, run, _ = _dispatch(graph, "2i", n_steps=3)
    spans = _spans(_events(run))
    names = [e.name().split(" ")[0] for e in spans]
    assert set(names) == {"gqe.dispatch", "gqe.sample", *STEP_SPANS}
    (dispatch,) = [e for e in spans if e.name().startswith("gqe.dispatch")]
    assert dispatch.name() == "gqe.dispatch structure=2i steps=3"
    for e in spans:
        assert e is dispatch or _inside(e, dispatch), e.name()
    # per step one of each, in order and apart; the sampler once, first
    for name in STEP_SPANS:
        assert names.count(name) == 3
    assert names.count("gqe.sample") == 1
    steps = sorted((e for e in spans if e.name() in STEP_SPANS),
                   key=lambda e: e.start_ns())
    assert [e.name() for e in steps] == list(STEP_SPANS) * 3
    for a, b in zip(steps, steps[1:]):
        assert a.start_ns() + a.duration_ns() <= b.start_ns()
    (sample,) = [e for e in spans if e.name() == "gqe.sample"]
    assert sample.start_ns() + sample.duration_ns() <= steps[0].start_ns()
    # a range of the operators' kind: no annotation copied to the device
    assert not any(e.is_user_annotation() for e in spans)


def test_counters_count_drawn_and_valid_rows_with_no_extra_op(graph,
                                                             monkeypatch):
    cfg, run, state = _dispatch(graph, "pi", n_steps=3)
    counted = [e.name() for e in _events(run)]
    rows = profiling.counters()
    gen = torch.Generator().set_state(state)
    mask = tds.sample_dispatch(cfg, graph[1], tds.torch_draw(gen), "pi", 3,
                               True)["mask"]
    # on the CPU take_rows' backward is the plain version: no split runs
    assert rows == {"rows_drawn": 3 * 32, "rows_valid": int(mask.sum()),
                    "scatter_runs_split": 0}
    assert 0 < rows["rows_valid"] < rows["rows_drawn"]
    assert profiling.counters() == {"rows_drawn": 0, "rows_valid": 0,
                                    "scatter_runs_split": 0}
    # the same dispatch with the counter taken out runs the same operations
    _, run, _ = _dispatch(graph, "pi", n_steps=3)
    monkeypatch.setattr(profiling, "count_rows", lambda n, valid: None)
    assert [e.name() for e in _events(run)] == counted


@pytest.mark.parametrize("depth", [0, 1])
def test_backward_functions_link_to_the_forward_ops_of_their_span(graph,
                                                                  depth):
    """Each backward function's `sequence_nr` and `fwd_thread_id` name the
    last forward operation to start with that number on that thread, and it
    lies in the span whose work it differentiates: the table gather's in
    gqe.encode (at depth 1 the SAGE encoder's products too), the operators'
    products in gqe.operators."""
    _, run, _ = _dispatch(graph, "2i", n_steps=1, depth=depth)
    events = _events(run)
    spans = _spans(events)
    forward = {}
    for e in events:
        key = (e.start_thread_id(), e.sequence_nr())
        if key[1] >= 0 and e.fwd_thread_id() == 0 and (
                key not in forward
                or e.start_ns() >= forward[key].start_ns()):
            forward[key] = e
    linked = {}
    for e in events:
        if e.name().startswith(BACKWARD) and e.sequence_nr() >= 0:
            fwd = forward[(e.fwd_thread_id(), e.sequence_nr())]
            inner = min((s for s in spans if _inside(fwd, s)),
                        key=lambda s: s.duration_ns())
            linked.setdefault(inner.name().split(" ")[0], set()).add(
                e.name()[len(BACKWARD):])
    assert "_TakeRowsBackward" in linked["gqe.encode"]
    assert "_TakeRowsBackward" not in linked["gqe.operators"]
    assert linked["gqe.operators"] & {"BmmBackward0", "MmBackward0"}
    if depth:
        assert linked["gqe.encode"] & {"BmmBackward0", "MmBackward0"}
    assert set(linked) <= {"gqe.dispatch", "gqe.encode", "gqe.operators",
                           "gqe.score"}
