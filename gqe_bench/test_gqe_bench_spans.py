"""The program's spans in a traced slice (`spans.py`) on synthetic events,
with and without the kind of each event (not every PyTorch gives it), and
the row counter's reader on a tiny traced run on the CPU.

    python -m pytest gqe_bench/ -q
"""

import importlib
from types import SimpleNamespace

import pytest
import torch

from gqe_bench import data, harness, spans
from gqe_bench.test_gqe_bench_harness import run_tiny

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _ev(name, a, b, kind, *, tid=1, corr=0, linked=0, seq=-1, fwd=0,
        annotation=False):
    e = SimpleNamespace(
        name=lambda: name, start_ns=lambda: a, duration_ns=lambda: b - a,
        device_type=lambda: CUDA if kind in (
            "kernel", "gpu_memcpy", "gpu_user_annotation") else CPU,
        correlation_id=lambda: corr, linked_correlation_id=lambda: linked,
        start_thread_id=lambda: tid, sequence_nr=lambda: seq,
        fwd_thread_id=lambda: fwd, is_user_annotation=lambda: annotation)
    e.kind = kind
    return e


def _round(kinds: bool) -> list:
    """One dispatch of one 2i step on two host threads (1: the program, 2:
    the autograd engine's device thread) and its device intervals; times in
    ns, the window 10..1100 between the device synchronisations that fence
    the round (the profiler's own comes after)."""
    evs = [
        _ev("cudaDeviceSynchronize", 0, 10, "cuda_runtime"),
        _ev("gqe.dispatch structure=2i steps=1", 20, 1000, "cpu_op"),
        _ev("gqe.sample", 30, 100, "cpu_op"),
        _ev("aten::randint", 35, 60, "cpu_op", corr=1),
        _ev("cudaLaunchKernel", 40, 50, "cuda_runtime", corr=101, linked=1),
        # the ids' cat shares the gather's sequence number: made no node
        _ev("aten::cat", 104, 108, "cpu_op", corr=3, seq=5),
        _ev("gqe.encode", 110, 200, "cpu_op"),
        _ev("_TakeRows", 120, 150, "cpu_op", corr=2, seq=5),
        _ev("cudaLaunchKernel", 125, 130, "cuda_runtime", corr=102, linked=2),
        _ev("gqe.operators", 210, 300, "cpu_op"),
        _ev("aten::mm", 220, 260, "cpu_op", corr=4, seq=6),
        _ev("cudaLaunchKernel", 230, 235, "cuda_runtime", corr=104, linked=4),
        _ev("gqe.backward", 310, 800, "cpu_op"),
        _ev("gqe.optimizer", 810, 900, "cpu_op"),
        _ev("aten::_foreach_add_", 820, 850, "cpu_op", corr=5),
        _ev("cudaLaunchKernel", 825, 830, "cuda_runtime", corr=105, linked=5),
        _ev("aten::item", 1003, 1012, "cpu_op", corr=6),
        _ev("cudaMemcpyAsync", 1006, 1008, "cuda_runtime", corr=109,
            linked=6),
        _ev("cudaDeviceSynchronize", 1050, 1100, "cuda_runtime"),
        _ev("cudaDeviceSynchronize", 1200, 1210, "cuda_runtime"),
        # the engine's thread
        _ev("autograd::engine::evaluate_function: MmBackward0", 320, 400,
            "cpu_op", tid=2, corr=7, seq=6, fwd=1),
        _ev("cudaLaunchKernel", 330, 335, "cuda_runtime", tid=2, corr=106,
            linked=7),
        _ev("autograd::engine::evaluate_function: _TakeRowsBackward", 410,
            500, "cpu_op", tid=2, corr=8, seq=5, fwd=1),
        _ev("cudaLaunchKernel", 420, 425, "cuda_runtime", tid=2, corr=107,
            linked=8),
        _ev("autograd::engine::evaluate_function: AccumulateGrad", 510, 600,
            "cpu_op", tid=2, corr=9),
        _ev("cudaLaunchKernel", 520, 525, "cuda_runtime", tid=2, corr=108,
            linked=9),
        # the device
        _ev("randint_kernel", 60, 90, "kernel", corr=101, linked=1),
        _ev("gather_kernel", 140, 180, "kernel", corr=102, linked=2),
        _ev("gqe.encode", 140, 200, "gpu_user_annotation", annotation=True),
        _ev("gemm", 240, 290, "kernel", corr=104, linked=4),
        # launched by cuLaunchKernel: no runtime call, the op's link only
        _ev("cutlass_gemm", 290, 300, "kernel", corr=999, linked=4),
        _ev("gemm_bwd", 340, 380, "kernel", corr=106, linked=7),
        _ev("scatter_rows_kernel", 430, 480, "kernel", corr=107, linked=8),
        _ev("add_kernel", 530, 560, "kernel", corr=108, linked=9),
        _ev("adam_f32_kernel", 835, 870, "kernel", corr=105, linked=5),
        _ev("Memcpy DtoH", 1020, 1030, "gpu_memcpy", corr=109, linked=6),
    ]
    for e in evs:
        if kinds:
            e.activity_type = (lambda k: lambda: k)(e.kind)
    return evs


@pytest.mark.parametrize("kinds", [True, False])
def test_every_interval_goes_to_one_span(kinds):
    out = spans.reduce(_round(kinds))
    got = {n: (r["intervals"], round(r["device_s"] * 1e9))
           for n, r in out["spans"].items() if r["intervals"]}
    assert got == {"gqe.sample": (1, 30),
                   # the gather, and its backward by the engine's link
                   "gqe.encode": (2, 90),
                   # the product, the one cuLaunchKernel launched, and
                   # the product's backward
                   "gqe.operators": (3, 100),
                   # the engine's work with no link
                   "gqe.backward": (1, 30),
                   "gqe.optimizer": (1, 35),
                   spans.OUTSIDE: (1, 10)}
    assert out["steps"] == 1
    assert set(out["by_structure"]) == {"2i"}
    assert out["by_structure"]["2i"]["gqe.encode"]["intervals"] == 2


@pytest.mark.parametrize("kinds", [True, False])
def test_idle_by_span_sums_to_the_idle_time(kinds):
    out = spans.reduce(_round(kinds))
    # the annotation's copy on the device is no work: 295 ns busy
    assert round(out["window_s"] * 1e9) == 1090
    assert round(out["busy_s"] * 1e9) == 295
    idle = {n: round(r["idle_s"] * 1e9) for n, r in out["spans"].items()
            if r["idle_s"]}
    assert idle == {"gqe.sample": 50, "gqe.encode": 50, "gqe.operators": 60,
                    "gqe.backward": 40 + 50 + 50 + 275, "gqe.dispatch": 150,
                    spans.OUTSIDE: 70}
    assert sum(r["idle_s"] for r in out["spans"].values()) == \
        pytest.approx(out["idle_s"])
    # without the fences, the window runs from the first event to the last
    out = spans.reduce([e for e in _round(kinds)
                        if e.name() != "cudaDeviceSynchronize"])
    assert round(out["window_s"] * 1e9) == 1030 - 20
    assert sum(r["idle_s"] for r in out["spans"].values()) == \
        pytest.approx(out["idle_s"]) == pytest.approx((1010 - 295) * 1e-9)


def test_host_time_is_each_span_less_the_spans_inside_it():
    out = spans.reduce(_round(True))
    host = {n: round(r["host_s"] * 1e9) for n, r in out["spans"].items()}
    assert host["gqe.dispatch"] == 980 - (70 + 90 + 90 + 490 + 90)
    assert host["gqe.backward"] == 490
    assert host[spans.OUTSIDE] == 1090 - 980


def test_parse_reads_a_spans_attributes():
    assert spans.parse("gqe.dispatch structure=ip steps=100") == (
        "gqe.dispatch", {"structure": "ip", "steps": "100"})
    assert spans.parse("gqe.encode") == ("gqe.encode", {})


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setattr(data, "CACHE_DIR", tmp_path)


def _reader():
    return harness.load_metric("valid_row_share.train")


def test_row_share_reader_reads_nothing_without_the_counter(monkeypatch):
    from graphqembed_tpu_torch.training import profiling

    profiling.counters()
    ctx = {"kind": "train", "slice": {"busy_s": 0.0}}
    assert _reader().read(ctx) is None            # nothing counted
    assert _reader().read({"kind": "train"}) is None
    monkeypatch.delattr(profiling, "counters")
    importlib.invalidate_caches()
    assert _reader().read(ctx) is None            # a program without it


@pytest.mark.parametrize("name", ["bio-d128.train-onthefly",
                                  "bio-sage2.train-onthefly"])
def test_tiny_traced_run_reads_the_row_share(name, cache):
    result, checks = run_tiny(name, True)
    share = result["metrics"]["valid_row_share.train"]
    assert share["unit"] == "%" and 0 < share["value"] <= 100
