"""The harness: files found by name, the result line, the runs' refusals,
the trace reduction, and whole tiny runs on the CPU, sound and with the
timed path broken underneath (each must then read `correct` false).

    python -m pytest gqe_bench/ -q
"""

import json
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from gqe_bench import data, harness, train_cell, trace
from gqe_bench.data import BENCH_DIR, ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
TINY_GRAPH = {"generator": "bio", "seed": 0, "scale": 8.0, "avg_degree": 6,
              "sampler_sample_size": 4}
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def cache(tmp_path, monkeypatch):
    monkeypatch.setattr(data, "CACHE_DIR", tmp_path)


WORKLOADS = [w["name"] for w in MANIFEST["workloads"]]


def tiny(name: str) -> harness.Cell:
    """A cell at a CPU test's size: the same model but d = 32, a 7,040-node
    graph, small batches; its real limits."""
    cell = harness.Cell(name)
    cfg = dict(cell.config, graph=TINY_GRAPH,
               model=dict(cell.config["model"], embed_dim=32))
    tr = dict(cell.traffic, batch_size=64, dispatch_steps=2, check_rows=64)
    if cfg["model"]["depth"]:
        tr["structures"] = ["1p", "ip"]
    return harness.Cell.of(name, cfg, tr, cell.limits,
                           cell.end_to_end, cell.per_layer)


def run_tiny(name: str, trace_on: bool = False):
    cell = tiny(name)
    return harness.driver(cell).run(cell, 2**31 + 11, 0.05, trace_on,
                                    torch.device("cpu"), 0.0,
                                    log=lambda m: None)


@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_files_are_found_by_name(name):
    cell = harness.Cell(name)
    assert harness.driver(cell).__name__ == "gqe_bench.train_cell"
    assert set(cell.limits) and all(v >= 0 for v in cell.limits.values())
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    e2e = {m["name"] for m in cell.end_to_end}
    for m in cell.per_layer:
        mod = harness.load_metric(m["name"])
        assert mod.UNIT == m["unit"] and callable(mod.read)
        assert m["moves"] in e2e


def test_manifest_names_its_files():
    for c in MANIFEST["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("name", WORKLOADS)
@pytest.mark.parametrize("trace_on", [False, True])
def test_sound_tiny_run_is_correct_and_well_formed(name, trace_on, capsys):
    result, checks = run_tiny(name, trace_on)
    harness.emit(result, checks)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(line)
    assert list(out)[-1] == "checks"
    assert set(out) == KEYS | ({"breakdown"} if trace_on else set())
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    cell = harness.Cell(name)
    want = {m["name"] for m in (cell.per_layer if trace_on
                                else cell.end_to_end)}
    assert set(out["metrics"]) <= want
    if not trace_on:
        assert set(out["metrics"]) == want
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        out["device"])


def _fault_state_unchanged(monkeypatch):
    from graphqembed_tpu_torch.training import device_data

    monkeypatch.setattr(device_data.FusedAdamOpt, "apply",
                        lambda self, params, grads, state: (params, state))


def _fault_half_batch(monkeypatch):
    from graphqembed_tpu_torch.models import gqe

    real = gqe._masked_margin

    def half(cfg, pos, neg, row_mask, denom=None):
        keep = torch.arange(row_mask.shape[0]) < row_mask.shape[0] // 2
        return real(cfg, pos, neg, row_mask & keep, denom)

    monkeypatch.setattr(gqe, "_masked_margin", half)


def _fault_stale_count(monkeypatch):
    from graphqembed_tpu_torch.training import device_sampler

    monkeypatch.setattr(device_sampler, "_scan", train_cell._stale_count_scan)


def _fault_hard_off(monkeypatch):
    from graphqembed_tpu_torch.training import device_sampler

    monkeypatch.setattr(device_sampler, "_hard_step", lambda cfg, t: t < 0)


def _fault_hard_always(monkeypatch):
    from graphqembed_tpu_torch.training import device_sampler

    monkeypatch.setattr(device_sampler, "_hard_step", lambda cfg, t: t >= 0)


def _fault_negative_is_target(monkeypatch):
    from graphqembed_tpu_torch.training import device_sampler

    real = device_sampler.sample_dispatch

    def altered(*a):
        b = real(*a)
        return dict(b, negs=b["targets"].clone())

    monkeypatch.setattr(device_sampler, "sample_dispatch", altered)


@pytest.mark.parametrize("name", WORKLOADS)
@pytest.mark.parametrize("fault", [
    _fault_state_unchanged, _fault_half_batch, _fault_stale_count,
    _fault_hard_off, _fault_hard_always, _fault_negative_is_target])
def test_broken_timed_path_reads_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    result, checks = run_tiny(name)
    assert result["correct"] is False, checks
    assert result["failed"] > 0


def _run_script(cwd, *args):
    return subprocess.run(
        [sys.executable, "gqe_bench/run.py", "--workload", WORKLOADS[0],
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0", *args],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run_script(ROOT)
    assert p.returncode != 0 and not p.stdout.strip()


def test_run_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "gqe_bench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    p = _run_script(tmp_path)
    assert p.returncode != 0 and not p.stdout.strip()


def _ev(name, start, dur, kind, device):
    dt = torch.autograd.DeviceType
    return SimpleNamespace(
        name=lambda: name, start_ns=lambda: start, duration_ns=lambda: dur,
        activity_type=lambda: kind,
        device_type=lambda: dt.CUDA if device else dt.CPU)


def test_trace_reduction_counts_busy_time_and_gaps():
    evs = [_ev("k1", 0, 100, "kernel", True),
           _ev("k2", 50, 100, "kernel", True),
           _ev("Memcpy HtoD", 400, 100, "gpu_memcpy", True),
           _ev("k1", 1000, 50, "kernel", True),
           _ev("aten::mm", 120, 900, "cpu_op", False),
           _ev("aten::add", 600, 10, "cpu_op", False)]
    out = trace.reduce_events(evs)
    assert out["busy_s"] == pytest.approx(300e-9)
    assert [n for n, _ in out["kernels"]] == ["k1", "k2", "k1"]
    assert out["idle_gaps"][0] == ["aten::mm", pytest.approx(500e-9)]
    assert out["idle_gaps"][1] == ["aten::mm", pytest.approx(250e-9)]
    assert out["device_ops"][0] == ["k1", pytest.approx(150e-9)]
    assert trace.kernel_seconds(out, ["k1"]) == (pytest.approx(150e-9), 2)


def test_cells_on_the_card():
    """Each cell once, briefly, through the command (on a card only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in WORKLOADS:
        p = subprocess.run(
            [sys.executable, "gqe_bench/run.py", "--workload", name,
             "--seed", "2147483659", "--seconds", "2", "--trace", "1"],
            cwd=ROOT, capture_output=True, text=True, timeout=1200)
        assert p.returncode == 0, p.stderr[-3000:]
        assert json.loads(p.stdout.splitlines()[-1])["correct"] is True
