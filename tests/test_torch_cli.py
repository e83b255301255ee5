"""The port's CLIs (graphqembed_tpu_torch.cli.train and .evaluate) on the
CPU (--cpu): the JAX CLI's flags, defaults and refusals, the unported
option (--mesh N > 1) refused naming its ROADMAP item, runs of the
pipelines on a data directory written by the port's loader, SIGKILL and --resume as
tests/test_fault_injection.py does for the JAX CLI, and gqe-torch-eval
reproducing metrics.json (same parameters, seed and device: within
1e-6)."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from graphqembed_tpu.cli.train import build_parser as jax_build_parser
from graphqembed_tpu.cli.train import dispatch_steps_per as jax_dispatch_steps_per
from graphqembed_tpu_torch.cli import evaluate
from graphqembed_tpu_torch.cli.train import build_parser, dispatch_steps_per, main
from graphqembed_tpu_torch.config import STRUCTURES
from graphqembed_tpu_torch.data.loader import export_reference_pickle, save_queries
from graphqembed_tpu_torch.data.sampling import QuerySampler
from graphqembed_tpu_torch.graph.synthetic import synthetic_graph

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--embed_dim", "16", "--batch_size", "16", "--cpu"]


@pytest.fixture(autouse=True)
def one_thread():
    """Eager PyTorch at these widths is launch-bound: one intra-op thread
    per test process keeps it fast when other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """A graph pickle and train/val query sets written by the port."""
    out = tmp_path_factory.mktemp("ds")
    g = synthetic_graph(seed=0, scale=0.2, avg_degree=8.0)
    s = QuerySampler(g, np.random.default_rng(0), max_negs=10)
    train, val = [], []
    for st in STRUCTURES:
        qs = s.sample_many(st, 70)
        train += qs[:60]
        val += qs[60:]
    export_reference_pickle(g, out / "graph_data.pkl")
    save_queries(out / "train_queries", g.schema, train)
    save_queries(out / "val_queries", g.schema, val)
    return out


def test_dispatch_steps_per_matches_jax():
    cases = {10_000_000: 100, 2000: 100, 1999: 99, 300: 15, 20: 1, 1: 1}
    for m, want in cases.items():
        assert dispatch_steps_per(m) == jax_dispatch_steps_per(m) == want
    for m in (1, 7, 19, 300, 1999, 2000, 10**6, *range(0, 5000, 37)):
        assert dispatch_steps_per(m) == jax_dispatch_steps_per(m)


def test_parser_keeps_every_jax_flag_and_default():
    ours = {a.dest: a for a in build_parser()._actions}
    for a in jax_build_parser()._actions:
        assert a.dest in ours, a.dest
        b = ours[a.dest]
        assert (b.default, b.choices, b.type, b.option_strings) == \
            (a.default, a.choices, a.type, a.option_strings), a.dest


def test_bf16_flags_reach_config(tmp_path):
    md = tmp_path / "run"
    rc = main(["--synthetic", "--synthetic_scale", "0.3", "--n_train_queries",
               "60", "--n_val_queries", "20", *SMALL, "--max_iter", "40",
               "--max_burn_in", "10", "--val_every", "20", "--pipeline",
               "device", "--bf16", "--model_dir", str(md)])
    assert rc == 0
    cfg = json.loads((md / "config.json").read_text())
    assert cfg["storage_dtype"] == "bfloat16"
    assert cfg["compute_dtype"] == "bfloat16"
    metrics = json.loads((md / "metrics.json").read_text())
    assert metrics["steps"] >= 40
    assert {"final_auc", "final_auc_hard", "final_apr"} <= set(metrics)
    assert (md / "best" / "meta.json").exists()
    assert (md / "metrics.jsonl").read_text().strip()


def test_storage_bf16_rejected_on_host_pipeline():
    with pytest.raises(SystemExit, match="stochastic-rounding"):
        main(["--synthetic", "--pipeline", "host", "--storage_dtype",
              "bfloat16", "--cpu"])


def test_opt_flag(tmp_path, data_dir):
    """--opt sgd reaches the device pipeline; sgd with bf16 storage is
    refused (the SR kernel is an Adam update)."""
    md = tmp_path / "run"
    rc = main(["--data_dir", str(data_dir), *SMALL, "--max_iter", "30",
               "--max_burn_in", "10", "--val_every", "1000", "--pipeline",
               "device", "--opt", "sgd", "--model_dir", str(md)])
    assert rc == 0
    assert json.loads((md / "metrics.json").read_text())["steps"] >= 30
    with pytest.raises(SystemExit, match="adam"):
        main(["--synthetic", "--pipeline", "device", "--storage_dtype",
              "bfloat16", "--opt", "sgd", "--cpu"])


@pytest.mark.parametrize("flags,item", [
    (["--mesh", "2", "--pipeline", "stream"],
     "needs --pipeline device or onthefly"),
    (["--mesh", "2", "--pipeline", "device", "--bf16"],
     "requires --storage_dtype float32"),
    (["--mesh", "3", "--pipeline", "onthefly"],
     "--mesh 3 must divide --batch_size 512"),
    (["--mesh", "4", "--pipeline", "host"],
     "needs --pipeline device or onthefly"),
])
def test_unported_options_exit_naming_their_roadmap_item(tmp_path, flags, item):
    """--mesh N > 1 follows the JAX CLI's rules and messages: the device or
    onthefly pipeline, float32 storage, N dividing the batch; a refused run
    writes nothing. (The mesh runs themselves:
    tests/test_torch_sharded_trainer.py.)"""
    with pytest.raises(SystemExit, match=item):
        main(["--synthetic", "--cpu", "--model_dir", str(tmp_path), *flags])
    assert not (tmp_path / "config.json").exists()


def _cmd(model_dir, data_dir, pipeline, extra=()):
    # --tol=-1e9 turns convergence stopping off: both sessions run to
    # max_iter whatever the loss does
    return [sys.executable, "-m", "graphqembed_tpu_torch.cli.train",
            "--data_dir", str(data_dir), "--model_dir", str(model_dir),
            "--embed_dim", "16", "--batch_size", "32", "--max_iter", "300",
            "--max_burn_in", "50", "--val_every", "100000", "--tol=-1e9",
            "--decoder", "transe", "--ckpt_every", "50", "--cpu",
            "--pipeline", pipeline, *extra]


@pytest.mark.parametrize("pipeline", ["host", "device", "stream", "onthefly"])
def test_kill_and_resume(data_dir, tmp_path, pipeline):
    """SIGKILL the CLI once a checkpoint's meta.json exists, rerun it with
    --resume: it completes from the checkpoint, not from scratch."""
    model_dir = tmp_path / "run"
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(_cmd(model_dir, data_dir, pipeline), env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    ckpt_root = model_dir / "ckpts"
    deadline = time.time() + 180
    killed = False
    while time.time() < deadline:
        if proc.poll() is not None:
            break   # finished before it could be killed: resume still runs
        if ckpt_root.exists() and any(ckpt_root.glob("step_*/meta.json")):
            proc.send_signal(signal.SIGKILL)
            proc.wait()
            killed = True
            break
        time.sleep(0.05)
    assert killed or proc.poll() == 0, "training never checkpointed"
    before = sorted(int(d.name[5:]) for d in ckpt_root.glob("step_*")
                    if (d / "meta.json").exists())
    assert before, "no checkpoint written before the kill"

    out = subprocess.run(_cmd(model_dir, data_dir, pipeline, ("--resume",)),
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    metrics = json.loads((model_dir / "metrics.json").read_text())
    assert metrics["steps"] >= 300
    assert len(list(ckpt_root.glob("step_*"))) <= 3
    if pipeline != "host":
        # this session's steps only: the steps after the restored checkpoint
        assert metrics["timings"]["session_steps"] == metrics["steps"] - before[-1]


def test_onthefly_pipeline_writes_metrics(tmp_path, data_dir):
    """--pipeline onthefly samples every batch on the device (here the
    CPU): no training queries are read, all 7 structures train, and the
    run writes metrics.json and the best parameters."""
    md = tmp_path / "run"
    rc = main(["--data_dir", str(data_dir), *SMALL, "--max_iter", "280",
               "--max_burn_in", "70", "--val_every", "100", "--pipeline",
               "onthefly", "--bf16", "--neighbor_samples", "4", "--tol=-1e9",
               "--model_dir", str(md)])
    assert rc == 0
    metrics = json.loads((md / "metrics.json").read_text())
    assert metrics["steps"] == 280 and metrics["burn_in_steps"] == 70
    assert metrics["timings"]["session_steps"] == 280
    assert {"final_auc", "final_auc_hard", "final_apr"} <= set(metrics)
    assert set(metrics["final_auc"]) == set(STRUCTURES) | {"macro"}
    assert (md / "best" / "meta.json").exists()
    logged = {k for line in (md / "metrics.jsonl").read_text().splitlines()
              for k in json.loads(line) if k.startswith("loss/")}
    assert logged == {f"loss/{s}" for s in STRUCTURES}


@pytest.mark.parametrize("depth", [0, 1])
def test_stream_pipeline_trains(tmp_path, data_dir, depth):
    """--pipeline stream reads the train shards through device windows
    (here on the CPU), with --bf16 and at depth 1: every structure trains,
    and the run writes metrics.json, its timings and the best parameters."""
    md = tmp_path / "run"
    rc = main(["--data_dir", str(data_dir), *SMALL, "--max_iter", "160",
               "--max_burn_in", "20", "--val_every", "80", "--pipeline",
               "stream", "--bf16", "--tol=-1e9", "--depth", str(depth),
               "--neighbor_samples", "4", "--model_dir", str(md)])
    assert rc == 0
    metrics = json.loads((md / "metrics.json").read_text())
    assert metrics["steps"] == 160 and metrics["burn_in_steps"] == 20
    t = metrics["timings"]
    assert t["session_steps"] == 160 and "window_wait_s" in t
    assert {"final_auc", "final_auc_hard", "final_apr"} <= set(metrics)
    assert set(metrics["final_auc"]) == set(STRUCTURES) | {"macro"}
    assert json.loads((md / "config.json").read_text())["storage_dtype"] == "bfloat16"
    assert (md / "best" / "meta.json").exists()


def test_stream_pipeline_needs_data_dir(tmp_path):
    with pytest.raises(SystemExit, match="--pipeline stream needs --data_dir"):
        main(["--synthetic", "--cpu", "--pipeline", "stream", "--model_dir",
              str(tmp_path)])
    assert not (tmp_path / "config.json").exists()


def test_eval_cli_reproduces_metrics_json(tmp_path, data_dir, capsys):
    md = tmp_path / "run"
    assert main(["--data_dir", str(data_dir), *SMALL, "--max_iter", "60",
                 "--max_burn_in", "20", "--val_every", "30", "--pipeline",
                 "device", "--model_dir", str(md)]) == 0
    capsys.readouterr()
    assert evaluate.main(["--model_dir", str(md), "--data_dir", str(data_dir),
                          "--split", "val_queries", "--cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    want = json.loads((md / "metrics.json").read_text())
    for ours, theirs in (("auc", "final_auc"), ("auc_hard", "final_auc_hard"),
                         ("apr", "final_apr")):
        assert set(got[ours]) == set(want[theirs])
        for k, v in want[theirs].items():
            assert abs(got[ours][k] - v) <= 1e-6, (ours, k)
    assert got["step"] == want["steps"]
