"""Boundaries of the port package (graphqembed_tpu_torch) and chip_smoke.py:
they import neither JAX (nor grain, whose import loads it) nor anything of
the JAX package; entry points run
on the card unless the caller asks for the CPU; chip_smoke.py refuses to
run without a card or outside the repository."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, importlib.abc, importlib.util, pkgutil, sys

BANNED = ("jax", "jaxlib", "optax", "grain", "graphqembed_tpu")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("refused import of " + name)
        return None

sys.meta_path.insert(0, Refuse())
import graphqembed_tpu_torch
names = [m.name for m in pkgutil.walk_packages(graphqembed_tpu_torch.__path__,
                                                "graphqembed_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
print(len(names), loaded)
"""


def _run(args, cwd, env_extra=None, timeout=240):
    env = dict(os.environ, PYTHONPATH=REPO if cwd == REPO else "")
    env.pop("JAX_PLATFORMS", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_and_chip_smoke_import_no_jax():
    r = _run(["-c", _IMPORT_ALL], REPO)
    assert r.returncode == 0, r.stderr
    n, loaded = r.stdout.split(" ", 1)
    assert int(n) >= 15, r.stdout
    assert loaded.strip() == "[]", r.stdout


_REFUSE_SITE = r"""
import importlib.abc, sys

BANNED = ("jax", "jaxlib", "optax", "grain", "graphqembed_tpu")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("refused import of " + name)
        return None

sys.meta_path.insert(0, Refuse())
"""

_MESH_RUN = r"""
import sys
import torch_mesh_workers as workers
from graphqembed_tpu_torch.parallel import spawn_on_mesh

if __name__ == "__main__":
    got = spawn_on_mesh(workers.run_cases, 2, {"probe": ("case_import_probe",)},
                        device="cpu", timeout=120)["probe"]
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "optax", "grain",
                                           "graphqembed_tpu"))
    print(got["banned"], loaded, got["jax_refused"], got["count"])
"""


def test_spawned_mesh_ranks_import_no_jax(tmp_path):
    """A 2-rank gloo run of the sharded step (parallel/) with an import hook
    refusing JAX and the JAX package in the parent and in every spawned
    rank (a sitecustomize on PYTHONPATH): it trains, and no process loads
    them."""
    (tmp_path / "sitecustomize.py").write_text(_REFUSE_SITE)
    path = os.pathsep.join([str(tmp_path), REPO, os.path.join(REPO, "tests")])
    r = _run(["-c", _MESH_RUN], REPO, {"PYTHONPATH": path})
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["[]", "[]", "True", "3"], r.stdout


_TP_RUN = r"""
import sys
from graphqembed_tpu_torch.cli import scaling
from graphqembed_tpu_torch.entry import dryrun_multichip, entry
from graphqembed_tpu_torch.parallel import tp  # noqa: F401

if __name__ == "__main__":
    entry(device="cpu")
    got = dryrun_multichip(4, device="cpu", timeout=120)
    scaling.main(["--cpu", "--ranks", "2", "--scale", "0.3", "--batch_size",
                  "32", "--embed_dim", "16", "--n_queries", "40", "--steps",
                  "4"])
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "optax", "grain",
                                           "graphqembed_tpu"))
    print("RESULT", loaded, got["tp"]["shape"])
"""


def test_tp_scaling_and_entry_import_no_jax(tmp_path):
    """The modules of the tensor-parallel slice (parallel/tp.py,
    cli/scaling.py, entry.py) under the refusing import hook in the parent
    and in every spawned rank: dryrun_multichip(4) with its (2, 2) TP step
    and gqe-torch-scaling on 2 gloo ranks run, and no process loads JAX or
    the JAX package."""
    (tmp_path / "sitecustomize.py").write_text(_REFUSE_SITE)
    path = os.pathsep.join([str(tmp_path), REPO])
    r = _run(["-c", _TP_RUN], REPO, {"PYTHONPATH": path})
    assert r.returncode == 0, r.stderr
    result = [line for line in r.stdout.splitlines()
              if line.startswith("RESULT")]
    assert result == ["RESULT [] (2, 2)"], r.stdout


def test_no_source_file_names_the_jax_package():
    pkg = os.path.join(REPO, "graphqembed_tpu_torch")
    offenders = []
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith((".py", ".cu")):
                text = open(os.path.join(root, f)).read()
                for line in text.splitlines():
                    s = line.strip()
                    if s.startswith(("import ", "from ")) and (
                            "graphqembed_tpu " in s + " " or "graphqembed_tpu." in s
                            or " jax" in s or " optax" in s):
                        offenders.append((f, s))
    assert offenders == []


def test_entry_points_need_a_card_unless_asked_for_cpu(graph):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from graphqembed_tpu_torch.config import GQEConfig
    from graphqembed_tpu_torch.data.sampling import QuerySampler
    from graphqembed_tpu_torch.models.params import init_params, params_from_jax
    from graphqembed_tpu_torch.training.device_data import DevicePool, DeviceTrainData

    cfg = GQEConfig(embed_dim=8)
    queries = QuerySampler(graph, np.random.default_rng(0)).sample_many("2p", 5)
    calls = [
        lambda **kw: init_params(cfg, graph.schema, **kw),
        lambda **kw: params_from_jax({"table": np.zeros((3, 2), np.float32)}, **kw),
        lambda **kw: DevicePool(graph.schema, "2p", queries, **kw),
        lambda **kw: DeviceTrainData(graph.schema, queries, **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(device="cuda")
        call(device="cpu")

    # the training drivers: parameters placed on the CPU run only when the
    # caller names the CPU
    from graphqembed_tpu_torch.training import run_train
    from graphqembed_tpu_torch.training.device_data import run_train_device_mega

    cfg = GQEConfig(embed_dim=8, batch_size=4, max_iter=2, max_burn_in=1,
                    val_every=10**9)
    data = DeviceTrainData(graph.schema, queries, device="cpu")
    drivers = [
        lambda **kw: run_train(cfg, graph.schema,
                               init_params(cfg, graph.schema, device="cpu"),
                               queries, **kw),
        lambda **kw: run_train_device_mega(
            cfg, graph.schema, init_params(cfg, graph.schema, device="cpu"),
            data, steps_per=1, **kw),
    ]
    for call in drivers:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        assert call(device="cpu").steps >= 2

    # the CLIs: no quiet CPU run without --cpu
    from graphqembed_tpu_torch.cli import evaluate, train

    with pytest.raises(SystemExit, match="no CUDA device"):
        train.main(["--synthetic", "--synthetic_scale", "0.1"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        evaluate.main(["--model_dir", "m", "--data_dir", "d"])


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run(["chip_smoke.py"], REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_alone_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_library_hash_covers_each_sources_own_flags(monkeypatch):
    """Each CUDA source carries its own nvcc flags (fused_adam.cu keeps
    -fmad=false for bit-exactness; kernels.cu does not), and the built
    library's name changes when they do, so a flag change rebuilds."""
    from graphqembed_tpu_torch.ops import cuda_build

    assert "-fmad=false" in cuda_build.nvcc_flags("gqe_fused_adam")
    assert "-fmad=false" not in cuda_build.nvcc_flags("gqe_kernels")
    before = {n: cuda_build.lib_path(n) for n in cuda_build.SOURCES}
    assert len(set(before.values())) == len(before)
    src, flags = cuda_build.SOURCES["gqe_kernels"]
    monkeypatch.setitem(cuda_build.SOURCES, "gqe_kernels", (src, flags + ("-lineinfo",)))
    assert cuda_build.lib_path("gqe_kernels") != before["gqe_kernels"]
    assert cuda_build.lib_path("gqe_fused_adam") == before["gqe_fused_adam"]
