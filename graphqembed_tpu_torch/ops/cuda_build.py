"""Build the port's CUDA sources into shared libraries with a plain C
interface, at first use, and load them with ctypes.

Each source under `graphqembed_tpu_torch/csrc/` becomes
`build/lib<name>-<hash>.so` at the repository root (the hash covers the
source and its flags, so an edit of either rebuilds). `build_kernels()`
starts one `nvcc` per source, all at once, and waits for them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
# name -> (source, nvcc flags of its own). fused_adam.cu takes -fmad=false:
# no fused multiply-adds, so its kernels round each operation as the plain
# PyTorch versions do and agree with them bit for bit. kernels.cu is held to
# its plain versions with tolerances (its sums run in another order anyway),
# so it keeps nvcc's contractions.
SOURCES = {
    "gqe_fused_adam": (CSRC / "fused_adam.cu", ("-fmad=false",)),
    "gqe_kernels": (CSRC / "kernels.cu", ()),
}

# No fast math for any source: IEEE sqrtf and division.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def nvcc_flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + SOURCES[name][1]


def lib_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name][0].read_bytes())
    h.update(" ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_kernels(names=None) -> dict:
    """Compile every named source (default: all) that has no up-to-date
    library yet, one nvcc each, in parallel. Returns
    {"seconds": wall time, "logs": {name: nvcc output}}; raises if a build
    fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *nvcc_flags(name), "-o", str(tmp), str(SOURCES[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return {"seconds": time.perf_counter() - t0, "logs": logs}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build_kernels([name])
        lib = _LOADED[name] = ctypes.CDLL(str(path))
    return lib


def launch(counts: dict, name: str, fn, *args, device) -> None:
    """Call the C entry point `fn(*args, stream)` on `device`'s current
    stream; raise if it returns a CUDA error, else add one to counts[name]."""
    import torch

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    counts[name] += 1
