"""The JAX package's native sampler library, built once for the port's tests.

The JAX binding compiles `libgqe_sampler.so` in place next to its source and
loads any such file newer than the source, so a process that loads it while
another is still writing it can load a truncated library. The port's tests
that call the JAX sampler run beside the JAX package's own under
pytest-xdist, so they build it here first: under a file lock in the
repository's `build/`, with the JAX binding's g++ flags, into a temporary
file that is renamed into place. The JAX binding then finds the library up
to date and only loads it.
"""

import fcntl
import os
import subprocess
from pathlib import Path

from graphqembed_tpu.native import binding as jax_binding
from graphqembed_tpu_torch.native import binding

LOCK = Path(__file__).resolve().parents[1] / "build" / "jax_sampler.lock"


def load_jax_native():
    """Build (if stale) and load the JAX package's sampler library in this
    process; returns the ctypes library."""
    LOCK.parent.mkdir(parents=True, exist_ok=True)
    so, src = jax_binding._SO, jax_binding._DIR / "sampler.cpp"
    with open(LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (so.exists() and so.stat().st_mtime >= src.stat().st_mtime):
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            subprocess.run([binding._require_gxx(), *binding.GXX_FLAGS,
                            str(src), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, so)
        lib = jax_binding._load()
    assert lib is not None, "the JAX package's native sampler did not load"
    return lib
