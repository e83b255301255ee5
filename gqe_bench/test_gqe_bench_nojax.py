"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the reference loads nothing of the port. Each check runs in
a fresh interpreter, so that nothing this test process imported counts.

    python -m pytest gqe_bench/ -q
"""

import json
import subprocess
import sys

from gqe_bench.data import ROOT

RUN_CELLS = r"""
import json, sys, tempfile
from pathlib import Path
import torch
torch.set_num_threads(1)
from gqe_bench import data, harness
data.CACHE_DIR = Path(tempfile.mkdtemp())
sys.path.insert(0, "gqe_bench")
from test_gqe_bench_harness import run_tiny, WORKLOADS
from gqe_bench.reference import gqe_ref
for name in WORKLOADS:
    run_tiny(name)
print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))
"""

REFERENCE_ONLY = r"""
import json, sys
from gqe_bench.reference import gqe_ref
from gqe_bench import data, peaks
print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))
"""


def _top_level(code: str) -> set:
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600,
                       env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
                            "OMP_NUM_THREADS": "1"})
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.splitlines()[-1]))


def test_cells_load_no_jax():
    mods = _top_level(RUN_CELLS)
    assert "graphqembed_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "graphqembed_tpu"}


def test_reference_loads_nothing_of_the_program():
    mods = _top_level(REFERENCE_ONLY)
    assert "torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "graphqembed_tpu",
                       "graphqembed_tpu_torch"}
