"""ctypes binding and build of the native C++ bulk query sampler
(`sampler.cpp`, a plain C interface).

The library is compiled with g++ at first use, never at import, into
`build/libgqe_sampler-<hash>.so` at the repository root: the hash covers the
source, the flags and the target options that `-march=native` resolves to on
this host, so an edit of either rebuilds, and a library built for one CPU is
never loaded on a host with other instructions. The compiler writes a
temporary file that is then renamed into place, so processes that build at
the same time never load a half-written library. A failed build raises with
g++'s output; `native_available()` is False only when no g++ is found.

The sampler's RNG is `std::mt19937_64` with integer draws and its output
order comes from vectors, so a seed gives the same queries on any host, and
the same as the JAX package's copy of this source.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from graphqembed_tpu_torch.config import STRUCTURES
from graphqembed_tpu_torch.data.queries import Formula, Query
from graphqembed_tpu_torch.graph.graph import Graph

SOURCE = Path(__file__).resolve().parent / "sampler.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_LIB = None
_LOCK = threading.Lock()


def _gxx() -> str | None:
    return shutil.which("g++")


def _require_gxx() -> str:
    gxx = _gxx()
    if gxx is None:
        raise RuntimeError("g++ not found: the native sampler cannot be built")
    return gxx


@functools.lru_cache(maxsize=None)
def _host_target(gxx: str) -> str:
    """g++'s target options under -march=native on this host: the CPU it
    resolves to and every instruction set it enables."""
    return subprocess.run([gxx, "-march=native", "-Q", "--help=target"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout


def lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(_host_target(_require_gxx()).encode())
    return BUILD_DIR / f"libgqe_sampler-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the sampler unless an up-to-date library exists; returns its
    path. Raises if g++ is missing or fails."""
    out = lib_path()
    if out.exists():
        return out
    gxx = _require_gxx()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    r = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE}:\n{r.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build()))
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.gqe_sample_queries.restype = ctypes.c_int
        lib.gqe_sample_queries.argtypes = [
            ctypes.c_int, i32p, i32p,                      # modes
            ctypes.c_int, i32p, i32p, i32p, i64p, i64p, i32p, i32p,  # rels+CSR
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64,   # structure, n, seed
            ctypes.c_int, ctypes.c_int, ctypes.c_int,      # max_negs, tries, exh
            i32p, i32p, i32p, i32p, i32p, i32p, i32p,      # outputs
        ]
        lib.gqe_sample_clean_queries.restype = ctypes.c_int
        lib.gqe_sample_clean_queries.argtypes = [
            ctypes.c_int, i32p, i32p,                      # modes
            ctypes.c_int, i32p, i32p, i32p, i64p, i64p, i32p, i32p,  # rels+CSR
            i64p, i64p, i32p, i32p,                        # train CSR
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64,   # structure, n, seed
            ctypes.c_int, ctypes.c_int, ctypes.c_int,      # max_negs, tries, exh
            i32p, i32p, i32p, i32p, i32p, i32p, i32p,      # outputs
        ]
        lib.gqe_all_edges_1p.restype = ctypes.c_int
        lib.gqe_all_edges_1p.argtypes = [
            ctypes.c_int, i32p, i32p,                      # modes
            ctypes.c_int, i32p, i32p, i32p, i64p, i64p, i32p, i32p,  # rels+CSR
            ctypes.c_int64, ctypes.c_uint64, ctypes.c_int,  # cap, seed, max_negs
            ctypes.c_int,                                   # n_threads
            i32p, i32p, i32p, i32p, i32p,                  # outputs
        ]
        _LIB = lib
        return lib


def native_available() -> bool:
    """Whether the native sampler can be used here: a g++ is on the PATH.
    The library itself is built (or its build fails loudly) at first use."""
    return _gxx() is not None


class _GraphArrays:
    """Flattened CSR encoding of a Graph for the C ABI (cached per graph)."""

    def __init__(self, graph: Graph):
        schema = graph.schema
        self.schema = schema
        self.mode_lo = np.array(
            [schema.mode_range(m)[0] for m in schema.modes], np.int32)
        self.mode_hi = np.array(
            [schema.mode_range(m)[1] for m in schema.modes], np.int32)
        self.rel_from = np.array(
            [schema.mode_id(r[0]) for r in schema.relations], np.int32)
        self.rel_to = np.array(
            [schema.mode_id(r[2]) for r in schema.relations], np.int32)
        self.rel_rev = np.array(
            [schema.reverse_rel_id(i) for i in range(schema.n_relations)],
            np.int32)
        indptrs, indices = [], []
        ip_off, ix_off = [], []
        for r in schema.relations:
            ip, ix = graph.csr(r)
            ip_off.append(sum(len(x) for x in indptrs))
            ix_off.append(sum(len(x) for x in indices))
            indptrs.append(ip.astype(np.int32))
            indices.append(ix.astype(np.int32))
        self.indptr_off = np.array(ip_off, np.int64)
        self.indices_off = np.array(ix_off, np.int64)
        self.indptr_cat = np.concatenate(indptrs).astype(np.int32)
        self.indices_cat = (np.concatenate(indices).astype(np.int32)
                            if any(len(x) for x in indices)
                            else np.zeros(1, np.int32))


def _graph_arrays(graph: Graph) -> _GraphArrays:
    ga = getattr(graph, "_native_arrays", None)
    if ga is None:
        ga = _GraphArrays(graph)
        graph._native_arrays = ga
    return ga


def _exhaustive_width(schema) -> int:
    tmodes = {f[2] for f in schema.relations}
    return max(schema.mode_counts[m] for m in tmodes)


def _outputs(n: int, max_negs: int) -> list[np.ndarray]:
    """Output buffers, zeroed: the negative pools' padding past each row's
    count holds zeros, not whatever memory held (so pools built from them
    are the same from run to run)."""
    return [np.zeros((n, 3), np.int32), np.zeros((n, 3), np.int32),
            np.zeros(n, np.int32), np.zeros((n, max_negs), np.int32),
            np.zeros(n, np.int32), np.zeros((n, max_negs), np.int32),
            np.zeros(n, np.int32)]


def _as_dict(structure: str, outs: list[np.ndarray], got: int) -> dict:
    keys = ("rels", "anchors", "targets", "negs", "neg_counts", "hard",
            "hard_counts")
    return {"structure": structure, **{k: o[:got] for k, o in zip(keys, outs)}}


def native_sample_arrays(graph: Graph, structure: str, n: int, seed: int = 0,
                         max_negs: int = 100, exhaustive_negs: bool = False,
                         max_tries: int = 200) -> dict:
    """Raw-array sampling for bulk pipelines (feeds device_pool_from_arrays
    directly, no Query objects): a dict of numpy arrays truncated to the
    sampled count. The GIL is released during the C call, so calls on
    several threads run in parallel."""
    lib = _load()
    ga = _graph_arrays(graph)
    schema = graph.schema
    if exhaustive_negs:
        max_negs = _exhaustive_width(schema)
    outs = _outputs(n, max_negs)
    got = lib.gqe_sample_queries(
        len(schema.modes), ga.mode_lo, ga.mode_hi,
        schema.n_relations, ga.rel_from, ga.rel_to, ga.rel_rev,
        ga.indptr_off, ga.indices_off, ga.indptr_cat, ga.indices_cat,
        STRUCTURES.index(structure), n, seed, max_negs, max_tries,
        int(exhaustive_negs), *outs)
    return _as_dict(structure, outs, got)


def native_sample_clean_arrays(graph: Graph, train_graph: Graph,
                               structure: str, n: int, seed: int = 0,
                               max_negs: int = 100,
                               exhaustive_negs: bool = False,
                               max_tries: int = 200) -> dict:
    """Clean-test sampling: walks the FULL graph, keeps only queries
    unanswerable on `train_graph` (at least one held-out edge), negatives and
    hard negatives computed on the full graph; the C++ twin of
    QuerySampler.sample(train_graph=...). Returns the native_sample_arrays
    dict."""
    lib = _load()
    ga = _graph_arrays(graph)
    ta = _graph_arrays(train_graph)
    schema = graph.schema
    if exhaustive_negs:
        max_negs = _exhaustive_width(schema)
    outs = _outputs(n, max_negs)
    got = lib.gqe_sample_clean_queries(
        len(schema.modes), ga.mode_lo, ga.mode_hi,
        schema.n_relations, ga.rel_from, ga.rel_to, ga.rel_rev,
        ga.indptr_off, ga.indices_off, ga.indptr_cat, ga.indices_cat,
        ta.indptr_off, ta.indices_off, ta.indptr_cat, ta.indices_cat,
        STRUCTURES.index(structure), n, seed, max_negs, max_tries,
        int(exhaustive_negs), *outs)
    return _as_dict(structure, outs, got)


def native_all_edges_1p(graph: Graph, cap: int | None = None, seed: int = 0,
                        max_negs: int = 16, n_threads: int | None = None
                        ) -> dict:
    """EVERY edge as a 1p query with exact negatives (one pass over the CSR);
    above `cap` edges, a uniform ~cap subsample. Returns a
    native_sample_arrays dict (no hard pools: 1p has none). Full-coverage
    builds run on `n_threads` C++ threads (default: all cores) writing
    disjoint output slices; deterministic for a fixed (seed, n_threads)."""
    lib = _load()
    ga = _graph_arrays(graph)
    schema = graph.schema
    n_edges = graph.num_edges()
    cap = int(min(cap or n_edges, n_edges))
    out_rels = np.full((cap, 3), -1, np.int32)
    out_anchors = np.full((cap, 3), -1, np.int32)
    out_targets = np.zeros(cap, np.int32)
    out_negs = np.zeros((cap, max_negs), np.int32)
    out_negc = np.zeros(cap, np.int32)
    got = lib.gqe_all_edges_1p(
        len(schema.modes), ga.mode_lo, ga.mode_hi,
        schema.n_relations, ga.rel_from, ga.rel_to, ga.rel_rev,
        ga.indptr_off, ga.indices_off, ga.indptr_cat, ga.indices_cat,
        cap, seed, max_negs, int(n_threads or os.cpu_count() or 1),
        out_rels, out_anchors, out_targets, out_negs, out_negc)
    return {
        "structure": "1p",
        "rels": out_rels[:got],
        "anchors": out_anchors[:got],
        "targets": out_targets[:got],
        "negs": out_negs[:got],
        "neg_counts": out_negc[:got],
        "hard": np.zeros((got, max_negs), np.int32),
        "hard_counts": np.zeros(got, np.int32),
    }


def _arrays_to_queries(schema, structure: str, arrays: dict) -> list[Query]:
    """native_sample_arrays dict -> Query objects (sorted negative pools)."""
    queries: list[Query] = []
    negc = arrays["neg_counts"]
    hardc = arrays["hard_counts"]
    for i in range(len(arrays["targets"])):
        rels = tuple(schema.rel_of(int(r)) for r in arrays["rels"][i]
                     if r >= 0)
        anchors = tuple(int(a) for a in arrays["anchors"][i] if a >= 0)
        hard = None
        if hardc[i] > 0:
            hard = np.sort(arrays["hard"][i, :hardc[i]].astype(np.int64))
        queries.append(Query(
            Formula(structure, rels), anchors, int(arrays["targets"][i]),
            np.sort(arrays["negs"][i, :negc[i]].astype(np.int64)), hard))
    return queries


def native_sample_many(graph: Graph, structure: str, n: int, seed: int = 0,
                       max_negs: int = 100, exhaustive_negs: bool = False,
                       max_tries: int = 200) -> list[Query]:
    """The C++ bulk sampler as Query objects. Same semantics as
    QuerySampler.sample_many, another RNG stream."""
    arrays = native_sample_arrays(graph, structure, n, seed=seed,
                                  max_negs=max_negs,
                                  exhaustive_negs=exhaustive_negs,
                                  max_tries=max_tries)
    return _arrays_to_queries(graph.schema, structure, arrays)


def native_sample_clean_many(graph: Graph, train_graph: Graph,
                             structure: str, n: int, seed: int = 0,
                             max_negs: int = 100,
                             exhaustive_negs: bool = False,
                             max_tries: int = 200) -> list[Query]:
    """The C++ clean-test sampler (see native_sample_clean_arrays) as Query
    objects whose answers need a held-out edge; the Python twin is
    QuerySampler.sample_many(train_graph=...)."""
    arrays = native_sample_clean_arrays(graph, train_graph, structure, n,
                                        seed=seed, max_negs=max_negs,
                                        exhaustive_negs=exhaustive_negs,
                                        max_tries=max_tries)
    return _arrays_to_queries(graph.schema, structure, arrays)
