"""The mesh: one process per rank in a `torch.distributed` process group,
the batch split over the ranks and the packed embedding table row-sharded
over the same axis, 'data'; on a 2-D ('data', 'model') mesh
(`make_mesh_2d`) the operator stacks are also split over 'model' (tensor
parallelism, parallel/tp.py).

The JAX package (its `parallel/mesh.py`) has one process own every device
and places arrays with `NamedSharding`; GSPMD then inserts the collectives.
Here each rank holds its own rows of the table and a copy of every other
leaf, and the train step (parallel/train_step.py) calls the collectives
itself, on detached tensors, outside autograd. NCCL on cards (rank r on
`cuda:r`), gloo on the CPU.

- `Sharding` describes a placement, as `NamedSharding` does: `("data",
  None)` is rows over 'data', `()` replicated, `(None, None, "model")`
  the last dim over 'model' (`table_sharding`, `replicated`,
  `batch_sharding`, `param_shardings`);
- `pad_table_rows`, `shard_params`, `gather_table`, `shard_tree` /
  `unshard_tree` (checkpoints hold whole, unpadded arrays),
  `unshard_model` (TP leaves made whole) and `mesh_consistent` place
  parameters and state;
- `spawn_on_mesh(fn, n, *args)` starts n ranks on this host and returns
  rank 0's result: the launcher that stands for JAX's one process owning
  n devices.

Every collective adds one to its count in COLLECTIVES under its axis
(`reset_collective_counts`, `collective_counts(axis)`): 'data' counts the
data group's collectives and the whole mesh's broadcasts and barriers (on
a 1-D mesh one and the same group), 'model' the model group's.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

from graphqembed_tpu_torch.device import resolve_device
from graphqembed_tpu_torch.models.params import tree_paths

AXIS = "data"

MODEL = "model"

COLLECTIVES = {AXIS: {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0,
                      "broadcast": 0, "barrier": 0},
               MODEL: {"all_gather": 0, "all_reduce": 0}}


def reset_collective_counts() -> None:
    for counts in COLLECTIVES.values():
        for k in counts:
            counts[k] = 0


def collective_counts(axis: str = AXIS) -> dict:
    return dict(COLLECTIVES[axis])


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh of ranks: the whole mesh's process group (None: the default
    group), this process's rank in it and its size, and the rank's device.

    A 1-D mesh (`make_mesh`, or `Mesh(group, rank, size, device)`) has the
    one axis 'data', whose group is the whole group. A 2-D mesh
    (`make_mesh_2d`) has axes ('data', 'model') of sizes `shape`; rank r
    sits at `coords` (r // n_model, r % n_model), as JAX reshapes its
    devices, and holds its model column's 'data' group and its data row's
    'model' group."""
    group: object
    rank: int
    size: int
    device: torch.device
    axis: str = AXIS
    axis_names: tuple = ()
    shape: tuple = ()
    coords: tuple = ()
    data_group: object = None
    model_group: object = None

    def __post_init__(self):
        if not self.axis_names:   # 1-D: the whole group is the data group
            for k, v in (("axis_names", (self.axis,)), ("shape", (self.size,)),
                         ("coords", (self.rank,)),
                         ("data_group", self.group)):
                object.__setattr__(self, k, v)

    @property
    def n_data(self) -> int:
        return self.shape[0]

    @property
    def data_index(self) -> int:
        return self.coords[0]


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tensor lives on a mesh: spec[i] is the mesh axis its dim i
    is split over (None: whole), as a JAX PartitionSpec; () replicated."""
    mesh: Mesh
    spec: tuple


def _rank_device(device, rank: int) -> torch.device:
    """device None means this rank's card (`cuda:<rank>`, made the current
    device), and raises without one; "cpu" for gloo ranks."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    return dev


def make_mesh(n: int | None = None, device=None) -> Mesh | None:
    """A mesh over the first n ranks of the initialized default process
    group (all of them when n is None), as JAX's make_mesh takes the first
    n devices. device None means this rank's card (`cuda:<rank>`, made the
    current device), and raises without one; "cpu" for gloo ranks. Every
    rank of the default group must call it (new_group is collective); a
    rank outside the first n gets None."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(spawn_on_mesh starts one)")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n is None else n
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a group of {world}")
    group = None if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        return None
    return Mesh(group, rank, n, _rank_device(device, rank))


def make_mesh_2d(n_data: int, n_model: int, device=None) -> Mesh | None:
    """A ('data', 'model') mesh over the first n_data·n_model ranks of the
    initialized default group (JAX's make_mesh_2d): rank r at data index
    r // n_model and model index r % n_model. Its 'model' groups are the
    data rows, its 'data' groups the model columns. device as make_mesh.
    Every rank of the default group must call it: it makes every group
    (new_group is collective, so every rank makes each one, in one order);
    a rank outside the mesh gets None."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh_2d needs an initialized process group "
                           "(spawn_on_mesh starts one)")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = n_data * n_model
    if n_data < 1 or n_model < 1 or n > world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh in a group of {world}")

    def group(ranks):
        return None if ranks == list(range(world)) else dist.new_group(ranks)

    whole = group(list(range(n)))
    rows = [group([i * n_model + j for j in range(n_model)])
            for i in range(n_data)]
    cols = [group([i * n_model + j for i in range(n_data)])
            for j in range(n_model)]
    if rank >= n:
        return None
    i, j = divmod(rank, n_model)
    return Mesh(whole, rank, n, _rank_device(device, rank),
                axis_names=(AXIS, MODEL), shape=(n_data, n_model),
                coords=(i, j), data_group=cols[j], model_group=rows[i])


def table_sharding(mesh: Mesh) -> Sharding:
    """The packed [N, d] table: rows over 'data'."""
    return Sharding(mesh, (mesh.axis, None))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh: Mesh, ndim: int) -> Sharding:
    """The leading (batch) dim over 'data', the rest whole."""
    return Sharding(mesh, (mesh.axis,) + (None,) * (ndim - 1))


def _unflatten(pairs) -> dict:
    """The nested dict of (path, leaf) pairs (models/params.py::tree_paths)."""
    out: dict = {}
    for path, v in pairs:
        node = out
        *head, leaf = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


# the leaves JAX splits over 'model' (its mesh.py:55-98): the projection
# stacks and the intersection pre-transform over their last (output) dim,
# the post-transform over its dim 1 (its contraction dim)
_COLUMN_SPLIT = {("proj", "W"), ("proj", "r"), ("proj", "w"), ("inter", "pre")}


def model_dim(path: str, ndim: int) -> int | None:
    """The dim a leaf is split over on a mesh with a 'model' axis, or None
    (replicated)."""
    key = tuple(path.split("/")[:2])
    if key in _COLUMN_SPLIT:
        return ndim - 1
    if key == ("inter", "post"):
        return 1
    return None


def param_shardings(params: dict, mesh: Mesh) -> dict:
    """"table" rows over 'data'; every other leaf (the operators, the
    encoder: R·d² and M·d² floats) replicated on a 1-D mesh. On a mesh
    with a 'model' axis the operator stacks are tensor-parallel as JAX
    places them: `proj/W`, `proj/r`, `proj/w` and `inter/pre` split over
    their last dim, `inter/post` over dim 1, everything else (the depth > 0
    encoder included) replicated; a split dim that the model axis does not
    divide raises JAX's ValueError."""
    tp = MODEL in mesh.axis_names

    def spec(path, x):
        if path == "table":
            return table_sharding(mesh)
        dim = model_dim(path, x.dim()) if tp else None
        if dim is None:
            return replicated(mesh)
        n_model = mesh.shape[1]
        if x.shape[dim] % n_model:
            raise ValueError(
                f"param {path} dim {dim} (= {x.shape[dim]}) is not divisible "
                f"by the 'model' mesh axis ({n_model}); pick embed_dim a "
                f"multiple of n_model or a smaller model axis")
        return Sharding(mesh, tuple(MODEL if k == dim else None
                                    for k in range(x.dim())))

    return _unflatten((p, spec(p, x)) for p, x in tree_paths(params))


def pad_table_rows(params: dict, n_shards: int) -> tuple[dict, int]:
    """Pad the table with zero rows to a multiple of n_shards (even
    shards). No id names a padded row, so its gradient is 0 and Adam keeps
    it 0. Returns (params, the number of rows added)."""
    table = params["table"]
    pad = (-table.shape[0]) % n_shards
    if pad:
        params = dict(params)
        params["table"] = torch.cat(
            [table.detach(), table.new_zeros((pad,) + tuple(table.shape[1:]))]
        ).requires_grad_(table.requires_grad)
    return params, pad


def shard_rows(n_rows: int, size: int) -> int:
    """Rows of one shard of an n_rows table on `size` ranks."""
    return -(-n_rows // size)


def _own_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a whole (unpadded or padded) table, a
    contiguous copy on mesh.device: data shard i of the table padded to a
    multiple of the whole mesh's size (JAX pads to mesh.devices.size)."""
    padded, _ = pad_table_rows({"table": x.detach()}, mesh.size)
    per = padded["table"].shape[0] // mesh.n_data
    i = mesh.data_index
    return (padded["table"][i * per:(i + 1) * per]
            .to(mesh.device, copy=True).requires_grad_(x.requires_grad))


def _model_block(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a whole leaf along its 'model' dim, as a
    contiguous tensor of its own (the fused Adam kernel takes no view)."""
    return t.chunk(mesh.shape[1], dim)[mesh.coords[1]].contiguous()


def shard_params(params: dict, mesh: Mesh) -> dict:
    """The rank's parameters, placed as param_shardings says: data shard i
    of the table padded to a multiple of the mesh's size (rows
    [i·N_pad/D, (i+1)·N_pad/D) for D ranks over 'data'), every other leaf as
    rank 0 holds it (broadcast), so the ranks start equal bit for bit, and
    of a leaf split over 'model' block j of it on rank (i, j). New tensors
    on mesh.device; the caller's are not touched."""
    specs = dict(tree_paths(param_shardings(params, mesh)))

    def place(path, x):
        spec = specs[path].spec
        if spec[:1] == (mesh.axis,):
            return _own_rows(x, mesh)
        t = broadcast(x.detach().to(mesh.device, copy=True), mesh)
        if MODEL in spec:
            t = _model_block(t, spec.index(MODEL), mesh)
        return t.requires_grad_(x.requires_grad)

    return _unflatten((p, place(p, x)) for p, x in tree_paths(params))


def is_sharded(params: dict, mesh: Mesh, n_rows: int) -> bool:
    """Whether params["table"] is a shard of an n_rows table on `mesh`
    placed on its device (at one rank the whole table is its shard)."""
    t = params["table"]
    per = shard_rows(n_rows, mesh.size) * mesh.size // mesh.n_data
    return t.shape[0] == per and t.device == mesh.device


def _collective(name: str, fn, *args, axis: str = AXIS, **kw):
    COLLECTIVES[axis][name] += 1
    return fn(*args, **kw)


# torch 2.13 renamed the tensor collectives (the old names warn there);
# older releases have only the old ones
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)


def gather_table(shard: torch.Tensor, mesh: Mesh,
                 n_rows: int | None = None) -> torch.Tensor:
    """The whole [N_pad, d] table on every rank (all-gather of the shards
    over 'data', in data order), sliced to its first n_rows rows when
    given. A new tensor, outside autograd."""
    shard = shard.detach().contiguous()
    out = shard.new_empty((shard.shape[0] * mesh.n_data,)
                          + tuple(shard.shape[1:]))
    _collective("all_gather", _all_gather, out, shard, group=mesh.data_group)
    return out if n_rows is None else out[:n_rows]


def reduce_scatter_rows(full: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of the sum over 'data' of a whole [N_pad, d]
    tensor (a table gradient)."""
    full = full.contiguous()
    out = full.new_empty((full.shape[0] // mesh.n_data,)
                         + tuple(full.shape[1:]))
    _collective("reduce_scatter", _reduce_scatter, out, full,
                op=dist.ReduceOp.SUM, group=mesh.data_group)
    return out


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum `t` over 'data', in place."""
    _collective("all_reduce", dist.all_reduce, t, op=dist.ReduceOp.SUM,
                group=mesh.data_group)
    return t


def all_gather_model(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """[size, *t.shape]: every model rank's `t` of this rank's data row
    (its model group of `size` ranks), in model order; a new tensor,
    outside autograd."""
    t = t.detach().contiguous()
    out = t.new_empty((size * t.shape[0],) + tuple(t.shape[1:]))
    _collective("all_gather", _all_gather, out, t, group=group, axis=MODEL)
    return out.view((size,) + tuple(t.shape))


def all_reduce_model(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over this rank's data row (its model group), in place."""
    _collective("all_reduce", dist.all_reduce, t, op=dist.ReduceOp.SUM,
                group=group, axis=MODEL)
    return t


def broadcast(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rank 0's `t` on every rank, in place (the mesh's ranks are the
    group's first ones, so its rank 0 is the default group's)."""
    _collective("broadcast", dist.broadcast, t, src=0, group=mesh.group)
    return t


def broadcast_value(x: float, mesh: Mesh) -> float:
    """Rank 0's float on every rank (float64, exact)."""
    t = torch.tensor([x], dtype=torch.float64, device=mesh.device)
    return float(broadcast(t, mesh)[0])


def barrier(mesh: Mesh) -> None:
    _collective("barrier", dist.barrier, group=mesh.group)


def _map_tables(fn, tree):
    """Apply fn to the "table" entry of every dict in a tree of dicts,
    tuples and lists (parameters, Adam's (mu, nu, count), a driver's
    state); other leaves are kept."""
    if isinstance(tree, dict):
        return {k: fn(v) if k == "table" and isinstance(v, torch.Tensor)
                else _map_tables(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tables(fn, v) for v in tree)
    return tree


def unshard_tree(tree, mesh: Mesh, n_rows: int):
    """Every table of a state tree gathered and cut to its n_rows real
    rows (the whole, unpadded arrays a checkpoint holds); a collective:
    every rank calls it."""
    def whole(t):
        return gather_table(t, mesh, n_rows).clone().requires_grad_(
            t.requires_grad)

    return _map_tables(whole, tree)


def unshard_model(tree: dict, mesh: Mesh) -> dict:
    """A params-shaped tree (parameters, or Adam's mu or nu) with every
    leaf that is split over 'model' gathered whole from the model ranks of
    this rank's data row (the table stays this rank's shard; see
    unshard_tree). A new tree outside autograd; on a 1-D mesh the tree
    itself. A collective: every rank calls it."""
    if MODEL not in mesh.axis_names:
        return tree

    def whole(path, x):
        dim = model_dim(path, x.dim())
        if dim is None:
            return x
        parts = all_gather_model(x, mesh.model_group, mesh.shape[1])
        return torch.cat(parts.unbind(0), dim=dim)

    return _unflatten((p, whole(p, x)) for p, x in tree_paths(tree))


def shard_tree(tree, mesh: Mesh):
    """Every table of a state tree of whole tables (a checkpoint of any
    mesh size, or of an unsharded run) cut to this rank's padded rows;
    other leaves are kept. Local: every rank read the same state."""
    return _map_tables(lambda t: _own_rows(t, mesh), tree)


def mesh_consistent(tree, mesh: Mesh):
    """Every tensor of a tree of dicts, tuples and lists on mesh.device."""
    if isinstance(tree, dict):
        return {k: mesh_consistent(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(mesh_consistent(v, mesh) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.device != mesh.device:
        return tree.detach().to(mesh.device).requires_grad_(tree.requires_grad)
    return tree


# ---------- the launcher ----------

_RESULT = "result.pt"


def _rank_main(rank: int, n: int, device: str, tmp: str, timeout, fn, args):
    """One rank of spawn_on_mesh: join the group through a file in `tmp`,
    run fn(mesh, *args), and on rank 0 write its result to `tmp`."""
    if device == "cpu":
        torch.set_num_threads(1)
        backend = "gloo"
    else:
        torch.cuda.set_device(rank)
        backend = "nccl"
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                            world_size=n, rank=rank, **kw)
    out = fn(make_mesh(n, device=device), *args)
    if rank == 0:
        part = Path(tmp) / f".{_RESULT}"
        torch.save(out, part)
        os.replace(part, Path(tmp) / _RESULT)
    dist.destroy_process_group()


def spawn_on_mesh(fn, n: int, *args, device="cuda", timeout: float | None = None):
    """Run fn(mesh, *args) in n new processes, rank r on `cuda:r` with NCCL
    (device "cuda": needs n cards) or on the CPU with gloo and one intra-op
    thread (device "cpu"), and return rank 0's result (its tensors on the
    CPU). fn must be importable by name (a module's top-level function);
    its result is pickled with torch.save.

    The ranks meet through a file in a fresh temporary directory (no TCP
    port, so runs side by side never collide). When a rank fails, the
    others are terminated and the failure raises here with the rank's
    traceback; when `timeout` seconds pass first (also the group's
    collective timeout), every rank is terminated and TimeoutError raised."""
    import torch.multiprocessing as mp

    device = resolve_device(device).type
    if device == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"a mesh of {n} ranks needs {n} CUDA devices; "
                           f"{torch.cuda.device_count()} visible")
    with tempfile.TemporaryDirectory(prefix="gqe-mesh-") as tmp:
        ctx = mp.start_processes(_rank_main,
                                 args=(n, device, tmp, timeout, fn, args),
                                 nprocs=n, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=0.1):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"spawn_on_mesh: {n} ranks still ran "
                                       f"after {timeout} s; terminated")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        return torch.load(Path(tmp) / _RESULT, map_location="cpu",
                          weights_only=False)
