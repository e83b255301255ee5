"""Beyond-RAM input pipeline: deterministic, checkpointable streaming from
saved npz query shards (`data/loader.py::save_queries` formula shards and
`save_query_arrays` mixed native shards), the JAX package's
`data/grain_pipeline.py` in PyTorch.

The module keeps its counterpart's name, but it holds no grain: importing
`grain.python` imports JAX, which the port never loads. Two layers:

- `make_query_loader` / `QueryShardSource`: the per-record API (a seeded
  shuffle per epoch, batches of batch_size, iterator get_state/set_state);
- `run_train_stream`: the production trainer, windowed device staging.
  `NpzStructureStream` assembles fixed-size per-structure windows with
  numpy fancy-indexing, `WindowPacker` ships a window set as one pinned
  host buffer and one host-to-device copy on a side CUDA stream, a host
  thread assembles and uploads the next set while the card trains on the
  current one (`training/device_data.py::make_scan_train_step`), and the
  losses stay on the device until the loop's sync points. Resume is
  exactly-once: a stream's state is (epoch, pos) over seeded per-epoch
  permutations, snapshotted BEFORE each window draw.
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from graphqembed_tpu_torch.config import INTERSECT_STRUCTURES, STRUCTURES
from graphqembed_tpu_torch.device import check_placed, resolve_device
from graphqembed_tpu_torch.models.params import tree_clone
from graphqembed_tpu_torch.training.device_data import (
    POOL_FIELDS,
    default_optimizer,
    derived_generator,
    make_scan_train_step,
)
from graphqembed_tpu_torch.training.eval import eval_auc
from graphqembed_tpu_torch.training.loop import (
    TrainResult,
    check_conv,
    resolve_queries,
    structure_weight,
)


def _structure_entries(path: Path, structure: str) -> list[dict]:
    manifest = json.loads((path / "manifest.json").read_text())
    return [e for e in manifest if e["structure"] == structure]


def _epoch_permutation(seed: int, epoch: int, n: int) -> np.ndarray:
    """The record order of one epoch: a pure function of (seed, epoch)."""
    return np.random.default_rng((seed, 0x5EED, epoch)).permutation(n)


class QueryShardSource:
    """Random access over all queries of ONE structure across its shards
    (each shard read once, on first access)."""

    def __init__(self, path: str | Path, structure: str,
                 neg_width: int = 16, hard_neg_width: int = 16):
        self.path = Path(path)
        self.entries = _structure_entries(self.path, structure)
        self.structure = structure
        # fixed widths: formula shards store ragged negative lists; records
        # must be uniform for batching (pad with -1 / truncate)
        self.neg_width = neg_width
        self.hard_neg_width = hard_neg_width
        self._offsets = np.cumsum([0] + [e["count"] for e in self.entries])
        self._cache: dict[int, dict] = {}

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __repr__(self) -> str:
        # stable and content-addressed (no object address): the JAX
        # package's loader checks resumed iterator state against it
        return (f"QueryShardSource(path={self.path}, "
                f"structure={self.structure}, n={len(self)}, "
                f"neg_width={self.neg_width}, "
                f"hard_neg_width={self.hard_neg_width})")

    def _shard(self, si: int) -> dict:
        if si not in self._cache:
            with np.load(self.path / self.entries[si]["file"]) as z:
                shard = {k: z[k] for k in z.files}
            if "rels" not in shard:
                # formula shard (save_queries): one rels row for the shard;
                # mixed native shards (save_query_arrays) store per-row rels
                shard["rels"] = np.asarray(self.entries[si]["rels_ids"],
                                           np.int32)
            self._cache[si] = shard
        return self._cache[si]

    @staticmethod
    def _fit(row: np.ndarray, width: int) -> np.ndarray:
        if len(row) >= width:
            return row[:width]
        out = np.full(width, -1, row.dtype)
        out[:len(row)] = row
        return out

    def __getitem__(self, idx):
        si = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        row = idx - self._offsets[si]
        shard = self._shard(si)
        negs = self._fit(shard["negs"][row], self.neg_width)
        hard = (self._fit(shard["hard_negs"][row], self.hard_neg_width)
                if "hard_negs" in shard else
                self._fit(negs, self.hard_neg_width))
        rels = shard["rels"]
        if rels.ndim == 2:       # mixed native shard: per-row rels
            rels = rels[row]
        return {
            "anchors": shard["anchors"][row],
            "target": shard["targets"][row],
            "negs": negs,
            "hard_negs": hard,
            "rels": rels,
        }


def _attach_rel_ids(path: str | Path, schema) -> None:
    """Annotate the manifest with dense relation ids once, in the JAX
    package's bytes (either package may read the directory). The new
    manifest is written beside the old one and moved into place, so a
    process killed mid-write leaves the old manifest whole."""
    path = Path(path)
    mpath = path / "manifest.json"
    manifest = json.loads(mpath.read_text())
    changed = False
    for e in manifest:
        if "rels_ids" not in e:
            e["rels_ids"] = [schema.rel_id(tuple(r)) for r in e["rels"]]
            changed = True
    if changed:
        tmp = mpath.with_name(f".{mpath.name}.{os.getpid()}.tmp")
        tmp.write_text(json.dumps(manifest, indent=1))
        os.replace(tmp, mpath)


class QueryLoader:
    """Deterministic, resumable batches of one structure's records, forever:
    epoch e visits the records in `_epoch_permutation(seed, e)` order, cut
    into len // batch_size full batches (the remainder of an epoch is
    dropped). `iter(loader)` starts at epoch 0; the iterator's
    get_state() / set_state() carry {"epoch", "pos"} as plain JSON."""

    def __init__(self, source: QueryShardSource, batch_size: int, seed: int):
        if len(source) < batch_size:
            raise ValueError(f"{source!r} holds {len(source)} records, fewer "
                             f"than one batch of {batch_size}")
        self.source = source
        self.batch_size = batch_size
        self.seed = seed

    def __iter__(self) -> "QueryLoaderIterator":
        return QueryLoaderIterator(self)


class QueryLoaderIterator:
    def __init__(self, loader: QueryLoader):
        self.loader = loader
        self.epoch = 0
        self.pos = 0

    def __iter__(self):
        return self

    def get_state(self) -> dict:
        return {"epoch": self.epoch, "pos": self.pos}

    def set_state(self, st: dict) -> None:
        self.epoch = int(st["epoch"])
        self.pos = int(st["pos"])

    def __next__(self) -> dict:
        src, b = self.loader.source, self.loader.batch_size
        if self.pos + b > len(src):      # drop the epoch's remainder
            self.epoch += 1
            self.pos = 0
        idx = _epoch_permutation(self.loader.seed, self.epoch,
                                 len(src))[self.pos:self.pos + b]
        self.pos += b
        records = [src[int(i)] for i in idx]
        return {k: np.stack([r[k] for r in records]) for k in records[0]}


def make_query_loader(path: str | Path, schema, structure: str,
                      batch_size: int, seed: int = 0) -> QueryLoader:
    """Deterministic, resumable batch loader for one structure.

    Batches are dicts of stacked arrays: anchors [B, A], target [B],
    negs [B, K], hard_negs [B, Kh], rels [B, R]. Use `iter(loader)` and the
    iterator's get_state/set_state for checkpointed resume."""
    _attach_rel_ids(path, schema)
    return QueryLoader(QueryShardSource(path, structure), batch_size, seed)


class NpzStructureStream:
    """Vectorized, exactly-once record stream over one structure's npz
    shards: the window producer for run_train_stream. A window of W records
    is assembled with numpy fancy-indexing over the shard arrays, which are
    decompressed once, here (np.load memory-maps no compressed npz). The
    stream state is (epoch, pos) over a seeded per-epoch permutation: plain
    JSON, and exactly-once on resume (the permutation is a pure function of
    (seed, epoch))."""

    def __init__(self, path: str | Path, structure: str, seed: int = 0,
                 neg_width: int = 16, hard_neg_width: int = 16):
        self.path = Path(path)
        self.entries = _structure_entries(self.path, structure)
        self.structure = structure
        self.neg_width = neg_width
        self.hard_neg_width = hard_neg_width
        self.shards = []
        for e in self.entries:
            with np.load(self.path / e["file"]) as z:
                self.shards.append({
                    "anchors": z["anchors"], "targets": z["targets"],
                    "negs": z["negs"],
                    "hard_negs": z["hard_negs"] if "hard_negs" in z.files
                    else None,
                    "rels": z["rels"] if "rels" in z.files
                    else np.asarray(e["rels_ids"], np.int32),
                })
        self.offsets = np.cumsum([0] + [e["count"] for e in self.entries])
        self.n = int(self.offsets[-1])
        self.seed = seed
        self.epoch = 0
        self.pos = 0
        self._perm = None
        self._perm_epoch = -1

    def get_state(self) -> dict:
        return {"epoch": self.epoch, "pos": self.pos}

    def set_state(self, st: dict) -> None:
        self.epoch = int(st["epoch"])
        self.pos = int(st["pos"])

    def _permutation(self, epoch: int) -> np.ndarray:
        if self._perm_epoch != epoch:
            self._perm = _epoch_permutation(self.seed, epoch, self.n)
            self._perm_epoch = epoch
        return self._perm

    @staticmethod
    def _fit(arr: np.ndarray, width: int) -> np.ndarray:
        if arr.shape[1] >= width:
            return arr[:, :width]
        out = np.full((arr.shape[0], width), -1, np.int32)
        out[:, :arr.shape[1]] = arr
        return out

    def draw(self, w: int) -> dict:
        """Next `w` records (advancing the stream): dict with per-row
        anchors [w, A], target [w], negs [w, K] / hard_negs [w, Kh]
        (-1-padded), rels [w, R], all int32: the _window_arrays input."""
        idx = []
        while w > 0:
            perm = self._permutation(self.epoch)
            take = min(w, self.n - self.pos)
            idx.append(perm[self.pos:self.pos + take])
            self.pos += take
            w -= take
            if self.pos >= self.n:
                self.epoch += 1
                self.pos = 0
        idx = np.concatenate(idx)
        m = len(idx)
        si = np.searchsorted(self.offsets, idx, side="right") - 1
        a0 = self.shards[0]["anchors"].shape[1]
        r0 = self.shards[0]["rels"].shape[-1]
        anchors = np.empty((m, a0), np.int32)
        targets = np.empty(m, np.int32)
        negs = np.full((m, self.neg_width), -1, np.int32)
        hard = np.full((m, self.hard_neg_width), -1, np.int32)
        rels = np.empty((m, r0), np.int32)
        for s in np.unique(si):
            sel = si == s
            local = idx[sel] - self.offsets[s]
            sh = self.shards[s]
            anchors[sel] = sh["anchors"][local]
            targets[sel] = sh["targets"][local]
            negs[sel] = self._fit(np.asarray(sh["negs"][local], np.int32),
                                  self.neg_width)
            h = sh["hard_negs"]
            if h is None:
                hard[sel] = negs[sel][:, :self.hard_neg_width]
            else:
                hard[sel] = self._fit(np.asarray(h[local], np.int32),
                                      self.hard_neg_width)
            r = sh["rels"]
            rels[sel] = r[local] if r.ndim == 2 else r[None, :]
        return {"anchors": anchors, "target": targets, "negs": negs,
                "hard_negs": hard, "rels": rels}


def _window_arrays(batches: list[dict], structure: str,
                   tmode: np.ndarray) -> dict:
    """Stack drawn records into DevicePool-style int64 arrays (the
    POOL_FIELDS): -1 pads become (pool, count) pairs for the in-scan
    negative draw, each count at least 1."""
    cat = lambda k: np.concatenate([b[k] for b in batches]).astype(np.int64)  # noqa: E731
    anchors = cat("anchors")
    targets = cat("target")
    rels = cat("rels")
    negs = cat("negs")
    hard = cat("hard_negs")
    if structure in INTERSECT_STRUCTURES:
        # ip intersects at its branches' to-mode; 2i/3i/pi at the target's
        col = 0 if structure == "ip" else rels.shape[1] - 1
        inter_modes = tmode[rels[:, col]].astype(np.int64)
    else:
        inter_modes = np.full(len(rels), -1, np.int64)

    def pool(arr, fallback):
        counts = (arr >= 0).sum(axis=1)
        return np.where(arr >= 0, arr, fallback[:, None]), np.maximum(counts, 1)

    # rows with an empty hard pool fall back to their plain pool (as
    # DevicePool does)
    none = (hard >= 0).sum(axis=1) == 0
    hard = np.where(none[:, None], negs[:, :hard.shape[1]], hard)
    negs, neg_counts = pool(negs, targets)
    hard, hard_counts = pool(hard, targets)
    return dict(anchors=anchors, rels=rels, inter_modes=inter_modes,
                targets=targets, negs=negs, neg_counts=neg_counts,
                hard=hard, hard_counts=hard_counts)


class StreamWindow:
    """One structure's staged window: the POOL_FIELDS as int64 tensors (views
    of the window set's one device buffer) and n rows, the interface of
    DevicePool that make_scan_train_step reads."""

    def __init__(self, structure: str, n: int, fields: dict):
        self.structure = structure
        self.n = n
        for f in POOL_FIELDS:
            setattr(self, f, fields[f])

    @property
    def device(self) -> torch.device:
        return self.anchors.device


class WindowSet(dict):
    """WindowPacker.pack's result, {structure: StreamWindow}, with the upload
    it came from: the device buffer and the event recorded after its copy
    (None on the CPU)."""

    def __init__(self, windows: dict, buffer: torch.Tensor, event=None):
        super().__init__(windows)
        self.buffer = buffer
        self.event = event

    def use_on(self, stream) -> "WindowSet":
        """Order `stream` after the upload, and register it as a user of the
        buffer, so that the caching allocator does not hand the buffer out
        again while scans queued there still read it. Call on the compute
        stream before the first scan that reads the set."""
        if self.event is not None:
            stream.wait_event(self.event)
            self.buffer.record_stream(stream)
            self.event = None
        return self


class WindowPacker:
    """Stage a whole window SET (all structures, all fields) as ONE host
    buffer and ONE host-to-device copy, each field a view of the device
    buffer: one transfer at the link's rate where one per field would pay a
    copy's latency 8 × n_structures times. On a CUDA device the host buffer
    is pinned and the copy runs on the packer's side stream; pack returns
    once the copy is done, so it may run on a worker thread while the
    compute stream trains. Window shapes are fixed for a run: the plan
    (each field's offset and shape) is built once per set of shapes."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._plan = None
        self._key = None
        self._total = 0
        self._stream = None

    def pack(self, per_struct: dict[str, dict]) -> WindowSet:
        key = tuple((s, f, np.shape(per_struct[s][f]))
                    for s in sorted(per_struct) for f in POOL_FIELDS)
        if key != self._key:
            plan, off = [], 0
            for s, f, shape in key:
                size = int(np.prod(shape))
                plan.append((s, f, off, size, shape))
                off += size
            self._key, self._plan, self._total = key, plan, off
        cuda = self.device.type == "cuda"
        host = torch.empty(self._total, dtype=torch.int64, pin_memory=cuda)
        flat = host.numpy()
        for s, f, off, size, _ in self._plan:
            flat[off:off + size] = np.asarray(per_struct[s][f]).reshape(-1)
        event = None
        if cuda:
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._stream):
                buf = torch.empty(self._total, dtype=torch.int64,
                                  device=self.device)
                buf.copy_(host, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
            # the pinned buffer must outlive its copy: wait for it here,
            # on the packer's thread, not on the compute stream's
            event.synchronize()
        else:
            buf = host
        fields: dict[str, dict] = {}
        for s, f, off, size, shape in self._plan:
            fields.setdefault(s, {})[f] = buf[off:off + size].view(shape)
        return WindowSet({s: StreamWindow(s, len(per_struct[s]["targets"]),
                                          fs) for s, fs in fields.items()},
                         buf, event)


def run_train_stream(cfg, schema, params, data_dir, val_queries=None,
                     total_steps: int | None = None,
                     burn_in_steps: int | None = None, seed: int | None = None,
                     log=None, ckpt_manager=None, ckpt_every: int = 0,
                     resume: bool = False, steps_per: int = 50,
                     optimizer=None, neighbor_tables=None,
                     device=None) -> TrainResult:
    """Beyond-RAM training with WINDOWED DEVICE STAGING: the npz query shards
    in `data_dir` stream into fixed-size per-structure windows on the device
    (cfg.stream_window records each), make_scan_train_step trains
    `steps_per` steps per dispatch on the CURRENT windows, and a host thread
    assembles and uploads the NEXT windows meanwhile.

    Schedule (the JAX package's, step for step): within a window, batch rows
    are drawn uniformly (a window is a shuffle buffer: each staged record is
    consumed ~cfg.stream_reuse times before the windows swap); burn-in on
    1p, then multitask ROUNDS over all structures (steps_per steps each,
    the reference loss weights), hard negatives alternating inside the
    scan. Losses stay on the device and are read at sync points (every
    cfg.stream_sync_every_burn burn-in dispatches, every
    cfg.stream_sync_every_round rounds, and at each eval and checkpoint);
    convergence is checked on the burn-in dispatch losses and on per-round
    mean losses. Dispatch i draws its batches from
    derived_generator(device, seed, i).

    Checkpoints (ckpt_manager + ckpt_every) save (params, opt_state,
    best_params) with the JAX package's meta: dispatch_i, window_done,
    burn_done, multitask, best_val, the convergence tails and the stream
    states snapshotted BEFORE the current windows were drawn, so a resumed
    run draws the identical windows and batches again. Unlike the JAX
    package, a resumed run also continues the multitask round count (the
    eval cadence) and the sync cadence where they stood.

    params live on `device` (None means the card) and are updated in place;
    neighbor_tables drives the SAGE encoder at cfg.depth > 0. Returns a
    training/loop.py::TrainResult; queries_per_sec counts this session's
    steps over its train seconds (the loop's wall time less eval and
    checkpoints), timings has the seconds of each and of the waits for the
    next window (window_wait_s), the swaps and session_steps."""
    dev = resolve_device(device)
    check_placed(dev, "params", params["table"])
    if neighbor_tables is not None:
        neighbor_tables = neighbor_tables.to(dev)
    data_dir = Path(data_dir)
    seed = cfg.seed if seed is None else seed
    total_steps = total_steps if total_steps is not None else cfg.max_iter
    burn_in_steps = (burn_in_steps if burn_in_steps is not None
                     else cfg.max_burn_in)

    manifest = json.loads((data_dir / "manifest.json").read_text())
    counts: dict[str, int] = {}
    for e in manifest:
        counts[e["structure"]] = counts.get(e["structure"], 0) + e["count"]
    structures = [s for s in STRUCTURES if counts.get(s)]
    _attach_rel_ids(data_dir, schema)
    # window record count per structure: fixed across windows
    win_n = {s: min(cfg.stream_window, max(counts[s], cfg.batch_size))
             for s in structures}
    iters = {s: NpzStructureStream(data_dir, s, seed=seed)
             for s in structures}
    tmode = schema.rel_target_mode_ids()

    optimizer = optimizer or default_optimizer(cfg)
    opt_state = optimizer.init(params)
    scan = make_scan_train_step(cfg, optimizer,
                                neighbor_tables=neighbor_tables)
    compute = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

    def snapshot_iters() -> dict:
        return {s: it.get_state() for s, it in iters.items()}

    packer = WindowPacker(dev)

    def build_windows() -> WindowSet:
        return packer.pack({
            s: _window_arrays([iters[s].draw(win_n[s])], s, tmode)
            for s in structures})

    def staged(windows: WindowSet) -> WindowSet:
        return windows if compute is None else windows.use_on(compute)

    # steps each window set serves before swapping: ~stream_reuse
    # consumptions of every staged record, rounded to dispatch boundaries
    window_budget = max(steps_per, int(
        cfg.stream_reuse * sum(win_n.values()) / cfg.batch_size))

    losses: dict[str, list[float]] = {s: [] for s in structures}
    burn_series: list[float] = []
    multi_series: list[float] = []
    val_history: list[tuple[int, float]] = []
    best_val = -1.0
    best_params = tree_clone(params)   # a COPY: the steps update in place
    burn_done = 0
    multitask = "1p" not in iters
    step_i = dispatch_i = window_done = last_ckpt = round_i = 0
    iter_snapshot = snapshot_iters()   # state BEFORE current windows drawn
    n_rounds_steps = len(structures) * steps_per

    if resume and ckpt_manager is not None:
        restored = ckpt_manager.restore_latest(device=dev)
        if restored is not None:
            state, meta = restored
            params = state["params"]
            opt_state = state["opt_state"]
            best_params = state["best_params"]
            step_i = last_ckpt = int(meta["step"])
            dispatch_i = int(meta["dispatch_i"])
            window_done = int(meta["window_done"])
            burn_done = int(meta["burn_done"])
            multitask = (bool(meta["multitask"])
                         or burn_done >= burn_in_steps)
            best_val = float(meta["best_val"])
            burn_series = list(meta.get("burn_tail", []))
            multi_series = list(meta.get("multi_tail", []))
            iter_snapshot = dict(meta["iter_states"])
            for name, st in iter_snapshot.items():
                iters[name].set_state(st)
            # checkpoints land on whole rounds
            round_i = (step_i - burn_done) // n_rounds_steps
    start_step = step_i
    t_eval = t_ckpt = t_wait = 0.0
    swaps = 0

    def maybe_ckpt():
        nonlocal last_ckpt, t_ckpt
        if ckpt_manager is None or not ckpt_every or \
                step_i - last_ckpt < ckpt_every:
            return
        tc = time.perf_counter()
        ckpt_manager.save_state(
            step_i,
            {"params": params, "opt_state": opt_state,
             "best_params": best_params},
            extra={
                "dispatch_i": dispatch_i, "window_done": window_done,
                "burn_done": burn_done, "multitask": multitask,
                "best_val": best_val,
                "burn_tail": burn_series[-cfg.conv_window:],
                "multi_tail": multi_series[-cfg.conv_window:],
                "iter_states": iter_snapshot,
            })
        t_ckpt += time.perf_counter() - tc
        last_ckpt = step_i

    burn_w = max(1, round(cfg.conv_window / steps_per))
    multi_w = max(1, round(cfg.conv_window / n_rounds_steps))
    eval_every_d = max(1, round(cfg.val_every / steps_per))
    sync_every = max(1, cfg.stream_sync_every_burn)
    pending = []   # (phase, round_id, structure, loss: 0-d device tensor)

    def dispatch_async(structure, t, phase):
        nonlocal params, opt_state, dispatch_i, step_i, window_done
        use_hard = (structure in INTERSECT_STRUCTURES
                    and cfg.hard_neg_alternate)
        params, opt_state, mloss = scan(
            params, opt_state, windows[structure], structure,
            derived_generator(dev, seed, dispatch_i), t,
            structure_weight(cfg, structure), use_hard)
        pending.append((phase, round_i, structure, mloss))
        dispatch_i += 1
        step_i += t
        window_done += t

    def flush():
        """Read the pending losses in ONE device sync into the per-structure
        series; multitask entries aggregate to per-round means."""
        if not pending:
            return
        values = torch.stack([m for *_, m in pending]).tolist()
        by_round: dict[int, list] = {}
        for (phase, ri, structure, _), v in zip(pending, values):
            losses[structure].append(v)
            if phase == "burn":
                burn_series.append(v)
            else:
                by_round.setdefault(ri, []).append(v)
        pending.clear()
        for ri in sorted(by_round):
            multi_series.append(float(np.mean(by_round[ri])))

    def do_eval():
        nonlocal best_val, best_params, val_queries, t_eval
        te = time.perf_counter()
        val_queries = resolve_queries(val_queries)
        macro = eval_auc(cfg, params, schema, val_queries, seed=cfg.seed,
                         neighbor_tables=neighbor_tables).get("macro", 0.0)
        val_history.append((step_i, macro))
        if macro > best_val:
            best_val = macro
            best_params = tree_clone(params)
        t_eval += time.perf_counter() - te

    def sync_point(eval_due=False):
        flush()
        if val_queries and eval_due:
            do_eval()
        maybe_ckpt()
        if log:
            log(step_i, "stream", multi_series[-1] if multi_series
                else (burn_series[-1] if burn_series else 0.0))

    def ckpt_due() -> bool:
        return bool(ckpt_manager is not None and ckpt_every
                    and step_i - last_ckpt >= ckpt_every)

    def swap_windows():
        nonlocal windows, iter_snapshot, next_snapshot, next_future, \
            window_done, t_wait, swaps
        tw = time.perf_counter()
        windows = staged(next_future.result())
        t_wait += time.perf_counter() - tw
        iter_snapshot = next_snapshot
        next_snapshot = snapshot_iters()
        next_future = ex.submit(build_windows)
        window_done = 0
        swaps += 1

    # draw the current windows (resume re-draws the identical ones: the
    # restored snapshot is the pre-draw stream state)
    windows = staged(build_windows())
    ex = ThreadPoolExecutor(1, thread_name_prefix="gqe-stream")
    next_snapshot = snapshot_iters()
    next_future = ex.submit(build_windows)
    t_loop0 = time.perf_counter()
    try:
        # --- burn-in: 1p only, async dispatches, sync on cadence ---
        last_sync_d = dispatch_i
        while not multitask and step_i < total_steps:
            if window_done >= window_budget:
                swap_windows()
            t = max(1, min(steps_per, total_steps - step_i,
                           burn_in_steps - step_i))
            dispatch_async("1p", t, "burn")
            burn_done += t
            if burn_done >= burn_in_steps:
                multitask = True
            eval_due = bool(val_queries) and dispatch_i % eval_every_d == 0
            if (eval_due or dispatch_i - last_sync_d >= sync_every
                    or multitask or ckpt_due()):
                # flip-before-ckpt: a checkpoint at the burn-in boundary
                # records the post-boundary phase
                sync_point(eval_due=eval_due)
                last_sync_d = dispatch_i
                if check_conv(burn_series, burn_w, cfg.tol):
                    multitask = True
        # --- multitask ROUNDS over all structures; sync points land at
        # round boundaries only ---
        last_sync_r = round_i
        sync_every_r = max(1, cfg.stream_sync_every_round)
        eval_every_r = max(1, round(cfg.val_every / n_rounds_steps))
        while step_i < total_steps:
            if window_done >= window_budget:
                swap_windows()
            for structure in structures:
                if step_i >= total_steps:
                    break
                dispatch_async(structure,
                               max(1, min(steps_per, total_steps - step_i)),
                               "multi")
            round_i += 1
            eval_due = bool(val_queries) and round_i % eval_every_r == 0
            if (eval_due or round_i - last_sync_r >= sync_every_r
                    or step_i >= total_steps or ckpt_due()):
                sync_point(eval_due=eval_due)
                last_sync_r = round_i
                if check_conv(multi_series, multi_w, cfg.tol):
                    break
        flush()
        if val_queries and not val_history:
            do_eval()
    finally:
        # the worker may be mid-upload: let it finish before returning
        ex.shutdown(wait=True, cancel_futures=True)
    t_train = time.perf_counter() - t_loop0 - t_eval - t_ckpt
    session_steps = step_i - start_step
    return TrainResult(
        params=params,
        best_params=best_params if best_val >= 0 else params,
        best_val_auc=best_val,
        steps=step_i, burn_in_steps=burn_done, losses=losses,
        val_history=val_history,
        queries_per_sec=(session_steps * cfg.batch_size / t_train
                         if t_train else 0.0),
        timings={"train_s": t_train, "eval_s": t_eval, "ckpt_s": t_ckpt,
                 "window_wait_s": t_wait, "window_swaps": swaps,
                 "session_steps": session_steps})
