"""The training cells (traffic kind `train`): pool-free training of the
port through `training/device_sampler.py::make_onthefly_train_step`, in
the multitask round order and weights of `run_train_onthefly` (every
structure of the traffic in turn, `dispatch_steps` steps a call), with no
burn-in and no evals, on one card.

Set-up builds ONE step object with its parameters (from the seed) and
optimizer state and drives it through the check calls (the traffic's
`check_calls`, [structure, steps] each, through the window's own call and
sampler, each on fresh batches), then one whole round of dispatches, which
warms every shape the window uses. The window hands the same object on:
whole rounds until `seconds` have passed, fenced at both ends by
`torch.cuda.synchronize()` and a read of the loss.

The check: the batches of the check calls are drawn again from their saved
generator states (the sampler is deterministic for a state) and held
against the graph: every sampled row a query with an answer, and on the
intersection structures the hard negative on the steps the configuration's
alternation names and the plain one on the others (`batch_readings`). The
reference then trains from the same initial parameters on them. Compared
(`compare`): each call's mean loss, the first gradient (read from Adam's
first moment after the first call, which takes one step), and each leaf's
change after the check calls, by the worst leaf. A call of two steps or
more takes a hard negative and carries the state from step to step inside
the call, as the window's calls do.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import time

import numpy as np
import torch

from gqe_bench import data, harness
from gqe_bench.trace import profile_slice

B1 = 0.9          # Adam's β1 in the port's FusedAdamOpt
TAG_CHECK, TAG_WARM, TAG_WINDOW, TAG_TRACE = 1, 2, 3, 4
INTERSECTIONS = ("2i", "3i", "ip", "pi")


def weight(model: dict, structure: str) -> float:
    if structure == "1p":
        return 1.0
    if structure in ("2p", "3p"):
        return model["path_weight"]
    return model["inter_weight"]


def uses_hard(model: dict, structure: str) -> bool:
    return structure in INTERSECTIONS and model["hard_neg_alternate"]


def hard_steps(model: dict, structure: str, n_steps: int) -> list[bool]:
    """Which steps of a call take the hard negative, as the configuration
    states it: under `hard_neg_alternate`, on the intersection structures,
    the odd steps of each call at `hard_neg_frac` 0.5, else the first
    round(frac·8) steps of every 8."""
    if not uses_hard(model, structure):
        return [False] * n_steps
    frac = model["hard_neg_frac"]
    if frac == 0.5:
        return [t % 2 == 1 for t in range(n_steps)]
    k = round(frac * 8)
    return [t % 8 < k for t in range(n_steps)]


class Program:
    """The port's step object for one configuration and traffic, with the
    graph (and SAGE tables) placed once."""

    def __init__(self, config: dict, traffic: dict, device, log=print):
        from graphqembed_tpu_torch.config import GQEConfig
        from graphqembed_tpu_torch.training.device_sampler import (
            make_onthefly_train_step,
        )

        self.device = device
        self.model = config["model"]
        self.traffic = traffic
        self.cfg = GQEConfig(**self.model, batch_size=traffic["batch_size"])
        t = time.perf_counter()
        self.dg = data.program_device_graph(config["graph"], device)
        self.tables = None
        if self.model["depth"] > 0:
            self.tables = data.program_neighbor_tables(
                config["graph"], config["neighbor_samples"])
        log(f"graph placed ({time.perf_counter() - t:.2f} s)")
        self.layout = data.layout_of(config["graph"])
        self.make_step = lambda opt: make_onthefly_train_step(
            self.cfg, opt, self.dg, neighbor_tables=self.tables)

    def fresh(self, seed: int):
        """(flat params, nested params, optimizer state, step fn) from the
        seed, the nested tree over the flat dict's tensors."""
        from graphqembed_tpu_torch.training.device_data import FusedAdamOpt

        lay = self.layout
        flat = harness.init_params(self.model, lay.n_nodes,
                                   len(lay.relations), len(lay.modes), seed,
                                   self.device)
        tree = harness.nest(flat)
        opt = FusedAdamOpt(self.model["lr"])
        return flat, tree, opt.init(tree), self.make_step(opt)

    def batch(self, gen_state, structure: str, n_steps: int,
              use_hard: bool | None = None) -> dict:
        """The [n_steps, B, ...] batches that a call of n_steps drew from a
        generator in gen_state."""
        from graphqembed_tpu_torch.training.device_sampler import (
            sample_dispatch,
            torch_draw,
        )

        if use_hard is None:
            use_hard = uses_hard(self.model, structure)
        g = torch.Generator(device=self.device)
        g.set_state(gen_state)
        return sample_dispatch(self.cfg, self.dg, torch_draw(g), structure,
                               n_steps, use_hard)


def check_steps(prog: Program, seed: int) -> dict:
    """Build the step object from the seed and take the check calls: the
    program's readings, the batches and the initial parameters, and the
    live (tree, state, step) for the window."""
    calls = [(s, int(n)) for s, n in prog.traffic["check_calls"]]
    if calls[0][1] != 1:
        raise ValueError("the first check call takes one step: the first "
                         "gradient is read from Adam's state after it")
    flat, tree, state, step = prog.fresh(seed)
    p0 = {k: v.detach().clone() for k, v in flat.items()}
    losses, grad1, drawn = [], None, []
    for i, (s, n) in enumerate(calls):
        g = harness.generator(prog.device, seed, TAG_CHECK, i)
        saved = g.get_state()
        tree, state, loss = step(tree, state, s, g, n,
                                 weight(prog.model, s),
                                 uses_hard(prog.model, s))
        losses.append(float(loss))
        if grad1 is None:
            grad1 = {k: float(v.detach().double().norm()) / (1 - B1)
                     for k, v in harness.flatten(state[0]).items()}
        drawn.append((s, n, prog.batch(saved, s, n), saved))
    change = {k: float((v.detach() - p0[k]).double().norm())
              for k, v in flat.items()}
    return {"losses": losses, "grad1": grad1, "change": change,
            "calls": drawn, "p0": p0, "live": (tree, state, step)}


def call_means(losses: list, lengths: list) -> list:
    """Per call, the mean of its steps' losses (what the port's call
    returns)."""
    out, at = [], 0
    for n in lengths:
        out.append(sum(losses[at:at + n]) / n)
        at += n
    return out


def compare(prog: dict, ref: dict, p0: dict, lengths: list) -> dict:
    """The numbers compared, program (or a stand-in) against the
    reference: `loss_gap` |loss − ref| / |ref| of the first call's loss;
    `grad_gap` and `step_gap` the worst leaf's |norm − ref norm| over the
    larger of that leaf's ref norm and the median leaf's, for the first
    gradient and for the change after the calls. A leaf whose reference
    gradient is under a thousandth of the median leaf's moves by round-off
    alone under Adam and is left out of `step_gap`, and of
    `step_gap_median`, the median leaf's gap. Reported beside them:
    `later_loss_gap`, the largest gap of the other calls' mean losses, and
    `leaf_step_gaps`, each leaf's gap of its change."""
    gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in
            zip(prog["losses"], call_means(ref["losses"], lengths))]
    g_ref = {k: float(v.double().norm()) for k, v in ref["grad1"].items()}
    g_med = statistics.median(g_ref.values())
    grad_gap = max(abs(prog["grad1"][k] - g_ref[k]) / max(g_ref[k], g_med)
                   for k in g_ref)
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    c_ref = {k: float((ref["params"][k] - p0[k]).double().norm())
             for k in moved}
    c_med = statistics.median(c_ref.values())
    leaf = {k: abs(prog["change"][k] - c_ref[k]) / max(c_ref[k], c_med)
            for k in moved}
    return {"loss_gap": gaps[0], "grad_gap": grad_gap,
            "step_gap": max(leaf.values()),
            "step_gap_median": statistics.median(leaf.values()),
            "later_loss_gap": max(gaps[1:], default=0.0),
            "leaf_step_gaps": leaf}


def as_program(ref: dict, p0: dict, lengths: list) -> dict:
    """A reference run in the program's place (the control, a fault)."""
    return {"losses": call_means(ref["losses"], lengths),
            "grad1": {k: float(v.double().norm())
                      for k, v in ref["grad1"].items()},
            "change": {k: float((ref["params"][k] - p0[k]).double().norm())
                       for k in ref["params"]}}


def lengths_of(checked: dict) -> list:
    return [n for _, n, _, _ in checked["calls"]]


def batch_readings(graph, model: dict, calls: list, check_rows: int,
                   seed: int) -> dict:
    """The sampled batches against the graph, on `check_rows` rows of each
    step drawn from the seed: `bad_rows` the rows that are no query of
    their structure with an answer, or carry a wrong intersection mode or
    negative (`gqe_ref.invalid_rows`); on the intersection structures,
    `hard_miss` the share of rows of the hard steps whose negative answers
    no branch of the query, `plain_hit` the share of rows of the other
    steps whose negative does, `miss_ratio` hard_miss over 1 − plain_hit
    (near 1 when the hard steps' negatives are drawn as the plain steps'
    are, in either direction), and `hard_answer` the share of hard
    negatives that answer the whole query (reported, not limited: the
    sampler excludes only another branch's sampled neighbours)."""
    from gqe_bench.reference import gqe_ref

    arrays = graph.layout.arrays()
    rng = np.random.default_rng([seed, TAG_CHECK])
    bad = 0
    count = {"hard": 0, "miss": 0, "answer": 0, "plain": 0, "hit": 0}
    for s, n, b, _ in calls:
        flags = hard_steps(model, s, n)
        for t in range(n):
            host = {k: v[t].cpu().numpy() for k, v in b.items()}
            size = len(host["targets"])
            rows = np.sort(rng.choice(size, size=min(size, check_rows),
                                      replace=False))
            sub = {k: v[rows] for k, v in host.items()}
            bad += gqe_ref.invalid_rows(graph, arrays, s, sub)
            if s not in INTERSECTIONS:
                continue
            a, r, _, neg, _ = gqe_ref.valid_rows(sub)
            hit = gqe_ref.branch_answers(graph, arrays, s, a, r, neg)
            if flags[t]:
                count["hard"] += len(hit)
                count["miss"] += int((~hit).sum())
                count["answer"] += int(gqe_ref.answers(
                    graph, arrays, s, a, r, neg).sum())
            else:
                count["plain"] += len(hit)
                count["hit"] += int(hit.sum())
    hard_miss = count["miss"] / max(count["hard"], 1)
    plain_hit = count["hit"] / max(count["plain"], 1)
    return {"bad_rows": bad, "hard_miss": hard_miss, "plain_hit": plain_hit,
            "miss_ratio": hard_miss / max(1.0 - plain_hit, 1e-9),
            "hard_answer": count["answer"] / max(count["hard"], 1)}


def reference_side(config: dict, traffic: dict, checked: dict, seed: int,
                   device, graph=None):
    """(encoder, batch readings, steps on the device) for the reference."""
    from gqe_bench.reference import gqe_ref

    g = graph or data.RefGraph.load(config["graph"])
    found = batch_readings(g, config["model"], checked["calls"],
                           traffic["check_rows"], seed)
    nbrs = None
    depth = config["model"]["depth"]
    if depth > 0:
        nbrs = torch.as_tensor(data.ref_neighbor_tables(
            config["graph"], config["neighbor_samples"], graph=g)["neighbors"],
            device=device)
    enc = gqe_ref.Encoder(g.layout.arrays(), depth, nbrs)
    w = config["model"]
    steps = [(s, weight(w, s), {k: v[t].to(device) for k, v in b.items()})
             for s, n, b, _ in checked["calls"] for t in range(n)]
    return enc, found, steps


def reference_train(enc, steps, p0: dict, model: dict, **kw) -> dict:
    from gqe_bench.reference import gqe_ref

    return gqe_ref.train(p0, enc, steps, model["margin"], model["lr"], **kw)


def readings(cell, seeds: list, n_control: int, device, log=print) -> list:
    """The readings that the cell's limits are set from, at its own sizes,
    in one process: the program's on each seed; on the first n_control,
    the control (the reference with TF32 operands) and the faults
    (`gqe_bench/control.py`)."""
    from gqe_bench.reference import gqe_ref

    prog = Program(cell.config, cell.traffic, device, log)
    graph = data.RefGraph.load(cell.config["graph"])
    model, traffic = cell.config["model"], cell.traffic
    rows = []
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        checked = check_steps(prog, seed)
        checked.pop("live")
        enc, found, steps = reference_side(cell.config, traffic, checked,
                                           seed, device, graph)
        p0, lengths = checked["p0"], lengths_of(checked)
        ref = reference_train(enc, steps, p0, model)
        row = {"seed": seed,
               "program": dict(compare(checked, ref, p0, lengths), **found)}
        if i < n_control:
            with gqe_ref.control():
                ctl = reference_train(enc, steps, p0, model)
            row["control"] = compare(as_program(ctl, p0, lengths), ref, p0,
                                     lengths)
            half = reference_train(enc, steps, p0, model, drop_half=True)
            row["half_batch"] = compare(as_program(half, p0, lengths), ref,
                                        p0, lengths)
            row.update(sampler_faults(prog, checked, graph, seed))
            with planted("stale_count"):
                stale = check_steps(prog, seed)
            stale.pop("live")
            row["stale_count"] = compare(stale, ref, p0, lengths)
            del stale
        row["seconds"] = time.perf_counter() - t
        log(json.dumps(row))
        rows.append(row)
        del checked, steps, ref
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


# ---------- faults planted in the program (the limits' upper readings) ----------

def _stale_count_scan(body, carry, batch_xs: dict):
    """The port's `_scan` with the optimizer's step count held at its value
    before the call for every step of the call: a carry broken inside a
    call (Adam's bias correction goes wrong from the second step)."""
    params, (mu, nu, count) = carry
    losses = []
    n = next(iter(batch_xs.values())).shape[0]
    for t in range(n):
        (params, (mu, nu, _)), loss = body(
            (params, (mu, nu, count)), {k: v[t] for k, v in batch_xs.items()})
        losses.append(loss)
    return (params, (mu, nu, count + n)), torch.stack(losses)


@contextlib.contextmanager
def planted(name: str):
    """Break the port's sampler or call inside the block: `hard_off` no
    hard negative on any step, `hard_always` one on every step,
    `stale_count` the step count held inside a call."""
    from graphqembed_tpu_torch.training import device_sampler as ds

    real = {"_hard_step": ds._hard_step, "_scan": ds._scan}
    if name == "hard_off":
        ds._hard_step = lambda cfg, t: t < 0
    elif name == "hard_always":
        ds._hard_step = lambda cfg, t: t >= 0
    elif name == "stale_count":
        ds._scan = _stale_count_scan
    else:
        raise ValueError(name)
    try:
        yield
    finally:
        ds._hard_step, ds._scan = real["_hard_step"], real["_scan"]


def sampler_faults(prog: Program, checked: dict, graph, seed: int) -> dict:
    """The batch readings of the check calls drawn again from their own
    generator states with the sampler broken: `hard_off`, `hard_always`."""
    out = {}
    for name in ("hard_off", "hard_always"):
        with planted(name):
            calls = [(s, n, prog.batch(state, s, n), state)
                     for s, n, _, state in checked["calls"]]
        out[name] = batch_readings(graph, prog.model, calls,
                                   prog.traffic["check_rows"], seed)
    return out


def window_ctx(prog: Program, config: dict, traffic: dict) -> dict:
    lay = prog.layout
    arrays = lay.arrays()
    return {"kind": "train", "model": prog.model, "traffic": traffic,
            "batch_size": traffic["batch_size"], "n_nodes": lay.n_nodes,
            "mode_counts": [lay.counts[m] for m in lay.modes],
            "mode_rels": [len(r) for r in arrays["mode_rels"]],
            "neighbor_samples": config.get("neighbor_samples", 0)}


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        log=print) -> tuple[dict, dict]:
    """One run of a training cell: (result without "checks", checks)."""
    if cell.chips != 1:
        raise SystemExit("traffic kind 'train' runs on one card; a cell "
                         "across cards needs a driver of its own kind")
    model, traffic = cell.config["model"], cell.traffic
    structures = traffic["structures"]
    T = traffic["dispatch_steps"]
    B = traffic["batch_size"]
    prog = Program(cell.config, traffic, device, log)
    checked = check_steps(prog, seed)
    tree, state, step = checked["live"]
    log(f"check calls taken ({time.perf_counter() - t_start:.2f} s)")

    def dispatch(s, g, n=T):
        nonlocal tree, state
        tree, state, loss = step(tree, state, s, g, n, weight(model, s),
                                 uses_hard(model, s))
        return loss

    for j, s in enumerate(structures):
        loss = dispatch(s, harness.generator(device, seed, TAG_WARM, j))
    float(loss)
    log(f"set-up {time.perf_counter() - t_start:.2f} s")

    # the window: whole rounds until `seconds` have passed
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    enqueue = 0.0
    done, d = [], 0
    while True:
        for s in structures:
            te = time.perf_counter()
            loss = dispatch(s, harness.generator(device, seed, TAG_WINDOW, d))
            enqueue += time.perf_counter() - te
            done.append((s, T))
            d += 1
        if time.perf_counter() - t0 >= seconds:
            break
    final_loss = float(loss)                     # waits for the card
    window_s = time.perf_counter() - t0
    steps = sum(n for _, n in done)
    log(f"window {window_s:.3f} s, {steps} steps, {len(done)} dispatches, "
        f"last loss {final_loss:.6f}")

    ctx = window_ctx(prog, cell.config, traffic)
    ctx.update(window_s=window_s, dispatches=done, enqueue_s=enqueue,
               param_sizes={k: v.numel() for k, v in checked["p0"].items()})
    breakdown = None
    if trace:
        def traced_round():
            for j, s in enumerate(structures):
                loss = dispatch(s, harness.generator(device, seed,
                                                     TAG_TRACE, j))
            return float(loss)

        tr = profile_slice(traced_round, device)
        ctx["slice"] = dict(tr, dispatches=[(s, T) for s in structures])
        breakdown = {"device_ops": tr["device_ops"],
                     "idle_gaps": tr["idle_gaps"]}
    dev = harness.device_info(device, cell.chips)
    del tree, state, step, prog
    checked.pop("live")
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the check, once the window has closed and the program's state is gone
    tc = time.perf_counter()
    enc, found, ref_steps = reference_side(cell.config, traffic, checked,
                                           seed, device)
    ref = reference_train(enc, ref_steps, checked["p0"], model)
    numbers = dict(compare(checked, ref, checked["p0"], lengths_of(checked)),
                   **found)
    numbers["loss_finite"] = 0 if np.isfinite(final_loss) else 1
    log(f"reference {time.perf_counter() - tc:.2f} s")

    if trace:
        metrics = harness.read_metrics(cell.per_layer, ctx)
        dev.update(busy_s=ctx["slice"]["busy_s"],
                   window_s=ctx["slice"]["window_s"])
    else:
        metrics = {"train_qps": {"value": steps * B / window_s,
                                 "unit": "queries/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    checks = harness.judge(numbers, cell.limits)
    result = {"correct": harness.passed(checks), "attempted": steps,
              "failed": 0 if harness.passed(checks) else steps,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    return result, checks
