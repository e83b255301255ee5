"""Parameter trees for the GQE model family: nested dicts of tensors in the
JAX package's layout, so parameters carry across unchanged.

Shapes:
  table:        [N, d]   packed node embedding table (all modes)
  proj/transe:  r  [R, d]          P_r(q) = q + r
  proj/distmult:w  [R, d]          P_r(q) = q ⊙ w_r
  proj/bilinear:W  [R, d, d]       P_r(q) = q @ W_r     (row-vector convention)
  inter/pre:    [M, d, d]          h_i = relu(z_i @ pre_m)
  inter/post:   [M, d, d]          out = Φ(h_i) @ post_m, Φ ∈ {min, mean}

Leaves are ordered as JAX flattens a dict (sorted keys, depth first), so a
leaf's index is the same in both packages (the stochastic-rounding seed of
ops/fused_adam.py depends on it).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from graphqembed_tpu_torch.config import GQEConfig
from graphqembed_tpu_torch.device import resolve_device
from graphqembed_tpu_torch.graph.schema import Schema


def tree_paths(tree: dict, prefix: str = "") -> list[tuple[str, object]]:
    """(path, leaf) pairs in JAX's dict flattening order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.extend(tree_paths(v, path + "/"))
        else:
            out.append((path, v))
    return out


def tree_leaves(tree: dict) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn, tree: dict) -> dict:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def init_params(cfg: GQEConfig, schema: Schema,
                generator: torch.Generator | None = None,
                device=None) -> dict:
    """Fresh parameters drawn from `generator` (a CPU generator; the draws are
    moved to `device`). The distributions match the JAX package's: a
    unit-normal table in cfg.storage_dtype, xavier-uniform bilinear and
    intersection operators. The numbers differ, since the generators do."""
    if cfg.depth != 0:
        raise NotImplementedError("the depth>0 SAGE encoder is not ported yet")
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(
        cfg.seed)
    d = cfg.embed_dim
    n, r, m = schema.n_nodes, schema.n_relations, len(schema.modes)

    def normal(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float32)

    def xavier(*shape):
        lim = math.sqrt(6.0 / (d + d))
        return torch.rand(*shape, generator=g, dtype=torch.float32) * (
            2 * lim) - lim

    params: dict = {"table": normal(n, d).to(getattr(torch, cfg.storage_dtype))}
    if cfg.projection == "transe":
        params["proj"] = {"r": normal(r, d) / math.sqrt(d)}
    elif cfg.projection == "distmult":
        params["proj"] = {"w": normal(r, d)}
    else:
        params["proj"] = {"W": xavier(r, d, d)}
    if cfg.learned_intersection:
        params["inter"] = {"pre": xavier(m, d, d), "post": xavier(m, d, d)}
    return tree_map(lambda x: x.to(dev).requires_grad_(True), params)


_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def params_from_jax(np_tree: dict, device=None) -> dict:
    """Carry JAX parameters (as numpy arrays, e.g. from
    `graphqembed_tpu.models.params.params_to_numpy`) across, dtypes kept:
    bfloat16 arrays (numpy's ml_dtypes) travel as their raw 16 bits."""
    dev = resolve_device(device)

    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
            t = t.view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True))
        return t.to(dev).requires_grad_(t.is_floating_point())

    return tree_map(conv, np_tree)


def params_to_numpy(params: dict) -> dict:
    """Parameters as numpy arrays on the host; bfloat16 leaves come back as
    float32 (exact), since numpy has no bfloat16 of its own."""
    def conv(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return tree_map(conv, params)
