"""The port's custom gradients (graphqembed_tpu_torch.ops.grads) against the
JAX package's `ops/grads.py`: values and gradients of `take_rows` and
`select_dim`, with duplicate ids, for float32 and bfloat16 tables.

Tolerances: forward values are gathers and selects, so exact. The
`select_dim` gradient is a one-hot product, exact in both packages. The
`take_rows` gradient sums duplicate rows in another order: float32 within
rtol 1e-6; bfloat16 sums round at each add, so within one bfloat16 ulp
(rtol 2^-7) of the larger side."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphqembed_tpu.ops import grads as jgrads
from graphqembed_tpu_torch.ops import grads


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jnp_f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_take_rows_matches_jax(dtype):
    rng = np.random.default_rng(0)
    table = rng.normal(size=(20, 8)).astype(np.float32)
    ids = rng.integers(0, 6, size=(5, 3))          # many duplicates
    ct = rng.normal(size=(5, 3, 8)).astype(np.float32)

    jt = jnp.asarray(table).astype(dtype)
    y_j, vjp = jax.vjp(lambda t: jgrads.take_rows(t, jnp.asarray(ids, jnp.int32)), jt)
    (g_j,) = vjp(jnp.asarray(ct).astype(dtype))

    tt = torch.from_numpy(table).to(getattr(torch, dtype)).requires_grad_(True)
    y_t = grads.take_rows(tt, torch.from_numpy(ids))
    (g_t,) = torch.autograd.grad(y_t, tt, torch.from_numpy(ct).to(tt.dtype))

    assert g_t.dtype == tt.dtype
    np.testing.assert_array_equal(_np(y_t), _jnp_f32(y_j))
    rtol = 1e-6 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(_np(g_t), _jnp_f32(g_j), rtol=rtol, atol=1e-6)
    # untouched rows get exactly zero
    untouched = np.setdiff1d(np.arange(20), ids)
    assert (_np(g_t)[untouched] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead", [(7,), (4, 3)])
def test_select_dim_matches_jax(dtype, lead):
    rng = np.random.default_rng(1)
    r, e = 5, 6
    t = rng.normal(size=lead + (r, e)).astype(np.float32)
    ids = rng.integers(0, r, size=lead)
    ct = rng.normal(size=lead + (e,)).astype(np.float32)

    jt = jnp.asarray(t).astype(dtype)
    y_j, vjp = jax.vjp(lambda x: jgrads.select_dim(x, jnp.asarray(ids, jnp.int32)), jt)
    (g_j,) = vjp(jnp.asarray(ct).astype(dtype))

    tt = torch.from_numpy(t).to(getattr(torch, dtype)).requires_grad_(True)
    y_t = grads.select_dim(tt, torch.from_numpy(ids))
    (g_t,) = torch.autograd.grad(y_t, tt, torch.from_numpy(ct).to(tt.dtype))

    assert g_t.dtype == tt.dtype
    np.testing.assert_array_equal(_np(y_t), _jnp_f32(y_j))
    np.testing.assert_array_equal(_np(g_t), _jnp_f32(g_j))


def test_select_dim_equals_autograd_of_gather():
    """The one-hot backward is the exact gradient of a plain gather."""
    rng = np.random.default_rng(2)
    t = torch.from_numpy(rng.normal(size=(6, 4, 3)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 4, size=6))
    a = t.clone().requires_grad_(True)
    b = t.clone().requires_grad_(True)
    w = torch.from_numpy(rng.normal(size=(6, 3)).astype(np.float32))
    (ga,) = torch.autograd.grad((grads.select_dim(a, ids) * w).sum(), a)
    (gb,) = torch.autograd.grad((b[torch.arange(6), ids] * w).sum(), b)
    assert torch.equal(ga, gb)
