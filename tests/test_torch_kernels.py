"""The plain PyTorch versions of the port's gather, scoring and intersection
kernels (graphqembed_tpu_torch.ops.kernels) against the JAX package's
Pallas kernels (interpret mode on the CPU) and their *_ref functions, and
the wrappers' device policy. The CUDA kernels run only on the card;
chip_smoke.py holds them against these plain versions there.

Tolerances (the JAX kernel tests' own): rtol/atol 1e-6 for the gather,
1e-5 for scoring and the intersection. Both sides compute in float32 with
the same formulas; XLA and PyTorch sum the d-long dot products in other
orders, which moves the last bits of a 128-term sum."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphqembed_tpu.ops import kernels as jk
from graphqembed_tpu_torch.ops import kernels as K


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("b", [8, 100, 256])
def test_gather_normalize_plain_matches_pallas(b):
    rng = np.random.default_rng(0)
    table = rng.normal(size=(500, 128)).astype(np.float32)
    ids = rng.integers(0, 500, b).astype(np.int32)
    want_kernel = _np(jk.gather_normalize(jnp.asarray(table), jnp.asarray(ids),
                                          interpret=True))
    want_ref = _np(jk.gather_normalize_ref(jnp.asarray(table), jnp.asarray(ids)))
    got = K.gather_normalize(torch.from_numpy(table), torch.from_numpy(ids)).numpy()
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,k", [(16, 4), (50, 7)])
def test_sddmm_scores_plain_matches_pallas(b, k):
    rng = np.random.default_rng(1)
    table = rng.normal(size=(300, 128)).astype(np.float32)
    q = rng.normal(size=(b, 128)).astype(np.float32)
    cands = rng.integers(0, 300, (b, k)).astype(np.int32)
    j = [jnp.asarray(x) for x in (q, table, cands)]
    got = K.sddmm_scores(*(torch.from_numpy(x) for x in (q, table, cands))).numpy()
    for want in (jk.sddmm_scores(*j, interpret=True), jk.sddmm_scores_ref(*j)):
        np.testing.assert_allclose(got, _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["min", "mean"])
@pytest.mark.parametrize("k", [2, 3])
def test_fused_intersection_plain_matches_pallas(kind, k):
    rng = np.random.default_rng(2)
    zs = rng.normal(size=(k, 64, 128)).astype(np.float32)
    pre = (rng.normal(size=(128, 128)) / 11.3).astype(np.float32)
    post = (rng.normal(size=(128, 128)) / 11.3).astype(np.float32)
    j = [jnp.asarray(x) for x in (zs, pre, post)]
    got = K.fused_intersection(*(torch.from_numpy(x) for x in (zs, pre, post)),
                               kind=kind).numpy()
    for want in (jk.fused_intersection(*j, kind=kind, interpret=True),
                 jk.fused_intersection_ref(*j, kind=kind)):
        np.testing.assert_allclose(got, _np(want), rtol=1e-5, atol=1e-5)


def _calls():
    g = torch.Generator().manual_seed(3)
    table = torch.randn(40, 8, generator=g)
    ids = torch.randint(0, 40, (5,), generator=g, dtype=torch.int32)
    q = torch.randn(5, 8, generator=g)
    cands = torch.randint(0, 40, (5, 3), generator=g, dtype=torch.int32)
    zs, pre, post = (torch.randn(s, generator=g) for s in ((3, 5, 8), (8, 8), (8, 8)))
    return {
        "gather_normalize": (K.gather_normalize, K.gather_normalize_plain,
                             (table, ids)),
        "sddmm_scores": (K.sddmm_scores, K.sddmm_scores_plain, (q, table, cands)),
        "fused_intersection": (K.fused_intersection, K.fused_intersection_plain,
                               (zs, pre, post)),
    }


@pytest.mark.parametrize("name", sorted(K.LAUNCHES))
def test_wrapper_takes_plain_version_on_cpu_and_counts_no_launch(name):
    wrapper, plain, args = _calls()[name]
    K.reset_launch_counts()
    assert torch.equal(wrapper(*args), plain(*args))
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0)


@pytest.mark.parametrize("name", sorted(K.LAUNCHES))
def test_wrapper_raises_on_unsupported_device(name):
    wrapper, _, args = _calls()[name]
    with pytest.raises(ValueError, match="unsupported device"):
        wrapper(*(a.to("meta") for a in args))


def test_fused_intersection_refuses_a_call_that_needs_a_gradient():
    _, _, (zs, pre, post) = _calls()["fused_intersection"]
    pre = pre.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no gradient"):
        K.fused_intersection(zs, pre, post)
    with torch.no_grad():
        out = K.fused_intersection(zs, pre, post)
    assert not out.requires_grad


def test_wrappers_check_shapes():
    _, _, (table, ids) = _calls()["gather_normalize"]
    with pytest.raises(ValueError):
        K.gather_normalize(table, ids[:, None])
    with pytest.raises(ValueError):
        K.sddmm_scores(table[:4, :6], table, ids.reshape(5, 1)[:4])
    with pytest.raises(ValueError):
        K.fused_intersection(table[None], table[:7], table[:7])


def test_plain_index_out_of_range_raises_on_cpu():
    _, _, (table, ids) = _calls()["gather_normalize"]
    with pytest.raises(IndexError):
        K.gather_normalize(table, torch.tensor([0, 40], dtype=torch.int32))


def test_intersection_shared_memory_fits_hopper_at_d128():
    # the [d, d] operator and two [32, d] tiles, float32: 96 KB at d = 128,
    # above the 48 KB default (the launch raises the limit) and below 227 KB
    assert K.intersection_smem_bytes(128) == 98_304
    assert 48 * 1024 < K.intersection_smem_bytes(128) <= K.MAX_SMEM
    assert K.intersection_smem_bytes(256) > K.MAX_SMEM


def test_kernel_bench_costs_and_bounds_at_the_bench_shapes():
    """Bytes, operations and bounds of the three benches at the JAX bench's
    shapes: the intersection is bound by float32 operations (537 MFLOP,
    8.0 µs at 67 TFLOP/s), the gather and scoring by bytes (8.4 MB, 2.5 µs;
    34.6 MB, 10.3 µs at 3.35 TB/s)."""
    from graphqembed_tpu_torch.experiments import kernel_bench as kb

    n_bytes, n_ops = kb.intersection_cost(3, 4096, 128)
    assert (n_bytes, n_ops) == (8_519_680, 536_870_912)
    us, by = kb.bound_us(n_bytes, n_ops)
    assert by == "operations" and abs(us - 8.013) < 1e-3
    us, by = kb.bound_us(*kb.gather_cost(8192, 128))
    assert by == "bytes" and abs(us - 2.514) < 1e-3
    n_bytes, _ = kb.sddmm_cost(1024, 64, 128)
    us, by = kb.bound_us(*kb.sddmm_cost(1024, 64, 128))
    assert n_bytes == 34_603_008 and by == "bytes" and abs(us - 10.329) < 1e-3


def test_kernel_bench_id_chain_is_the_jax_benchs_lcg():
    """The bench's further id sets are the JAX bench's int32 LCG steps."""
    from graphqembed_tpu_torch.experiments import kernel_bench as kb

    n_rows = 1_048_576
    ids = np.random.default_rng(0).integers(0, n_rows, 64).astype(np.int32)
    chain = kb.lcg_chain(ids, n_rows, 4)
    j = jnp.asarray(ids)
    for step in chain:
        np.testing.assert_array_equal(step, np.asarray(j))
        assert step.min() >= 0 and step.max() < n_rows
        j = (j * 1664525 + 1013904223) % n_rows


def test_kernel_bench_needs_a_card():
    from graphqembed_tpu_torch.experiments import kernel_bench as kb

    for bench in (kb.bench_gather, kb.bench_sddmm, kb.bench_intersection):
        with pytest.raises(RuntimeError):
            bench(device="cpu")
