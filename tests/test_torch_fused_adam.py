"""The plain PyTorch versions of the port's fused-Adam kernels
(graphqembed_tpu_torch.ops.fused_adam) against the JAX package's
`ops/fused_adam.py`, on the CPU. The CUDA kernels themselves run only on
the card; chip_smoke.py holds them against these plain versions there.

Tolerances: the float32 step repeats the Pallas kernel's operations in the
same order, each rounded once, as the CUDA kernel (built with -fmad=false)
does. XLA on the CPU contracts mu' = β1·mu + (1−β1)·g (and nu') into a
fused multiply-add, one rounding fewer, so the interpret-mode Pallas kernel
differs by about an ulp per step: held at rtol 1e-6 (≈ 8 float32 ulps) with
an atol of 1e-7 × the array's largest magnitude for entries that cancel.
Stochastic rounding given the same random bits is bit for bit. Statistical
checks state their bounds where they are made."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphqembed_tpu.ops import fused_adam as jfa
from graphqembed_tpu_torch.ops import fused_adam as fa


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().astype(np.uint16)


def _jbf16_bits(x) -> np.ndarray:
    return np.asarray(jax.lax.bitcast_convert_type(x, jnp.uint16))


@pytest.mark.parametrize("shape", [(64, 16), (5, 8, 16), (40, 128)])
def test_leaf_plain_matches_pallas_interpret(shape):
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=shape).astype(np.float32)
    jp, jm, jv = jnp.asarray(p0), jnp.zeros(shape), jnp.zeros(shape)
    tp = torch.from_numpy(p0.copy())
    tm, tv = torch.zeros(shape), torch.zeros(shape)
    for t in range(1, 6):
        g = rng.normal(size=shape).astype(np.float32)
        jp, jm, jv = jfa.fused_adam_leaf(jp, jnp.asarray(g), jm, jv,
                                         jnp.int32(t), 0.01, interpret=True)
        fa.fused_adam_leaf(tp, torch.from_numpy(g), tm, tv, t, 0.01)
        for a, b in ((tp, jp), (tm, jm), (tv, jv)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                       atol=1e-7 * float(np.abs(b).max()))


def test_leaf_wrapper_uses_plain_on_cpu_and_counts_no_launch():
    rng = np.random.default_rng(1)
    p, g = (torch.from_numpy(rng.normal(size=(7, 3)).astype(np.float32))
            for _ in range(2))
    a = [p.clone(), g, torch.zeros(7, 3), torch.zeros(7, 3)]
    b = [p.clone(), g, torch.zeros(7, 3), torch.zeros(7, 3)]
    fa.reset_launch_counts()
    fa.fused_adam_leaf(*a, 1, 0.1)
    fa.fused_adam_leaf_plain(*b, 1, 0.1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], p)
    assert fa.LAUNCHES == {"fused_adam_leaf": 0, "fused_adam_leaf_sr": 0}


def test_wrappers_check_their_inputs():
    z = torch.zeros(4, 4)
    with pytest.raises(TypeError):
        fa.fused_adam_leaf(z.double(), z.double(), z.double(), z.double(), 1, 0.1)
    with pytest.raises(ValueError, match="shapes"):
        fa.fused_adam_leaf(z, torch.zeros(4, 5), z.clone(), z.clone(), 1, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        fa.fused_adam_leaf(z, z.t(), z.clone(), z.clone(), 1, 0.1)
    zb = z.bfloat16()
    with pytest.raises(TypeError):
        fa.fused_adam_leaf_sr(z, z, zb, zb, 1, 3, 0.1)
    with pytest.raises(ValueError, match="count"):
        fa.fused_adam_leaf(z, z, z.clone(), z.clone(), 0, 0.1)


def test_sr_to_bf16_plain_matches_jax_bit_for_bit():
    rng = np.random.default_rng(2)
    x = np.concatenate([
        rng.normal(size=3000).astype(np.float32),
        (rng.normal(size=1000) * 1e-30).astype(np.float32),
        np.array([0.0, -0.0, 1.0, -1.0, 3.0e38, -3.0e38, np.inf, -np.inf],
                 np.float32)])
    bits = rng.integers(0, 2 ** 32, size=x.shape, dtype=np.uint64).astype(np.uint32)
    want = jfa.sr_to_bf16_ref(jnp.asarray(x), jnp.asarray(bits))
    got = fa.sr_to_bf16_plain(torch.from_numpy(x),
                              torch.from_numpy(bits.astype(np.int64)))
    np.testing.assert_array_equal(_bf16_bits(got), _jbf16_bits(want))


@pytest.mark.parametrize("g_dtype", ["bfloat16", "float32"])
def test_sr_adam_step_matches_jax_math_given_its_bits(g_dtype):
    """The plain SR step against adam_step_sr_ref, fed the bits that the
    reference draws from its key. β1, β2, ε and lr are passed as float32
    scalars so the reference rounds 1−β as the Pallas kernel does."""
    rng = np.random.default_rng(3)
    shape = (48, 32)
    f = np.float32
    p = rng.normal(size=shape).astype(f)
    mu = (rng.normal(size=shape) * 0.01).astype(f)
    nu = (rng.uniform(size=shape) * 1e-3).astype(f)
    g = (rng.normal(size=shape) * 0.1).astype(f)
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    count, key = 3, jax.random.key(7)
    want = jfa.adam_step_sr_ref(jb(p), jnp.asarray(g).astype(g_dtype), jb(mu),
                                jb(nu), jnp.int32(count), f(0.01), key,
                                b1=f(0.9), b2=f(0.999), eps=f(1e-8))
    bits = [torch.from_numpy(np.asarray(jax.random.bits(k, shape, jnp.uint32))
                             .astype(np.int64))
            for k in jax.random.split(key, 3)]
    tb = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    tp, tm, tv = tb(p), tb(mu), tb(nu)
    tg = torch.from_numpy(g).to(getattr(torch, g_dtype))
    fa.fused_adam_leaf_sr_plain(tp, tg, tm, tv, count, 0, 0.01, bits=bits)
    for a, b in ((tp, want[0]), (tm, want[1]), (tv, want[2])):
        np.testing.assert_array_equal(_bf16_bits(a), _jbf16_bits(b))


def test_sr_unbiased_over_seeds():
    """Mean of SR(x) over 512 seeds of the kernel's hash recovers x. In units
    of the bfloat16 ulp at x, one draw's error has variance ≤ 1/4, so the
    RMS over elements of the 512-seed mean's error is ≤ 0.5/sqrt(512) ≈ 0.022;
    bound 0.04. Round-to-nearest leaves ≈ 0.29 (uniform error), the control."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.normal(size=2048) * 3).astype(np.float32))
    ulp = torch.from_numpy(np.spacing(x.bfloat16().float().abs().numpy()
                                      .astype(np.float32)) * 65536)
    acc = torch.zeros_like(x, dtype=torch.float64)
    n = 512
    for seed in range(n):
        bits = fa.sr_bits_plain(seed, 0, x.numel(), "cpu")
        acc += fa.sr_to_bf16_plain(x, bits).double()
    err = ((acc / n - x.double()) / ulp.double())
    rms = float(err.pow(2).mean().sqrt())
    assert rms < 0.04, rms
    nearest = ((x.bfloat16().double() - x.double()) / ulp.double())
    assert float(nearest.pow(2).mean().sqrt()) > 0.2


def test_sr_hash_streams_differ_and_are_uniform():
    n = 1 << 14
    base = fa.sr_bits_plain(11, 0, n, "cpu")
    assert int(base.min()) >= 0 and int(base.max()) < 2 ** 32
    others = [fa.sr_bits_plain(12, 0, n, "cpu"),
              fa.sr_bits_plain(11, 1, n, "cpu"),
              fa.sr_bits_plain(11, 2, n, "cpu")]
    for o in others:
        # two independent uniform 32-bit streams agree at ~n/2^32 places
        assert int((o == base).sum()) <= 1
    # the low 16 bits (the ones SR uses) are uniform: mean 32767.5, the
    # standard error of the mean of 2^14 draws is 18918/128 ≈ 148
    low = (base & 0xFFFF).double()
    assert abs(float(low.mean()) - 32767.5) < 5 * 148
    # and the same seed and stream give the same bits
    assert torch.equal(base, fa.sr_bits_plain(11, 0, n, "cpu"))


def test_sr_hash_matches_a_scalar_reference():
    """The tensor hash equals the same recipe in Python integers, which is
    what the CUDA kernel computes in uint32."""
    def fmix(h):
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & 0xFFFFFFFF
        h ^= h >> 13
        h = (h * 0xC2B2AE35) & 0xFFFFFFFF
        return h ^ (h >> 16)

    seed, stream = 123456789, 2
    key = fmix((seed + 0x9E3779B9 * (stream + 1)) & 0xFFFFFFFF)
    bits = fa.sr_bits_plain(seed, stream, 64, "cpu").tolist()
    assert bits == [fmix(fmix(i ^ key)) for i in range(64)]


def test_fused_adam_tree_seeds_and_routes_leaves():
    """bf16 leaves take the SR step with seed count·n_leaves + leaf index
    (JAX's dict order), f32 leaves the float32 step."""
    rng = np.random.default_rng(5)
    params = {"table": torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32)).bfloat16(),
              "proj": {"W": torch.from_numpy(rng.normal(size=(3, 8, 8)).astype(np.float32))}}
    grads = {"table": torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32)).bfloat16(),
             "proj": {"W": torch.from_numpy(rng.normal(size=(3, 8, 8)).astype(np.float32))}}
    zeros = lambda t: torch.zeros_like(t)  # noqa: E731
    mu = {"table": zeros(params["table"]), "proj": {"W": zeros(params["proj"]["W"])}}
    nu = {"table": zeros(params["table"]), "proj": {"W": zeros(params["proj"]["W"])}}
    want_t = [params["table"].clone(), grads["table"], zeros(params["table"]),
              zeros(params["table"])]
    want_w = [params["proj"]["W"].clone(), grads["proj"]["W"],
              zeros(params["proj"]["W"]), zeros(params["proj"]["W"])]
    fa.fused_adam_tree(params, grads, mu, nu, 4, 0.05)
    # leaves in order: proj/W (0), table (1); n_leaves = 2
    fa.fused_adam_leaf_sr_plain(*want_t, 4, 4 * 2 + 1, 0.05)
    fa.fused_adam_leaf_plain(*want_w, 4, 0.05)
    assert torch.equal(params["table"], want_t[0])
    assert torch.equal(mu["table"], want_t[2]) and torch.equal(nu["table"], want_t[3])
    assert torch.equal(params["proj"]["W"], want_w[0])
    assert params["table"].dtype == torch.bfloat16


def test_sr_moment_tracks_f32_where_nearest_stalls():
    """Why the SR kernel exists: the nu recursion with a small constant
    gradient (β2=0.999, g=0.01) stalls under round-to-nearest bfloat16 but
    integrates under SR, as in the JAX package's test of its reference."""
    nu_sr = torch.zeros(8, 128, dtype=torch.bfloat16)
    nu_near = torch.zeros(8, 128, dtype=torch.bfloat16)
    nu_f32 = torch.zeros(8, 128)
    for t in range(2500):
        bits = fa.sr_bits_plain(t, 2, nu_sr.numel(), "cpu").reshape(8, 128)
        nu_sr = fa.sr_to_bf16_plain(0.999 * nu_sr.float() + 0.001 * 1e-4, bits)
        nu_near = (0.999 * nu_near.float() + 0.001 * 1e-4).bfloat16()
        nu_f32 = 0.999 * nu_f32 + 0.001 * 1e-4
    f32 = float(nu_f32.mean())
    assert abs(float(nu_sr.float().mean()) - f32) / f32 < 0.10
    assert float(nu_near.float().mean()) < 0.5 * f32
