"""The port's entry points (graphqembed_tpu_torch/entry.py) against the JAX
package's `__graft_entry__.py`: `entry`'s example inputs are JAX's (same
graph, queries and batch; the parameters are each package's own draw), and
its forward on JAX's parameters and inputs gives JAX's scores within 1e-6;
`dryrun_multichip(n)` runs every sharded path on n gloo ranks, the
(2, 2) tensor-parallel step included at n = 4, and the owner-compute
gather, the halo hop and the sharded depth-1 SAGE step; a rank's card is
chosen by its local rank (parallel/mesh.py::local_device_index)."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from graphqembed_tpu.models.params import params_to_numpy
from graphqembed_tpu_torch.entry import dryrun_multichip, entry
from graphqembed_tpu_torch.models.params import params_from_jax


@pytest.fixture(scope="module")
def jax_fwd():
    fn, args = jax_entry.entry()
    return fn, args, fn(*args)


def test_entry_inputs_are_jax_s(jax_fwd):
    _, jargs, _ = jax_fwd
    _, args = entry(device="cpu")
    params, anchors, rels, targets, negs, im = args
    np.testing.assert_array_equal(anchors.numpy(), np.asarray(jargs[1]))
    assert rels == [int(r) for r in np.asarray(jargs[2])]
    np.testing.assert_array_equal(targets.numpy(), np.asarray(jargs[3]))
    np.testing.assert_array_equal(negs.numpy(), np.asarray(jargs[4]))
    assert im == int(jargs[5])
    assert {k: tuple(v.shape) for k, v in params.items() if k == "table"} == {
        "table": tuple(jargs[0]["table"].shape)}


def test_entry_forward_matches_jax(jax_fwd):
    _, jargs, (jpos, jneg) = jax_fwd
    fn, _ = entry(device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray,
                                          params_to_numpy(jargs[0])),
                             device="cpu")

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.int64)

    with torch.no_grad():
        pos, neg = fn(params, t(jargs[1]), [int(r) for r in np.asarray(jargs[2])],
                      t(jargs[3]), t(jargs[4]), int(jargs[5]))
    assert pos.shape == jpos.shape and neg.shape == jneg.shape
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), rtol=0, atol=1e-6)
    np.testing.assert_allclose(neg.numpy(), np.asarray(jneg), rtol=0, atol=1e-6)


def test_entry_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(1)


@pytest.mark.parametrize("n", [1, 4])
def test_dryrun_multichip_on_gloo_ranks(n, capsys):
    got = dryrun_multichip(n, device="cpu", timeout=240)
    assert f"dryrun_multichip({n}): ok" in capsys.readouterr().out
    assert got["table_rows"] == -(-got["n_nodes"] // n)
    for part in ("step", "scan"):
        assert set(got[part]) == {"1p", "2i"}
        assert np.isfinite(list(got[part].values())).all()
    assert got["protocol"]["steps"] >= 16
    assert np.isfinite(got["protocol"]["best_val_auc"])
    assert np.isfinite(got["onthefly"])
    assert got["gather_rows"] == (8, 32)
    assert got["halo_max_abs_err"] <= 2e-6
    assert np.isfinite(got["deep"])
    if n == 4:
        assert got["tp"]["shape"] == (2, 2)
        assert got["tp"]["proj_W_shard"][1:] == (32, 16)
        assert np.isfinite(got["tp"]["loss"])
    else:
        assert "tp" not in got


def test_rank_device_takes_the_local_rank(monkeypatch):
    """On a host of 4 cards global rank 5 is cuda:1 (rank % cards) unless
    the launcher's LOCAL_RANK says otherwise; spawn_on_mesh's ranks, all on
    one host, keep rank r on cuda:r. The card count and set_device are
    faked: this box has no card."""
    from graphqembed_tpu_torch.parallel import mesh as pm

    chosen = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    monkeypatch.setattr(pm, "resolve_device", lambda d: torch.device("cuda"))
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert [pm.local_device_index(r) for r in range(8)] == [0, 1, 2, 3] * 2
    assert pm._rank_device(None, 5) == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert pm.local_device_index(5) == 3
    assert pm._rank_device(None, 5) == torch.device("cuda", 3)
    # a device named with its index keeps it
    monkeypatch.setattr(pm, "resolve_device", lambda d: torch.device(d))
    assert pm._rank_device("cuda:2", 5) == torch.device("cuda", 2)
    assert chosen == [torch.device("cuda", i) for i in (1, 3, 2)]
    assert pm._rank_device("cpu", 5) == torch.device("cpu")
