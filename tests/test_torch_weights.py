"""The port's weight-sharing baselines (``repro_torch``: ``core.fedavg``,
``core.async_fl``, the client-axis syncs of ``core.distributed``, the
``FedAvg`` and ``AsyncWeights`` strategies and their LM sessions) against
the JAX package on the CPU.

Inputs come from numpy with a seed; JAX params cross through
``interop.params_from_numpy``.  Tolerances: the averages are the same fp32
arithmetic, so fp32 leaves agree within atol 1e-7 and bf16 leaves within
one bf16 rounding (rtol 2**-8: an fp32 mean a few ulps apart can round
the other way); a session's per-round losses atol 2e-5 and final params
atol 1e-4, as in ``test_torch_train.py``.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import AsyncWeights as JAsyncWeights
from repro.api import FedAvg as JFedAvg
from repro.api import Federation as JFederation
from repro.api import LMClients as JLMClients
from repro.configs import get_reduced as jget_reduced
from repro.core import async_fl as jasync_fl
from repro.core import distributed as jD
from repro.core import fedavg as jfedavg
from repro.core import stacking as jstacking
from repro.core.populations.base import \
    broadcast_mask_counts as jbroadcast_mask_counts
from repro_torch import interop
from repro_torch.api import (AsyncWeights, FedAvg, Federation, LMClients,
                             get_strategy)
from repro_torch.checkpoint import flatten
from repro_torch.configs import get_reduced
from repro_torch.core import async_fl, fedavg
from repro_torch.core import distributed as D
from repro_torch.core.populations.base import broadcast_mask_counts
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _trees_close(got, want, dtype=np.float32, atol=1e-7):
    """Leaf by leaf, matched by their '/'-joined paths."""
    got = {k: _np(v) for k, v in flatten(got).items()}
    want = {k: _np(v) for k, v in flatten(jax.tree.map(
        lambda t: np.asarray(jnp.asarray(t, jnp.float32)), want)).items()}
    assert sorted(got) == sorted(want)
    rtol = 2.0 ** -8 if dtype == "bfloat16" else 0.0
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=atol,
                                   rtol=rtol, err_msg=key)


@pytest.fixture(scope="module")
def stacked():
    """A K=3 reduced qwen3-4b tree from JAX's init, as numpy."""
    params = jD.stacked_init(jax.random.PRNGKey(2), jget_reduced("qwen3-4b"),
                             3)
    return jax.tree.map(np.asarray, params)


def _both(tree, dtype):
    """The same tree for each package, in ``dtype``."""
    jt = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), tree)
    tt = tree_map(lambda t: t.to(getattr(torch, dtype)),
                  interop.params_from_numpy(tree, device="cpu"))
    return jt, tt


# ---------------------------------------------------------------------------
# core.fedavg and core.async_fl

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fedavg_helpers_match_jax(stacked, dtype):
    jt, tt = _both(stacked, dtype)
    _trees_close(fedavg.average_weights(tt), jfedavg.average_weights(jt),
                 dtype)
    scores = [0.2, 0.5, 0.9]
    _trees_close(fedavg.weighted_average_weights(tt, scores),
                 jfedavg.weighted_average_weights(jt, scores), dtype)
    assert fedavg.comm_bytes_per_round(1234, 3) == \
        jfedavg.comm_bytes_per_round(1234, 3)


def test_async_helpers_match_jax(stacked):
    """The schedule, the per-leaf bool-mask update, one async round and the
    param counts, against JAX."""
    for delta, min_round in ((3, 5), (2, 1), (1, 0)):
        assert [async_fl.layer_schedule(r, delta, min_round)
                for r in range(12)] == \
            [jasync_fl.layer_schedule(r, delta, min_round)
             for r in range(12)]
    jt, tt = _both(stacked, "float32")
    jmask = jax.tree_util.tree_map_with_path(
        lambda path, _: "embed" in str(path[0]), jt)
    tmask = {k: tree_map(lambda _: k == "embed", v) for k, v in tt.items()}
    for r in (0, 1):
        got, layer = async_fl.async_round_update(tt, [0.3, 0.6, 0.1], tmask,
                                                 r, delta=2, min_round=1)
        want, jlayer = jasync_fl.async_round_update(jt, [0.3, 0.6, 0.1],
                                                    jmask, r, delta=2,
                                                    min_round=1)
        assert layer == jlayer == ("shallow", "deep")[r]
        _trees_close(got, want)
    assert async_fl.count_params_by_mask(tt, tmask) == \
        jasync_fl.count_params_by_mask(jt, jmask)
    for layer in ("shallow", "deep"):
        assert async_fl.comm_bytes_per_round(10, 30, 3, layer) == \
            jasync_fl.comm_bytes_per_round(10, 30, 3, layer)


# ---------------------------------------------------------------------------
# the client-axis syncs of core.distributed (in place in the port)

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("part", [None, [1.0, 0.0, 1.0]])
def test_fedavg_sync_matches_jax(stacked, dtype, part):
    jt, tt = _both(stacked, dtype)
    want = jD.fedavg_sync(jt, None if part is None else jnp.asarray(part))
    got = D.fedavg_sync(tt, part)
    assert got is tt                                  # in place
    _trees_close(got, want, dtype)
    if part is not None:                              # the absentee kept its
        for a, b in zip(tree_leaves(tt), jax.tree.leaves(jt)):
            np.testing.assert_array_equal(_np(a[1]), _np(b[1]))


def test_shallow_mask_and_counts_match_jax(stacked):
    jt, tt = _both(stacked, "float32")
    cfg, jcfg = get_reduced("qwen3-4b"), jget_reduced("qwen3-4b")
    mask = D.transformer_shallow_mask(cfg, tt)
    jmask = jD.transformer_shallow_mask(jcfg, jt)
    _trees_close(mask, jmask, atol=0)
    for m, p in zip(tree_leaves(mask), tree_leaves(tt)):
        assert m.dim() == p.dim() and m.shape[0] == 1
    assert broadcast_mask_counts(tt, mask, 3) == \
        jbroadcast_mask_counts(jt, jmask, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,part", [(0, None), (1, None), (0, [1, 1, 0]),
                                    (1, [0, 1, 1])])
def test_async_sync_matches_jax(stacked, dtype, r, part):
    """A shallow (r = 0) and a deep (r = 1) round of delta 2, min_round 1,
    with full and partial participation: the JAX population's
    ``async_sync`` then ``client_lerp``, against the port's in-place
    ``async_sync`` with ``part_mask``."""
    jt, tt = _both(stacked, dtype)
    cfg, jcfg = get_reduced("qwen3-4b"), jget_reduced("qwen3-4b")
    pm = np.ones(3, np.float32) if part is None else \
        np.asarray(part, np.float32)
    scores = np.asarray([0.4, 0.7, 0.2], np.float32) * pm
    want = jD.async_sync(jt, jnp.asarray(scores),
                         jD.transformer_shallow_mask(jcfg, jt), r, 2, 1)
    if part is not None:
        want = jstacking.client_lerp(jt, want, jnp.asarray(pm))
    got = D.async_sync(tt, scores, D.transformer_shallow_mask(cfg, tt), r,
                       2, 1, part_mask=part)
    assert got is tt
    _trees_close(got, want, dtype)


# ---------------------------------------------------------------------------
# FedAvg and AsyncWeights sessions, round by round

SESSIONS = {                    # name: (strategy factory, participation, R)
    "fedavg": (lambda m: m.FedAvg(), 0, 3),
    "fedavg-partial": (lambda m: m.FedAvg(), 2, 3),
    "async": (lambda m: m.AsyncWeights(delta=2, min_round=1), 0, 4),
    "async-partial": (lambda m: m.AsyncWeights(delta=2, min_round=1), 2, 3),
}


class _Jax:
    FedAvg, AsyncWeights = JFedAvg, JAsyncWeights


class _Port:
    FedAvg, AsyncWeights = FedAvg, AsyncWeights


@pytest.fixture(scope="module")
def jax_sessions():
    """The JAX sessions (run once), with the params they started from."""
    out = {}
    for name, (make, part, rounds) in SESSIONS.items():
        pop = JLMClients(jget_reduced("qwen3-4b"), n_clients=3,
                         rounds=rounds, batch=2, seq=16, seed=0,
                         kernel_impl="ref")
        start = jax.tree.map(np.asarray, pop.state_dict())
        fed = JFederation(pop, make(_Jax), participation=part)
        fed.run()
        out[name] = (start, fed)
    return out


def _port_session(name, start):
    make, part, rounds = SESSIONS[name]
    pop = LMClients(get_reduced("qwen3-4b"), n_clients=3, rounds=rounds,
                    batch=2, seq=16, seed=0, device="cpu")
    pop.load_state_dict(interop.params_from_numpy(start, device="cpu"), {})
    return Federation(pop, make(_Port), participation=part)


@pytest.mark.parametrize("name", list(SESSIONS))
def test_weight_session_matches_jax(jax_sessions, name):
    """K=3 reduced qwen3-4b sessions from JAX-initialised params:
    participants, comm bytes, the async layer, per-round local losses, and
    the final params."""
    start, jfed = jax_sessions[name]
    fed = _port_session(name, start)
    fed.run()
    rounds = SESSIONS[name][2]
    assert len(fed.history.rounds) == len(jfed.history.rounds) == rounds
    for got, want in zip(fed.history.rounds, jfed.history.rounds):
        assert got.participants == want.participants
        assert got.comm_bytes == want.comm_bytes > 0
        assert got.layer == want.layer
        np.testing.assert_allclose(got.client_loss, want.client_loss,
                                   atol=2e-5, rtol=0)
    if name == "async":
        assert [rl.layer for rl in fed.history.rounds] == \
            ["shallow", "deep", "shallow", "deep"]
    assert fed.history.total_comm_bytes == jfed.history.total_comm_bytes
    _trees_close(fed.population.client_params,
                 jfed.population.client_params, atol=1e-4)


@pytest.mark.parametrize("name", ["fedavg", "fedavg-partial"])
def test_fedavg_round_syncs_participants(jax_sessions, name):
    """After a FedAvg round every participant holds the same params, and a
    client that sat the round out holds exactly what it held before."""
    fed = _port_session(name, jax_sessions[name][0])
    before = tree_map(torch.clone, fed.population.client_params)
    fed.run(until=1)
    part = fed.history.rounds[0].participants
    for old, new in zip(tree_leaves(before),
                        tree_leaves(fed.population.client_params)):
        for c in range(3):
            if c in part:
                assert torch.equal(new[c], new[part[0]])
            else:
                assert torch.equal(new[c], old[c])


def test_weight_strategies_resolve():
    """The CLI ids resolve with their knobs; knobs a strategy does not
    take are dropped; the LM population supports all four strategies."""
    st = get_strategy("async", delta=2, min_round=1, k=8)
    assert isinstance(st, AsyncWeights) and (st.delta, st.min_round) == (2, 1)
    assert isinstance(get_strategy("fedavg", kl_weight=0.5, k=8), FedAvg)
    assert LMClients.supported == {"dml", "sparse-dml", "fedavg", "async"}


@pytest.mark.parametrize("strategy", ["fedavg", "async"])
def test_train_cli_weight_strategies_on_cpu(strategy):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--method", "dml",
         "--clients", "3", "--steps", "2", "--batch", "2", "--seq", "16",
         "--strategy", strategy, "--device", "cpu"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert any(line.startswith("step    1 loss=") for line in lines), \
        proc.stdout
    assert "total_comm_bytes=" in proc.stdout
