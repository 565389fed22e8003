"""Federation sessions of the prefix-token archs (llava-next-mistral-7b and
musicgen-medium) in the port against the JAX package on the CPU, at their
reduced configs (fp32): the conditioning draws of ``LMClients``, K = 3
DML sessions round by round (full and 2-of-3 participation) and
``evaluate``, a SparseDML, a FedAvg and an AsyncWeights round, and
checkpoints crossing both ways with the ``projector`` leaves.

The JAX sessions run once per module (a fixture) at ``kernel_impl="ref"``;
each port session starts from the params its JAX session started from.
Tolerances as in ``test_torch_train.py``: per-round losses atol 2e-5,
final params atol 1e-4 (AdamW divides by each gradient's RMS), the eval
losses 2e-5.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.api import DML as JDML
from repro.api import AsyncWeights as JAsyncWeights
from repro.api import FedAvg as JFedAvg
from repro.api import Federation as JFederation
from repro.api import LMClients as JLMClients
from repro.api import SparseDML as JSparseDML
from repro.configs import get_reduced as jget_reduced
from repro_torch import interop
from repro_torch.api import (DML, AsyncWeights, FedAvg, Federation,
                             LMClients, SparseDML)
from repro_torch.checkpoint import flatten
from repro_torch.configs import get_reduced

torch.set_num_threads(1)
LLAVA, MUSICGEN = "llava-next-mistral-7b", "musicgen-medium"


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _jax_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _trees_close(got, want, **tol):
    """Leaf by leaf, matched by their '/'-joined paths."""
    got, want = flatten(got), flatten(_jax_numpy(want))
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key].numpy(), want[key], err_msg=key, **tol)


# ---------------------------------------------------------------------------
# (a) the conditioning draws

@pytest.mark.parametrize("arch", [LLAVA, MUSICGEN])
def test_prefix_draws_match_jax_bit_for_bit(arch):
    """``_prefix(r, batch)`` (seeded by the round alone, N(0, 1) cast to
    fp32) and ``_private_prefix(r)`` (one draw, every client's), at the
    rounds, public and eval seeds the sessions use."""
    jself = SimpleNamespace(cfg=jget_reduced(arch), batch=2, n_clients=3)
    tself = SimpleNamespace(cfg=get_reduced(arch), batch=2, n_clients=3,
                            device=torch.device("cpu"))
    tself._prefix = lambda r, b: LMClients._prefix(tself, r, b)
    jself._prefix = lambda r, b: JLMClients._prefix(jself, r, b)
    for r, b in ((0, 2), (3, 2), (10_000, 1), (10_002, 1), (777_000, 2)):
        got, want = LMClients._prefix(tself, r, b), JLMClients._prefix(
            jself, r, b)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert np.array_equal(got.numpy(), np.asarray(want))
    got = LMClients._private_prefix(tself, 1)
    want = np.asarray(JLMClients._private_prefix(jself, 1))
    assert got.shape == want.shape == (3, 2, *want.shape[2:])
    assert np.array_equal(got.numpy(), want)
    qwen = SimpleNamespace(cfg=get_reduced("qwen3-4b"), batch=2, n_clients=3,
                           device=torch.device("cpu"))
    assert LMClients._prefix(qwen, 0, 2) is None


# ---------------------------------------------------------------------------
# (b) sessions, round by round

SESSIONS = {      # name: (arch, strategy factory, participation, rounds)
    "llava-dml": (LLAVA, lambda m: m.DML(), 0, 2),
    "llava-dml-partial": (LLAVA, lambda m: m.DML(), 2, 2),
    "musicgen-dml": (MUSICGEN, lambda m: m.DML(), 0, 2),
    "musicgen-dml-partial": (MUSICGEN, lambda m: m.DML(), 2, 2),
    "musicgen-sparse": (MUSICGEN, lambda m: m.SparseDML(k=8), 0, 1),
    "musicgen-fedavg": (MUSICGEN, lambda m: m.FedAvg(), 0, 1),
    "musicgen-async": (MUSICGEN,
                       lambda m: m.AsyncWeights(delta=2, min_round=0), 0, 1),
}


class _Jax:
    DML, SparseDML, FedAvg, AsyncWeights = (JDML, JSparseDML, JFedAvg,
                                            JAsyncWeights)


class _Port:
    DML, SparseDML, FedAvg, AsyncWeights = DML, SparseDML, FedAvg, \
        AsyncWeights


def _population(mod, arch, rounds, **kw):
    get = jget_reduced if mod is _Jax else get_reduced
    make = JLMClients if mod is _Jax else LMClients
    return make(get(arch), n_clients=3, rounds=rounds, batch=2, seq=16,
                seed=0, **kw)


@pytest.fixture(scope="module")
def jax_sessions():
    """The JAX sessions (run once), with the state they started from; the
    DML ones evaluated after their last round."""
    out = {}
    for name, (arch, make, part, rounds) in SESSIONS.items():
        pop = _population(_Jax, arch, rounds, kernel_impl="ref")
        start = _jax_numpy(pop.state_dict())
        fed = JFederation(pop, make(_Jax), participation=part)
        fed.run()
        if name.endswith("dml"):
            fed.evaluate()
        out[name] = (start, fed)
    return out


def _port_session(name, start):
    arch, make, part, rounds = SESSIONS[name]
    pop = _population(_Port, arch, rounds, device="cpu")
    pop.load_state_dict(interop.params_from_numpy(start, device="cpu"), {})
    fed = Federation(pop, make(_Port), participation=part)
    fed.run()
    return fed


@pytest.mark.parametrize("name", list(SESSIONS))
def test_session_matches_jax_round_by_round(jax_sessions, name):
    """K=3 reduced sessions from JAX-initialised params, the projector
    among them: participants, comm bytes, the async layer, per-round
    losses, the final params and AdamW moments, and (full-participation
    DML) ``evaluate``'s per-client loss on the 777_000 batch and prefix."""
    start, jfed = jax_sessions[name]
    fed = _port_session(name, start)
    rounds = SESSIONS[name][3]
    assert len(fed.history.rounds) == len(jfed.history.rounds) == rounds
    for got, want in zip(fed.history.rounds, jfed.history.rounds):
        assert got.participants == want.participants
        assert got.comm_bytes == want.comm_bytes > 0
        assert got.layer == want.layer
        _close(got.client_loss, want.client_loss, atol=2e-5, rtol=0)
        for key in ("kl_loss", "public_ce"):
            if getattr(want, key) is None:
                assert getattr(got, key) is None
            else:
                _close(getattr(got, key), getattr(want, key), atol=2e-5,
                       rtol=0)
    assert fed.history.total_comm_bytes == jfed.history.total_comm_bytes
    _trees_close(fed.population.state_dict(), jfed.population.state_dict(),
                 atol=1e-4, rtol=0)
    if name.endswith("dml"):
        got = fed.evaluate().client_eval_loss
        _close(got, jfed.history.client_eval_loss, atol=2e-5, rtol=0)
    if name.endswith("async"):    # shallow: the projector synced
        w = fed.population.client_params["projector"]["w"]
        assert fed.history.rounds[0].layer == "shallow"
        assert torch.equal(w[0], w[1]) and torch.equal(w[1], w[2])


# ---------------------------------------------------------------------------
# (c) checkpoints cross between the packages

def test_save_state_restores_across_packages(jax_sessions, tmp_path):
    """A JAX llava ``save_state`` restores into a port session and a port
    one into a JAX session, the ``projector`` leaves (params and both
    moments) among the rest."""
    start, jfed = jax_sessions["llava-dml"]
    jfed.save_state(str(tmp_path / "from_jax"))
    pop = _population(_Port, LLAVA, 2, device="cpu")
    fed = Federation(pop, DML())
    fed.restore_state(str(tmp_path / "from_jax"))
    keys = set(flatten(pop.state_dict()))
    assert {"client_params/projector/w", "client_opts/mu/projector/b",
            "client_opts/nu/projector/w"} <= keys
    _trees_close(pop.state_dict(), jfed.population.state_dict(), atol=0,
                 rtol=0)
    assert fed.round == 2

    fed = _port_session("llava-dml", start)
    fed.save_state(str(tmp_path / "from_torch"))
    jpop = _population(_Jax, LLAVA, 2, kernel_impl="ref")
    jf = JFederation(jpop, JDML())
    jf.restore_state(str(tmp_path / "from_torch"))
    _trees_close(fed.population.state_dict(), jpop.state_dict(), atol=0,
                 rtol=0)
    assert jf.round == 2
    assert jf.history.total_comm_bytes == fed.history.total_comm_bytes
