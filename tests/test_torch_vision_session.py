"""The port's ``VisionClients`` sessions against the JAX package's on the
CPU: DML, FedAvg and AsyncWeights, with full participation and with 2 of
3 clients, round by round; checkpoints crossing in both directions; the
port's own save/restore; the refusals; the ``launch.visionnet`` CLI.

Both populations are built with ``dropout_rate=0`` (the JAX forward is
then exact: every keep mask is all ones), and the port's loads the JAX
one's ``state_dict()``/``meta_dict()``, so both start from the same
params, fold cursor and plan seed.  Tolerances, fp32: per-round
client_loss / kl_loss atol 1e-4; params atol 1e-4 (SGD with momentum over
the rounds' steps; the convolutions sum in another order) and the SGD
velocities atol 1e-4 / lr = 2e-3, the velocity error that moves a param by
1e-4 in one step (the global model's retraining in an async round crosses
a ReLU / max-pool kink on one steep batch, where a 1e-6 difference of the
params moves its velocity by 4.6e-4 and its params by 2e-5); comm bytes,
steps and ``dispatch_log`` exactly; the final accuracies within one
example of the unseen set.  The JAX sessions run once per module (a
fixture).
"""
import types

import jax
import numpy as np
import pytest
import torch

from repro.api import DML as JDML
from repro.api import AsyncWeights as JAsyncWeights
from repro.api import FedAvg as JFedAvg
from repro.api import Federation as JFederation
from repro.api import VisionClients as JVisionClients
from repro.configs.visionnet import reduced as jreduced
from repro.data.synthetic import make_paper_datasets
from repro_torch import interop
from repro_torch.api import (DML, AsyncWeights, FedAvg, Federation,
                             SparseDML, VisionClients)
from repro_torch.checkpoint import flatten
from repro_torch.configs.visionnet import reduced
from repro_torch.launch import visionnet as cli

torch.set_num_threads(1)
LR = 0.05
KW = dict(n_clients=3, rounds=2, local_epochs=2, batch_size=8, lr=LR,
          eval_batch=64)
N_TEST = 100
STRATEGIES = {
    "dml": (lambda: JDML(kl_weight=1.0), lambda: DML(kl_weight=1.0)),
    "fedavg": (JFedAvg, FedAvg),
    # delta=2, min_round=0: round 0 syncs the shallow group, round 1 the
    # deep one
    "async": (lambda: JAsyncWeights(delta=2, min_round=0),
              lambda: AsyncWeights(delta=2, min_round=0)),
}


@pytest.fixture(scope="module")
def data():
    return make_paper_datasets(image_size=32, n_train=300, n_test=N_TEST)


def _jax_pop(data):
    (tx, ty), _ = data
    return JVisionClients(jreduced().replace(dropout_rate=0.0), tx, ty, **KW)


def _port_pop(data, dropout=0.0):
    (tx, ty), _ = data
    return VisionClients(reduced().replace(dropout_rate=dropout), tx, ty,
                         device="cpu", **KW)


def _numpy_state(pop):
    return jax.tree.map(np.asarray, pop.state_dict())


def _load_jax(port_pop, jax_pop):
    port_pop.load_state_dict(
        interop.params_from_numpy(_numpy_state(jax_pop), device="cpu"),
        jax_pop.meta_dict())


def _state_close(got: dict, want: dict, atol=1e-4):
    """Params (atol), velocities (atol / lr) and steps (exactly) of two
    state_dicts, leaf by leaf; the PRNG key is each package's own."""
    got = {k: v.detach().numpy() for k, v in flatten(got).items()
           if k != "key"}
    want = {k: np.asarray(v) for k, v in flatten(want).items() if k != "key"}
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if "step" in key:
            assert np.array_equal(got[key], w), key
        else:
            tol = atol / LR if "/vel/" in key else atol
            np.testing.assert_allclose(got[key], w, rtol=0, atol=tol,
                                       err_msg=key)


def _rounds_close(got, want):
    for g, w in zip(got, want):
        assert (g.round, g.comm_bytes, g.layer, g.participants) == \
            (w.round, w.comm_bytes, w.layer, w.participants)
        np.testing.assert_allclose(g.client_loss, w.client_loss, rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(g.kl_loss, w.kl_loss, rtol=0, atol=1e-4)
    assert len(got) == len(want)


@pytest.fixture(scope="module")
def jax_sessions(data):
    """Per (strategy, participation): the JAX population's initial state
    and meta, its state after each round, its history, dispatch log and
    final accuracies on the unseen set."""
    out = {}
    for name, (jmake, _) in STRATEGIES.items():
        for part in (0, 2):
            pop = _jax_pop(data)
            init = (_numpy_state(pop), pop.meta_dict())
            fed = JFederation(pop, jmake(), participation=part)
            states = []
            for r in range(KW["rounds"]):
                fed.run(until=r + 1)
                states.append(_numpy_state(pop))
            h = fed.evaluate(split=data[1])
            out[name, part] = dict(init=init, states=states, history=h,
                                   log=list(fed.dispatch_log))
    return out


@pytest.mark.parametrize("part", [0, 2], ids=["full", "two_of_three"])
@pytest.mark.parametrize("name", list(STRATEGIES))
def test_session_matches_jax_round_by_round(data, jax_sessions, name,
                                            part):
    want = jax_sessions[name, part]
    pop = _port_pop(data)
    state, meta = want["init"]
    pop.load_state_dict(interop.params_from_numpy(state, device="cpu"),
                        meta)
    fed = Federation(pop, STRATEGIES[name][1](), participation=part)
    for r in range(KW["rounds"]):
        fed.run(until=r + 1)
        _state_close(pop.state_dict(), want["states"][r])
    h = fed.evaluate(split=data[1])
    jh = want["history"]
    _rounds_close(h.rounds, jh.rounds)
    assert h.total_comm_bytes == jh.total_comm_bytes
    assert fed.dispatch_log == want["log"]
    for a, b in zip(h.client_test_acc + [h.global_test_acc],
                    jh.client_test_acc + [jh.global_test_acc]):
        assert abs(a - b) * N_TEST <= 1.0 + 1e-9
    assert len(h.client_test_acc) == KW["n_clients"]
    if part:
        assert all(len(rl.participants) == part for rl in h.rounds)


@pytest.mark.parametrize("name", list(STRATEGIES))
def test_jax_checkpoint_resumes_in_the_port(data, tmp_path, name):
    """A JAX session saved after round 1, restored by the port; round 2 of
    both against each other."""
    jmake, make = STRATEGIES[name]
    jfed = JFederation(_jax_pop(data), jmake())
    jfed.run(until=1)
    jfed.save_state(str(tmp_path / "ck"))
    fed = Federation(_port_pop(data), make())
    fed.restore_state(str(tmp_path / "ck"))
    assert fed.round == 1 and fed.history.total_comm_bytes == \
        jfed.history.total_comm_bytes
    fed.run()
    jfed.run()
    _rounds_close(fed.history.rounds[1:], jfed.history.rounds[1:])
    _state_close(fed.population.state_dict(), _numpy_state(jfed.population))


@pytest.mark.parametrize("name", list(STRATEGIES))
def test_port_checkpoint_resumes_in_jax(data, tmp_path, name):
    """The reverse: the port (from the JAX init) saves after round 1, a
    fresh JAX session restores it, and round 2 runs in both."""
    jmake, make = STRATEGIES[name]
    jpop = _jax_pop(data)
    pop = _port_pop(data)
    _load_jax(pop, jpop)
    fed = Federation(pop, make())
    fed.run(until=1)
    fed.save_state(str(tmp_path / "ck"))
    jfed = JFederation(_jax_pop(data), jmake())
    jfed.restore_state(str(tmp_path / "ck"))
    key = np.asarray(jax.random.key_data(jfed.population.key)
                     if jax.dtypes.issubdtype(jfed.population.key.dtype,
                                              jax.dtypes.prng_key)
                     else jfed.population.key)
    assert key.dtype == np.uint32 and np.array_equal(key, pop.key)
    jfed.run()
    fed.run()
    _rounds_close(fed.history.rounds[1:], jfed.history.rounds[1:])
    _state_close(pop.state_dict(), _numpy_state(jfed.population))


def test_port_save_restore_equals_an_uninterrupted_run(data, tmp_path):
    """With the paper's dropout on: 2 rounds in one go, and 1 round, a
    checkpoint and a fresh session's round 2, give the same bits."""
    whole = Federation(_port_pop(data, dropout=0.5), DML())
    whole.run()
    first = Federation(_port_pop(data, dropout=0.5), DML())
    first.run(until=1)
    first.save_state(str(tmp_path / "ck"))
    resumed = Federation(_port_pop(data, dropout=0.5), DML())
    resumed.restore_state(str(tmp_path / "ck"))
    resumed.run()
    a, b = flatten(whole.population.state_dict()), \
        flatten(resumed.population.state_dict())
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert whole.history.rounds[1] == resumed.history.rounds[1]
    # dropout is live: the same session without it trains other params
    plain = Federation(_port_pop(data), DML())
    plain.run(until=1)
    assert not torch.equal(plain.population.client_params["dense"]["w"],
                           first.population.client_params["dense"]["w"])


def test_refusals(data):
    (tx, ty), _ = data
    pop = _port_pop(data)
    with pytest.raises(ValueError, match="sparse-dml needs a categorical"):
        Federation(pop, SparseDML(k=4))
    # the privacy strategies are accepted, as in the JAX package; a
    # byzantine map is checked with its messages
    for name in ("dp-dml", "trimmed-dml", "median-dml"):
        assert Federation(pop, types.SimpleNamespace(name=name))
    for kw, match in ((dict(byzantine={7: "sign-flip"}), "out of range"),
                      (dict(byzantine={0: "firehose"}), "unknown byzantine")):
        with pytest.raises(ValueError, match=match):
            VisionClients(reduced(), tx, ty, device="cpu", **kw)
    with pytest.raises(ValueError, match="mesh needs a 'clients' axis"):
        VisionClients(reduced(), tx, ty, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="held-out dataset"):
        Federation(pop, DML()).evaluate()
    with pytest.raises(ValueError, match="checkpoint schedule"):
        pop.check_meta({**pop.meta_dict(), "n_rounds": 5})


def test_default_device_is_the_card(data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    (tx, ty), _ = data
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VisionClients(reduced(), tx[:40], ty[:40], n_clients=2, rounds=1)


def test_visionnet_cli_on_cpu(capsys):
    assert cli.main(["--fast", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "dataset1 (train): 900  dataset2 (unseen test): 300" in out
    assert "paper Table II analogue" in out
    for name in cli.NAMES.values():
        assert name in out
    ratio = float(out.split("DML uses ")[1].split("x")[0])
    assert ratio > 100
