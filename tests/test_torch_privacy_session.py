"""The port's ``VisionClients`` sessions under the privacy and robustness
strategies against the JAX package's on the CPU, round by round: DPDML,
TrimmedDML and MedianDML with collude, sign-flip and label-flip clients,
with 3 of 4 clients (an absent byzantine client bitwise untouched); the
payload tap (``record_payloads``) a bitwise no-op with the JAX package's
payloads and folds; epsilon after each round; comm bytes equal to DML's;
DP checkpoints crossing both ways, the port's bitwise resume and the knob
mismatch refused; the refusals.

The noise seam: in this file only, the port's ``DPDML._advance`` is
replaced by the JAX package's key chain (``jax.random.split`` of the same
uint32 words, then ``split(sub, E)``) and ``repro_torch.privacy.dp.
gaussian`` by ``jax.random.normal(words, shape, float32)``, so both
packages draw the same noise.  Both populations run at ``dropout_rate=0``
and the port's loads the JAX one's state.  Tolerances, fp32, those of
``tests/test_torch_vision_session.py``: per-round losses atol 1e-4, params
atol 1e-4, velocities atol 1e-4 / lr; payloads atol 1e-5.  The JAX
sessions run once per module (a fixture).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import DML as JDML
from repro.api import DPDML as JDPDML
from repro.api import Federation as JFederation
from repro.api import MedianDML as JMedianDML
from repro.api import TrimmedDML as JTrimmedDML
from repro.api import VisionClients as JVisionClients
from repro.configs.visionnet import reduced as jreduced
from repro_torch import interop
from repro_torch.api import (DML, DPDML, Federation, LMClients, MedianDML,
                             TrimmedDML, VisionClients, get_strategy)
from repro_torch.checkpoint import flatten
from repro_torch.configs import get_reduced
from repro_torch.configs.visionnet import reduced
from repro_torch.data.federated import sample_participants
from repro_torch.privacy import dp as dp_mod

torch.set_num_threads(1)
LR = 0.05
K = 4
KW = dict(n_clients=K, rounds=2, local_epochs=1, batch_size=8, lr=LR,
          eval_batch=64, seed=3)
SIZE = 16


def jax_advance(self):
    """The JAX package's DPDML key step on the port's key words."""
    key, sub = jax.random.split(jnp.asarray(self._noise_key, jnp.uint32))
    keys = jax.random.split(sub, self.mutual_epochs)
    return np.asarray(key, np.uint32), np.asarray(keys, np.uint32)


def jax_gaussian(words, shape, device):
    return torch.from_numpy(np.array(jax.random.normal(
        jnp.asarray(np.asarray(words, np.uint32)), tuple(shape),
        jnp.float32))).to(device)


@pytest.fixture
def seam(monkeypatch):
    monkeypatch.setattr(DPDML, "_advance", jax_advance)
    monkeypatch.setattr(dp_mod, "gaussian", jax_gaussian)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    y = (rng.random(260) > 0.5).astype(np.float32)
    x = rng.normal(size=(260, SIZE, SIZE, 3)).astype(np.float32)
    x += (y * 2 - 1)[:, None, None, None] * 0.3
    return x, y


def _jax_pop(data, **kw):
    return JVisionClients(jreduced().replace(image_size=SIZE,
                                             dropout_rate=0.0), *data,
                          **KW, **kw)


def _port_pop(data, **kw):
    return VisionClients(reduced().replace(image_size=SIZE,
                                           dropout_rate=0.0), *data,
                         device="cpu", **KW, **kw)


def _numpy_state(pop):
    return jax.tree.map(np.asarray, pop.state_dict())


def _state_close(got: dict, want: dict, atol=1e-4):
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


def _round_close(g, w):
    assert (g.round, g.comm_bytes, g.layer, g.participants) == \
        (w.round, w.comm_bytes, w.layer, w.participants)
    np.testing.assert_allclose(g.client_loss, w.client_loss, rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(g.kl_loss, w.kl_loss, rtol=0, atol=1e-4)


# (strategy makers, byzantine map, participation)
CASES = {
    "dp_collude": (lambda: JDPDML(dp_noise_multiplier=1.0),
                   lambda: DPDML(dp_noise_multiplier=1.0), {3: "collude"},
                   0),
    "trimmed_sign_flip": (lambda: JTrimmedDML(trim=1),
                          lambda: TrimmedDML(trim=1), {1: "sign-flip"}, 0),
    "median_label_flip": (JMedianDML, MedianDML, {2: "label-flip"}, 0),
    "dp_3_of_4": (lambda: JDPDML(dp_noise_multiplier=1.0, mutual_epochs=2),
                  lambda: DPDML(dp_noise_multiplier=1.0, mutual_epochs=2),
                  {0: "collude"}, 3),
    "trimmed_3_of_4": (lambda: JTrimmedDML(trim=1),
                       lambda: TrimmedDML(trim=1), {0: "sign-flip"}, 3),
}


@pytest.fixture(scope="module")
def jax_sessions(data):
    """Per case: the JAX population's initial state and meta, its state
    after each round, its history and its epsilons."""
    out = {}
    for name, (jmake, _, byz, part) in CASES.items():
        pop = _jax_pop(data, byzantine=byz)
        init = (_numpy_state(pop), pop.meta_dict())
        fed = JFederation(pop, jmake(), participation=part)
        states, eps = [], []
        for r in range(KW["rounds"]):
            fed.run(until=r + 1)
            states.append(_numpy_state(pop))
            eps.append(getattr(fed.strategy, "epsilon", lambda: None)())
        out[name] = dict(init=init, states=states, history=fed.history,
                         eps=eps)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_session_matches_jax_round_by_round(data, jax_sessions, seam, name):
    want = jax_sessions[name]
    _, make, byz, part = CASES[name]
    pop = _port_pop(data, byzantine=byz)
    state, meta = want["init"]
    pop.load_state_dict(interop.params_from_numpy(state, device="cpu"), meta)
    fed = Federation(pop, make(), participation=part)
    absent_checked = False
    for r in range(KW["rounds"]):
        part_r = fed.participants(r)
        before = {k: v.clone() for k, v in flatten(
            {"p": pop.client_params, "o": pop.client_opts}).items()}
        fed.run(until=r + 1)
        _round_close(fed.history.rounds[-1], want["history"].rounds[r])
        _state_close(pop.state_dict(), want["states"][r])
        if name.startswith("dp"):
            assert fed.strategy.epsilon() == want["eps"][r]
        for c in set(range(K)) - set(part_r):
            # the absent client (the byzantine one where the draw leaves
            # it out) rides through bitwise untouched
            after = flatten({"p": pop.client_params, "o": pop.client_opts})
            for k, v in before.items():
                if "step" not in k:
                    assert torch.equal(after[k][c], v[c]), k
            absent_checked |= c in byz
    assert fed.history.total_comm_bytes == \
        want["history"].total_comm_bytes
    if part:
        assert absent_checked


def test_absent_byzantine_round_exists():
    """The 3-of-4 cases' draw leaves client 0, the byzantine one, out of
    a round (so the bitwise check above covers it)."""
    assert any(0 not in sample_participants(K, 3, KW["seed"], r)
               for r in range(KW["rounds"]))


def test_payload_tap_is_a_bitwise_no_op_with_jaxs_payloads(data):
    """``record_payloads`` on plain DML: the same bits as without it, and
    the tapped payloads and fold indices equal the JAX package's."""
    jpop = _jax_pop(data, record_payloads=True)
    state = (_numpy_state(jpop), jpop.meta_dict())
    JFederation(jpop, JDML(mutual_epochs=2)).run()
    runs = []
    for tap in (False, True):
        pop = _port_pop(data, record_payloads=tap)
        pop.load_state_dict(interop.params_from_numpy(state[0],
                                                      device="cpu"),
                            state[1])
        Federation(pop, DML(mutual_epochs=2)).run()
        runs.append(pop)
    plain, tapped = (flatten({"p": p.client_params, "o": p.client_opts})
                     for p in runs)
    assert all(torch.equal(plain[k], tapped[k]) for k in plain)
    log, jlog = runs[1].payload_log, jpop.payload_log
    assert len(log) == len(jlog) == KW["rounds"] and not runs[0].payload_log
    for a, b in zip(log, jlog):
        assert a["round"] == b["round"]
        assert np.array_equal(a["public"], b["public"])
        assert a["payloads"].shape == b["payloads"].shape == \
            (2, K, len(b["public"]))
        np.testing.assert_allclose(a["payloads"], b["payloads"], rtol=0,
                                   atol=1e-5)
    assert len(runs[1].fold_log) == len(jpop.fold_log) == KW["rounds"]
    for a, b in zip(runs[1].fold_log, jpop.fold_log):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_comm_bytes_equal_dmls(data):
    """Noise and robust combining are free on the wire."""
    runs = {}
    for name, knobs in [("dml", {}), ("dp-dml", {"dp_noise_multiplier": 1.0}),
                        ("trimmed-dml", {"trim": 1}), ("median-dml", {})]:
        fed = Federation(_port_pop(data), get_strategy(
            name, mutual_epochs=2, **knobs))
        fed.run()
        runs[name] = fed.history.total_comm_bytes
    assert runs["dml"] > 0 and len(set(runs.values())) == 1, runs


def test_dp_checkpoints_cross_both_ways(data, seam, tmp_path):
    """A JAX DP-DML session saved after round 1 restores in the port,
    whose round 2 matches JAX's; the port's session saved after round 1
    restores in JAX, whose round 2 matches the port's."""
    jfed = JFederation(_jax_pop(data), JDPDML(dp_noise_multiplier=1.0))
    jfed.run(until=1)
    jfed.save_state(str(tmp_path / "jax"))
    fed = Federation(_port_pop(data), DPDML(dp_noise_multiplier=1.0))
    fed.restore_state(str(tmp_path / "jax"))
    assert fed.round == 1 and fed.strategy.epsilon() == \
        jfed.strategy.epsilon()
    fed.run()
    jfed.run()
    _round_close(fed.history.rounds[1], jfed.history.rounds[1])
    _state_close(fed.population.state_dict(), _numpy_state(jfed.population))
    assert fed.strategy.epsilon() == jfed.strategy.epsilon()
    assert fed.strategy.state_dict() == jfed.strategy.state_dict()
    # port -> JAX
    jpop = _jax_pop(data)
    pop = _port_pop(data)
    pop.load_state_dict(interop.params_from_numpy(_numpy_state(jpop),
                                                  device="cpu"),
                        jpop.meta_dict())
    pfed = Federation(pop, DPDML(dp_noise_multiplier=1.0))
    pfed.run(until=1)
    pfed.save_state(str(tmp_path / "port"))
    jfed2 = JFederation(_jax_pop(data), JDPDML(dp_noise_multiplier=1.0))
    jfed2.restore_state(str(tmp_path / "port"))
    assert jfed2.strategy.state_dict() == pfed.strategy.state_dict()
    jfed2.run()
    pfed.run()
    _round_close(pfed.history.rounds[1], jfed2.history.rounds[1])
    _state_close(pop.state_dict(), _numpy_state(jfed2.population))


@pytest.mark.parametrize("name", ["dp-dml", "trimmed-dml"])
def test_port_resume_is_bitwise_and_refuses_a_knob_mismatch(data, tmp_path,
                                                            name):
    """With the port's own draws: one round, a checkpoint and a fresh
    session's second round give the uninterrupted run's bits (the noise
    key, accountant and comm ledger included)."""
    knobs = {"dp_noise_multiplier": 1.0, "dp_clip": 2.0} \
        if name == "dp-dml" else {"trim": 1}
    mk = lambda: get_strategy(name, mutual_epochs=2, **knobs)  # noqa: E731
    byz = {3: "collude"}
    whole = Federation(_port_pop(data, byzantine=byz), mk())
    whole.run()
    half = Federation(_port_pop(data, byzantine=byz), mk())
    half.run(until=1)
    path = str(tmp_path / "ck")
    half.save_state(path)
    resumed = Federation(_port_pop(data, byzantine=byz), mk())
    resumed.restore_state(path)
    resumed.run()
    a, b = (flatten(f.population.state_dict()) for f in (whole, resumed))
    assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert whole.history.rounds[1] == resumed.history.rounds[1]
    if name == "dp-dml":
        assert resumed.strategy.state_dict() == whole.strategy.state_dict()
        other = Federation(_port_pop(data, byzantine=byz),
                           DPDML(dp_noise_multiplier=2.0, dp_clip=2.0))
        with pytest.raises(ValueError, match="dp_noise_multiplier"):
            other.restore_state(path)


def test_lm_clients_refuse_the_privacy_strategies():
    pop = LMClients(get_reduced("qwen3-4b"), n_clients=2, rounds=1, batch=2,
                    seq=8, device="cpu")
    for name in ("dp-dml", "trimmed-dml", "median-dml"):
        with pytest.raises(ValueError, match="does not support strategy"):
            Federation(pop, get_strategy(name))
