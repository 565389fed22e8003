"""The port's ``HeteroClients`` under the privacy and robustness
strategies against the JAX package's on the CPU, round by round: a reduced
fleet of four (qwen3-4b, mamba2-780m, qwen3-4b, dbrx-132b: J = 3 received
stacks, where the robust combiners trim) with a sign-flipping client 3
under DPDML, TrimmedDML(trim=1) and MedianDML, then a colluding client 0
under DML; the payload tap against the JAX package's; epsilon; comm
bytes equal to DML's; a VisionNet fleet with label-flip and sign-flip
clients; the refusals; the CLI's privacy lines.

One JAX population runs the four rounds in turn (its byzantine map is
switched to {0: "collude"} before the last, in this test only); the port's
population, built with the round's map, loads the JAX state before the
round under test and runs the same round.  The noise seam of
``tests/test_torch_privacy_session.py`` gives both packages the same DP
draws.  Tolerances, fp32, those of ``tests/test_torch_hetero_session.py``:
per-round losses, KL and public CE atol 2e-5; params atol 1e-4; the
tapped payloads atol 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import DML as JDML
from repro.api import DPDML as JDPDML
from repro.api import Federation as JFederation
from repro.api import HeteroClients as JHeteroClients
from repro.api import MedianDML as JMedianDML
from repro.api import TrimmedDML as JTrimmedDML
from repro_torch import interop
from repro_torch.api import (DML, DPDML, Federation, HeteroClients,
                             MedianDML, TrimmedDML, comm_bytes_per_round,
                             make_lm_pool)
from repro_torch.checkpoint import flatten
from repro_torch.configs.visionnet import reduced as vn_reduced
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.launch import train as cli
from repro_torch.privacy import dp as dp_mod

torch.set_num_threads(1)
ARCHS = ("qwen3-4b", "mamba2-780m", "qwen3-4b", "dbrx-132b")
KW = dict(rounds=4, local_epochs=1, batch_size=4, public_batch=2, lr=1e-3,
          seed=0)
N_POOL = ((1 + len(ARCHS)) * 4 + 1) * 8
# (name, JAX strategy, port strategy, byzantine map)
PLAN = [("dp", JDPDML(dp_noise_multiplier=1.0),
         DPDML(dp_noise_multiplier=1.0), {3: "sign-flip"}),
        ("trimmed", JTrimmedDML(trim=1), TrimmedDML(trim=1),
         {3: "sign-flip"}),
        ("median", JMedianDML(), MedianDML(), {3: "sign-flip"}),
        ("collude_dml", JDML(), DML(), {0: "collude"})]


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


def _numpy_state(pop):
    return jax.tree.map(np.asarray, pop.state_dict())


def _load(pop, state, meta):
    pop.load_state_dict(interop.params_from_numpy(state, device="cpu"), meta)


def _state_close(got: dict, want: dict, atol=1e-4):
    got = {k: v.detach().numpy() for k, v in flatten(got).items()}
    want = {k: np.asarray(v) for k, v in flatten(want).items()}
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if key.endswith("step"):
            assert np.array_equal(got[key], w), key
        elif "/params/" in key:
            np.testing.assert_allclose(got[key], w, rtol=0, atol=atol,
                                       err_msg=key)


def _round_close(g, w):
    assert (g.round, g.comm_bytes, g.layer, g.participants) == \
        (w.round, w.comm_bytes, w.layer, w.participants)
    for field in ("client_loss", "kl_loss", "public_ce"):
        np.testing.assert_allclose(getattr(g, field), getattr(w, field),
                                   rtol=0, atol=2e-5, err_msg=field)


@pytest.fixture(scope="module")
def pool():
    return make_lm_pool(N_POOL, 16, 512, seed=0)


@pytest.fixture(scope="module")
def jax_fleet(pool):
    """The JAX fleet's state and meta before each round of PLAN and after
    the last, each round's log and payload entries, and DP-DML's epsilon.
    The DP round's draws come from the JAX package itself."""
    pop = JHeteroClients(ARCHS, *pool, byzantine=PLAN[0][3],
                         record_payloads=True, **KW)
    states = [(_numpy_state(pop), pop.meta_dict())]
    logs, eps = [], None
    for r, (_, jstrat, _, byz) in enumerate(PLAN):
        pop.byzantine = dict(byz)
        fed = JFederation(pop, jstrat)
        fed.round = r
        logs.append(fed.run(until=r + 1).rounds[-1])
        states.append((_numpy_state(pop), pop.meta_dict()))
        if r == 0:
            eps = fed.strategy.epsilon()
    return dict(states=states, logs=logs, eps=eps,
                payloads=list(pop.payload_log))


@pytest.mark.parametrize("r", range(len(PLAN)),
                         ids=[p[0] for p in PLAN])
def test_fleet_round_matches_jax(pool, jax_fleet, seam, r):
    name, _, strat, byz = PLAN[r]
    pop = HeteroClients(ARCHS, *pool, byzantine=byz, record_payloads=True,
                        device="cpu", **KW)
    _load(pop, *jax_fleet["states"][r])
    fed = Federation(pop, strat)
    fed.round = r
    rl = fed.run(until=r + 1).rounds[-1]
    _round_close(rl, jax_fleet["logs"][r])
    _state_close(pop.state_dict(), jax_fleet["states"][r + 1][0])
    assert pop.meta_dict() == jax_fleet["states"][r + 1][1]
    assert rl.comm_bytes == comm_bytes_per_round(4, 2 * 16, 512, 1)["round"]
    (got,) = pop.payload_log
    (want,) = [p for p in jax_fleet["payloads"] if p["round"] == r]
    assert (got["round"], got["epoch"], got["part"]) == \
        (want["round"], want["epoch"], want["part"])
    assert np.array_equal(got["public"], want["public"])
    assert got["payloads"].device.type == "cpu"
    np.testing.assert_allclose(got["payloads"].numpy(), want["payloads"],
                               rtol=0, atol=2e-5)
    if name == "dp":
        assert fed.strategy.epsilon() == jax_fleet["eps"]
    if name == "collude_dml":
        # the colluder's row: 8.0 at (label + 1) % V of the first N_pub
        # positions, 0 elsewhere
        row = got["payloads"][0]
        assert float(row.sum()) == 8.0 * 2 and float(row.max()) == 8.0


def test_vision_fleet_with_flippers_matches_jax(monkeypatch, seam):
    """Three VisionNet clients at dropout 0, client 1 flipping its local
    labels and client 2 sign-flipping what it shares, under MedianDML and
    then DPDML, against the JAX fleet (its reduced config patched to
    dropout 0 in this test only)."""
    import repro.configs.visionnet as jvn
    jcfg = jvn.reduced().replace(dropout_rate=0.0, image_size=16)
    monkeypatch.setattr(jvn, "reduced", lambda: jcfg)
    images, labels = make_image_dataset(90, image_size=16, seed=1)
    byz = {1: "label-flip", 2: "sign-flip"}
    kw = dict(KW, rounds=2, public_batch=4)
    jpop = JHeteroClients(("visionnet",) * 3, images, labels, byzantine=byz,
                          **kw)
    cfg = vn_reduced().replace(dropout_rate=0.0, image_size=16)
    pop = HeteroClients((cfg,) * 3, images, labels, byzantine=byz,
                        device="cpu", **kw)
    _load(pop, _numpy_state(jpop), jpop.meta_dict())
    for r, (jstrat, strat) in enumerate(((JMedianDML(), MedianDML()),
                                         (JDPDML(), DPDML()))):
        jfed, fed = JFederation(jpop, jstrat), Federation(pop, strat)
        jfed.round = fed.round = r
        _round_close(fed.run(until=r + 1).rounds[-1],
                     jfed.run(until=r + 1).rounds[-1])
        _state_close(pop.state_dict(), _numpy_state(jpop))


def test_refusals_match_jax(pool):
    """label-flip on LM clients, with the JAX package's message."""
    with pytest.raises(ValueError) as got:
        HeteroClients(ARCHS, *pool, byzantine={0: "label-flip"},
                      device="cpu", rounds=1)
    with pytest.raises(ValueError) as want:
        JHeteroClients(ARCHS, *pool, byzantine={0: "label-flip"}, rounds=1)
    assert str(got.value) == str(want.value).replace("—", "--")


def test_cli_privacy_lines(capsys):
    args = ["--method", "hetero", "--rounds", "2", "--seq", "16", "--batch",
            "2", "--device", "cpu"]
    assert cli.main(args + ["--strategy", "dp-dml", "--dp-epsilon",
                            "4"]) == 0
    out = capsys.readouterr().out
    assert "calibrated dp noise multiplier: sigma=" in out
    assert "over 2 releases" in out
    assert "privacy spent: epsilon=4.000 at delta=1e-05" in out
    assert cli.main(args + ["--archs", "qwen3-4b,mamba2-780m,qwen3-4b",
                            "--strategy", "median-dml", "--byzantine",
                            "2=sign-flip"]) == 0
    out = capsys.readouterr().out
    assert "federating [median-dml]" in out and "round   1" in out
