"""The port's ``HeteroClients`` sessions against the JAX package's on the
CPU, round by round: a mixed-family fleet (dense qwen3-4b, SSM
mamba2-780m, MoE dbrx-132b, reduced) under DML with full participation,
with 2 of 3 clients (the absent one bitwise untouched), with 2 mutual
epochs and under SparseDML(k=8); a one-arch fleet under FedAvg and
AsyncWeights; a VisionNet fleet at dropout 0; checkpoints crossing in both
directions, the port's own save/restore, the refusals, the default device
and the CLI.

One JAX population runs the mixed fleet's five rounds in turn (DML, DML,
DML at participation 2, DML with 2 mutual epochs, SparseDML): each JAX
population compiles its programs once, so the rounds share them.  The
port's population loads the JAX one's ``state_dict()``/``meta_dict()``
before the round under test (params, moments, fold cursor and plan seed)
and runs the same round.  The JAX sessions run once per module (a
fixture).  Tolerances, fp32, those of ``tests/test_torch_train.py``:
per-round losses, KL and public CE atol 2e-5; params atol 1e-4 (AdamW
divides each gradient by its own running RMS, so an element whose
gradient is at rounding level can move by up to lr per step in either
package; at lr 3e-3 one element of an embedding row that the round's
tokens reach only through rounding moves by 2.5e-4); the held-out eval
losses atol 2e-5 on the same params' round;
comm bytes, participants and AdamW steps exactly.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.api import DML as JDML
from repro.api import AsyncWeights as JAsyncWeights
from repro.api import FedAvg as JFedAvg
from repro.api import Federation as JFederation
from repro.api import HeteroClients as JHeteroClients
from repro.api import SparseDML as JSparseDML
from repro_torch import interop
from repro_torch.api import (DML, AsyncWeights, FedAvg, Federation,
                             HeteroClients, SparseDML, comm_bytes_per_round,
                             get_strategy, make_lm_pool)
from repro_torch.checkpoint import flatten
from repro_torch.configs.visionnet import reduced as vn_reduced
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.launch import train as cli
from repro_torch.privacy.dp import DPSpec

torch.set_num_threads(1)
ARCHS = ("qwen3-4b", "mamba2-780m", "dbrx-132b")        # dense / ssm / moe
ROUNDS = 5
# lr 1e-3, as tests/test_torch_train.py's sessions: the params' atol 1e-4
# is set against the steps AdamW takes at it
KW = dict(rounds=ROUNDS, local_epochs=1, batch_size=4, public_batch=2,
          lr=1e-3, seed=0)
# the mixed fleet's rounds: (name, JAX strategy, port strategy,
# participation)
PLAN = [("dml", JDML(), DML(), 0),
        ("dml", JDML(), DML(), 0),
        ("participation_2", JDML(), DML(), 2),
        ("mutual_epochs_2", JDML(mutual_epochs=2), DML(mutual_epochs=2), 0),
        ("sparse_k8", JSparseDML(k=8), SparseDML(k=8), 0)]
N_POOL = ((1 + len(ARCHS)) * ROUNDS + 1) * 8


def _numpy_state(pop):
    return jax.tree.map(np.asarray, pop.state_dict())


def _load(pop, state, meta):
    pop.load_state_dict(interop.params_from_numpy(state, device="cpu"), meta)


def _state_close(got: dict, want: dict, atol=1e-4):
    """Params and moments (atol) and AdamW steps (exactly), leaf by leaf."""
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
        a, b = getattr(g, field), getattr(w, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-5,
                                       err_msg=field)


@pytest.fixture(scope="module")
def pool():
    return make_lm_pool(N_POOL, 16, 512, seed=0)


@pytest.fixture(scope="module")
def jax_mixed(pool, tmp_path_factory):
    """The JAX mixed fleet's initial state and, for each round of PLAN, the
    state and meta after it and its RoundLog; the session saved by the JAX
    package after round 0; the population itself (its compiled programs)
    for the crossing test; the eval losses at the end."""
    pop = JHeteroClients(ARCHS, *pool, **KW)
    states = [(_numpy_state(pop), pop.meta_dict())]
    logs = []
    saved = str(tmp_path_factory.mktemp("jax") / "round0")
    for r, (_, jstrat, _, part) in enumerate(PLAN):
        fed = JFederation(pop, jstrat, participation=part)
        fed.round = r
        logs.append(fed.run(until=r + 1).rounds[-1])
        states.append((_numpy_state(pop), pop.meta_dict()))
        if r == 0:
            fed.save_state(saved)
    evals = fed.evaluate().client_eval_loss
    return dict(pop=pop, states=states, logs=logs, evals=evals, saved=saved)


def _port_round(pool, want, r, pop=None):
    """The port's round r of PLAN from the JAX state before it."""
    pop = pop or HeteroClients(ARCHS, *pool, device="cpu", **KW)
    _load(pop, *want["states"][r])
    _, _, strat, part = PLAN[r]
    fed = Federation(pop, strat, participation=part)
    fed.round = r
    return pop, fed, fed.run(until=r + 1).rounds[-1]


@pytest.mark.parametrize("r", range(ROUNDS),
                         ids=[f"r{r}_{p[0]}" for r, p in enumerate(PLAN)])
def test_mixed_fleet_round_matches_jax(pool, jax_mixed, r):
    """Round r of the mixed fleet from the JAX state before it: the round
    log, the params after it and the fold cursor; at participation 2 the
    absent client's params and moments are untouched, bit for bit; after
    the last round the held-out eval losses."""
    want = jax_mixed
    pop = HeteroClients(ARCHS, *pool, device="cpu", **KW)
    _load(pop, *want["states"][r])
    before = [dict((k, v.clone()) for k, v in flatten(c).items())
              for c in pop.state_dict()["clients"]]
    pop, fed, rl = _port_round(pool, want, r, pop)
    _round_close(rl, want["logs"][r])
    _state_close(pop.state_dict(), want["states"][r + 1][0])
    assert pop.meta_dict() == want["states"][r + 1][1]
    name = PLAN[r][0]
    if name == "participation_2":
        (absent,) = set(range(3)) - set(rl.participants)
        after = flatten(pop.state_dict()["clients"][absent])
        assert all(torch.equal(after[k], v) for k, v in
                   before[absent].items() if not k.endswith("step"))
        assert rl.client_loss[absent] == 0.0 and rl.kl_loss[absent] == 0.0
    if name == "mutual_epochs_2":
        d = comm_bytes_per_round(3, 2 * 16, 512, 2)
        assert rl.comm_bytes == d["round"]
    if r == ROUNDS - 1:
        np.testing.assert_allclose(fed.evaluate().client_eval_loss,
                                   want["evals"], rtol=0, atol=2e-5)


def test_checkpoints_cross_both_ways(pool, jax_mixed, tmp_path):
    """The JAX session saved after round 0 by the JAX package, restored by
    the port, whose round 1 matches JAX's; the port's session saved after
    its round 0, restored by the JAX population, whose round 1 matches its
    uninterrupted one."""
    want = jax_mixed
    fed = Federation(HeteroClients(ARCHS, *pool, device="cpu", **KW), DML())
    fed.restore_state(want["saved"])
    assert fed.round == 1 and fed.history.total_comm_bytes == \
        want["logs"][0].comm_bytes
    _round_close(fed.run(until=2).rounds[-1], want["logs"][1])
    _state_close(fed.population.state_dict(), want["states"][2][0])
    # port -> JAX
    _, pfed, _ = _port_round(pool, want, 0)
    pfed.save_state(str(tmp_path / "port"))
    jfed = JFederation(want["pop"], JDML())
    jfed.restore_state(str(tmp_path / "port"))
    assert jfed.round == 1
    _round_close(jfed.run(until=2).rounds[-1], want["logs"][1])
    _state_close(interop.params_from_numpy(_numpy_state(want["pop"]),
                                           device="cpu"),
                 want["states"][2][0])


def test_port_save_restore_equals_an_uninterrupted_run(pool, tmp_path):
    """Two rounds in one go, and one round, a checkpoint and a fresh
    session's second round, give the same bits; a population of other
    archs or another schedule refuses the checkpoint."""
    kw = dict(KW, rounds=2)
    whole = Federation(HeteroClients(ARCHS, *pool, device="cpu", **kw),
                       DML())
    whole.run()
    first = Federation(HeteroClients(ARCHS, *pool, device="cpu", **kw),
                       DML())
    first.run(until=1)
    path = str(tmp_path / "ck")
    first.save_state(path)
    resumed = Federation(HeteroClients(ARCHS, *pool, device="cpu", **kw),
                         DML())
    resumed.restore_state(path)
    resumed.run()
    a, b = flatten(whole.population.state_dict()), \
        flatten(resumed.population.state_dict())
    assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert whole.history.rounds[1] == resumed.history.rounds[1]
    assert whole.population.meta_dict() == resumed.population.meta_dict()
    for archs, kwx, match in ((("qwen3-4b", "qwen3-4b", "dbrx-132b"), kw,
                               "archs"),
                              (ARCHS, dict(kw, rounds=3), "schedule")):
        other = Federation(HeteroClients(archs, *pool, device="cpu", **kwx),
                           DML())
        with pytest.raises(ValueError, match=match):
            other.restore_state(path)


ONE_ARCH = ("qwen3-4b", "qwen3-4b")


@pytest.fixture(scope="module")
def jax_one_arch(pool):
    """A FedAvg round, then an AsyncWeights(delta=2, min_round=0) round (the
    deep group), of a one-arch JAX fleet: initial state, logs, states."""
    pop = JHeteroClients(ONE_ARCH, *pool, **dict(KW, rounds=2))
    states = [(_numpy_state(pop), pop.meta_dict())]
    logs = []
    for r, strat in enumerate((JFedAvg(), JAsyncWeights(delta=2,
                                                       min_round=0))):
        fed = JFederation(pop, strat)
        fed.round = r
        logs.append(fed.run(until=r + 1).rounds[-1])
        states.append((_numpy_state(pop), pop.meta_dict()))
    return dict(states=states, logs=logs)


def test_weight_strategies_on_one_arch_match_jax(pool, jax_one_arch):
    want = jax_one_arch
    pop = HeteroClients(ONE_ARCH, *pool, device="cpu", **dict(KW, rounds=2))
    _load(pop, *want["states"][0])
    for r, strat in enumerate((FedAvg(), AsyncWeights(delta=2,
                                                      min_round=0))):
        fed = Federation(pop, strat)
        fed.round = r
        rl = fed.run(until=r + 1).rounds[-1]
        _round_close(rl, want["logs"][r])
        _state_close(pop.state_dict(), want["states"][r + 1][0])
        if strat.name == "fedavg":
            a, b = (flatten(c["params"]) for c in
                    pop.state_dict()["clients"])
            assert all(torch.equal(a[k], b[k]) for k in a)
    assert [rl.layer for rl in want["logs"]] == [None, "deep"]


def test_vision_fleet_matches_jax(monkeypatch):
    """Three VisionNet clients at dropout 0 under DML: the port through a
    config object, the JAX package through its registry id with its
    reduced config patched here, round by round."""
    import repro.configs.visionnet as jvn
    jcfg = jvn.reduced().replace(dropout_rate=0.0)
    monkeypatch.setattr(jvn, "reduced", lambda: jcfg)
    images, labels = make_image_dataset(90, image_size=32, seed=1)
    kw = dict(KW, rounds=2, public_batch=4)
    jpop = JHeteroClients(("visionnet",) * 3, images, labels, **kw)
    cfg = vn_reduced().replace(dropout_rate=0.0)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    pop = HeteroClients((cfg,) * 3, images, labels, device="cpu", **kw)
    assert pop.meta_dict()["archs"] == ["visionnet"] * 3
    _load(pop, _numpy_state(jpop), jpop.meta_dict())
    jfed, fed = JFederation(jpop, JDML()), Federation(pop, DML())
    for r in range(2):
        _round_close(fed.run(until=r + 1).rounds[-1],
                     jfed.run(until=r + 1).rounds[-1])
        _state_close(pop.state_dict(), _numpy_state(jpop))
    np.testing.assert_allclose(fed.evaluate().client_eval_loss,
                               jfed.evaluate().client_eval_loss, rtol=0,
                               atol=2e-5)


def test_refusals(pool):
    import types
    mixed = HeteroClients(ARCHS, *pool, device="cpu", **KW)
    for strat in (FedAvg(), AsyncWeights()):
        with pytest.raises(ValueError, match="undefined across "
                                             "heterogeneous"):
            Federation(mixed, strat)
    images, labels = make_image_dataset(40, image_size=32, seed=1)
    vision = HeteroClients((vn_reduced(),) * 2, images, labels,
                           device="cpu", rounds=1)
    with pytest.raises(ValueError, match="VisionClients"):
        Federation(vision, AsyncWeights())
    for name in ("dp-dml", "trimmed-dml", "median-dml"):
        assert Federation(mixed, get_strategy(name)).strategy.name == name
    # as in the JAX package: a sparse payload takes neither the DP release
    # nor a robust combiner
    for kw in (dict(dp=DPSpec(1.0, 1.0, np.zeros((1, 2), np.uint32))),
               dict(robust=("median", 1))):
        with pytest.raises(ValueError, match="compose with neither"):
            mixed.mutual_phase(0, [0, 1, 2], np.ones(3, np.float32),
                               types.SimpleNamespace(data=np.arange(2)),
                               1.0, 1, sparse_k=4, **kw)
    with pytest.raises(ValueError, match="held-out common fold"):
        mixed.evaluate(None, split=(images, labels))


def test_default_device_is_the_card(pool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HeteroClients(ARCHS, *pool, rounds=1)


def test_hetero_cli_on_cpu(capsys, tmp_path):
    """``--method hetero``: the default mixed fleet under DML, and FedAvg
    on one arch; a byzantine map runs, and label-flip on LM clients is
    refused as the JAX package refuses it."""
    args = ["--method", "hetero", "--rounds", "1", "--seq", "16",
            "--batch", "2", "--device", "cpu"]
    assert cli.main(args + ["--save", str(tmp_path / "ck")]) == 0
    out = capsys.readouterr().out
    assert ("federating [dml]: qwen3-4b (dense), mamba2-780m (ssm), "
            "dbrx-132b (moe)") in out
    assert "round   0 participants=[0, 1, 2]" in out
    assert "held-out eval loss per client" in out
    assert (tmp_path / "ck.npz").exists()
    assert cli.main(args + ["--archs", "qwen3-4b,qwen3-4b", "--strategy",
                            "fedavg"]) == 0
    out = capsys.readouterr().out
    assert "federating [fedavg]: qwen3-4b (dense), qwen3-4b (dense)" in out
    assert cli.main(args + ["--byzantine", "0=sign-flip"]) == 0
    assert "round   0 participants=[0, 1, 2]" in capsys.readouterr().out
    with pytest.raises(ValueError, match="label-flip is undefined"):
        cli.main(args + ["--byzantine", "0=label-flip"])
