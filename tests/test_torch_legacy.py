"""The port's legacy facades, ``core.federated.FederatedTrainer`` and
``core.hetero.HeteroTrainer``, against the JAX package's on the CPU:

  - ``FederatedTrainer`` on reduced VisionNet (dropout 0, K = 3) under
    dml / fedavg / async, with all clients and with 2 of 3, 2 rounds;
  - ``HeteroTrainer`` on ``tests/test_hetero.py``'s tiny config: DML on
    (qwen3-4b, mamba2-780m) over 2 rounds, and SparseDML(k=8) on
    (qwen3-4b, mamba2-780m, dbrx-132b) at participation 2 (as that file's
    partial-participation test runs it, seed 4);
  - each facade against the port's ``Federation`` it wraps, bit for bit
    (also on a ``ClientMesh`` of two CPU entries, with non-IID folds, and
    with dropout);
  - checkpoints: the JAX facade's into the port's facade (its next round
    against the JAX facade's), the port facade's into the port's
    ``Federation`` and the reverse (continued rounds equal to the
    uninterrupted ones, bit for bit);
  - the refusals, with the JAX package's exception types and messages'
    keys, and the default device.

The port's populations load the JAX ones' ``state_dict()``/``meta_dict()``
(``interop.params_from_numpy``), so both start from the same params, fold
cursor and plan seed.  Tolerances, fp32, those of
``tests/test_torch_vision_session.py`` (VisionNet: losses and params atol
1e-4, SGD velocities 1e-4 / lr; comm bytes, steps and ``dispatch_log``
exactly; accuracies within one example of the unseen set) and
``tests/test_torch_hetero_session.py`` (the LM clients: losses, KL and
public CE atol 2e-5, params atol 1e-4, AdamW steps, comm bytes and
participants exactly).  The LM runs use lr 1e-3 instead of the config's
3e-3, as that file's sessions do: at 3e-3 an embedding element reached
only through rounding moves by 2.5e-4 under AdamW in either package.  The
JAX facades run once per module (fixtures).
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.visionnet import reduced as jreduced
from repro.core import federated as jfederated
from repro.core import hetero as jhetero
from repro.data.synthetic import make_paper_datasets
from repro_torch import interop
from repro_torch.api import Federation, HeteroClients, VisionClients
from repro_torch.checkpoint import flatten
from repro_torch.configs.visionnet import reduced
from repro_torch.core.federated import FederatedConfig, FederatedTrainer
from repro_torch.core.hetero import (HeteroConfig, HeteroHistory,
                                     HeteroRoundLog, HeteroTrainer,
                                     comm_bytes_per_round, make_lm_pool)
from repro_torch.sharding import ClientMesh

torch.set_num_threads(1)
ARCHS2 = ("qwen3-4b", "mamba2-780m")
ARCHS3 = ("qwen3-4b", "mamba2-780m", "dbrx-132b")
LR = 0.05
N_TEST = 60
# FederatedConfig's knobs of every vision run (async: round 0 syncs the
# shallow group, round 1 the deep one)
VKW = dict(n_clients=3, rounds=2, local_epochs=1, batch_size=16, lr=LR,
           delta=2, min_round=0, eval_batch=64)
VCASES = [(m, p) for m in ("dml", "fedavg", "async") for p in (0, 2)]
# the LM runs: tests/test_hetero.py's _tiny_cfg at lr 1e-3
HKW = dict(rounds=2, local_epochs=1, batch_size=2, public_batch=2, seed=0,
           lr=1e-3)
HCASES = {"dml": dict(archs=ARCHS2),
          "sparse_participation": dict(archs=ARCHS3, rounds=1,
                                       participation=2, seed=4, sparse_k=8)}


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _load_jax(trainer, state, meta):
    trainer.session.population.load_state_dict(
        interop.params_from_numpy(state, device="cpu"), meta)


def _vcfg(method, part, **kw):
    return dict(VKW, method=method, participation=part, **kw)


def _hcfg(case, **kw):
    return {**HKW, **HCASES[case], **kw}


@pytest.fixture(scope="module")
def vdata():
    return make_paper_datasets(image_size=32, n_train=300, n_test=N_TEST)


@pytest.fixture(scope="module")
def pool():
    data, labels = make_lm_pool(160, 24, 512, seed=0)
    jdata, jlabels = jhetero.make_lm_pool(160, 24, 512, seed=0)
    assert np.array_equal(data, jdata) and np.array_equal(labels, jlabels)
    return data, labels


def _run_jax(trainer, rounds, save=None):
    """The JAX facade's initial state and meta, its state after each
    round (and its session saved after round 0 when ``save``)."""
    pop = trainer.session.population
    out = dict(init=(_numpy(pop.state_dict()), pop.meta_dict()), states=[])
    for r in range(rounds):
        trainer.run(until=r + 1)
        out["states"].append(_numpy(pop.state_dict()))
        if save and r == 0:
            trainer.save_state(save)
    out["history"] = trainer.history
    return out


@pytest.fixture(scope="module")
def jax_vision(vdata, tmp_path_factory):
    (tx, ty), test = vdata
    jvn = jreduced().replace(dropout_rate=0.0)
    saved = str(tmp_path_factory.mktemp("jax_vision") / "round0")
    out = {}
    for m, p in VCASES:
        tr = jfederated.FederatedTrainer(
            jvn, jfederated.FederatedConfig(**_vcfg(m, p)), tx, ty)
        run = _run_jax(tr, VKW["rounds"],
                       save=saved if (m, p) == ("dml", 0) else None)
        run["log"] = list(tr.dispatch_log)
        run["acc"] = (lambda h: h.client_test_acc + [h.global_test_acc])(
            tr.evaluate(*test))
        out[m, p] = run
    out["saved"] = saved
    return out


@pytest.fixture(scope="module")
def jax_hetero(pool, tmp_path_factory):
    saved = str(tmp_path_factory.mktemp("jax_hetero") / "round0")
    out = {}
    for case in HCASES:
        cfg = jhetero.HeteroConfig(**_hcfg(case))
        tr = jhetero.HeteroTrainer(cfg, *pool)
        out[case] = _run_jax(tr, cfg.rounds,
                             save=saved if case == "dml" else None)
        if case == "dml":
            out[case]["evals"] = tr.evaluate().client_eval_loss
    out["saved"] = saved
    return out


# ---------------------------------------------------------------------------
# comparisons

def _vstate_close(got: dict, want: dict, atol=1e-4):
    """Params (atol), SGD velocities (atol / lr) and steps (exactly); the
    PRNG key is each package's own."""
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


def _hstate_close(got: dict, want: dict, atol=1e-4):
    """Params (atol) and AdamW steps (exactly), leaf by leaf."""
    got = {k: v.detach().numpy() for k, v in flatten(got).items()}
    want = {k: np.asarray(v) for k, v in flatten(want).items()}
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if key.endswith("step"):
            assert np.array_equal(got[key], w), key
        elif "/params/" in key:
            np.testing.assert_allclose(got[key], w, rtol=0, atol=atol,
                                       err_msg=key)


def _round_close(g, w, atol):
    assert (g.round, g.comm_bytes, g.layer, g.participants) == \
        (w.round, w.comm_bytes, w.layer, w.participants)
    for name in ("client_loss", "kl_loss", "public_ce"):
        a, b = getattr(g, name), getattr(w, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                       err_msg=name)


def _trees_equal(a, b):
    fa, fb = flatten(a), flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert torch.equal(torch.as_tensor(fa[k]), torch.as_tensor(fb[k])), k


def _sessions_equal(a, b, resumed_at=None):
    """Two sessions of the port, bit for bit: the round logs, the comm
    ledger, the population's whole state and its dispatch log (which a
    checkpoint does not carry: a session ``resumed_at`` round r logs its
    construction and the rounds from r on)."""
    assert a.history.rounds == b.history.rounds
    assert a.history.total_comm_bytes == b.history.total_comm_bytes
    _trees_equal(a.population.state_dict(), b.population.state_dict())
    assert a.population.meta_dict() == b.population.meta_dict()
    log = a.dispatch_log if resumed_at is None else \
        [e for e in a.dispatch_log if not 0 <= e[0] < resumed_at]
    assert b.dispatch_log == log


# ---------------------------------------------------------------------------
# the facades against the JAX package's

@pytest.mark.parametrize("method,part", VCASES,
                         ids=[f"{m}-{'two_of_three' if p else 'full'}"
                              for m, p in VCASES])
def test_federated_trainer_matches_jax(vdata, jax_vision, method, part):
    (tx, ty), test = vdata
    want = jax_vision[method, part]
    tr = FederatedTrainer(reduced().replace(dropout_rate=0.0),
                          FederatedConfig(**_vcfg(method, part)), tx, ty,
                          device="cpu")
    _load_jax(tr, *want["init"])
    for r in range(VKW["rounds"]):
        tr.run(until=r + 1)
        _vstate_close(tr.session.population.state_dict(),
                      want["states"][r])
    h, jh = tr.history, want["history"]
    for g, w in zip(h.rounds, jh.rounds):
        _round_close(g, w, 1e-4)
    assert len(h.rounds) == len(jh.rounds) == VKW["rounds"]
    assert h.total_comm_bytes == jh.total_comm_bytes
    assert tr.dispatch_log == want["log"]
    if part:
        assert all(len(rl.participants) == part for rl in h.rounds)
        assert [rl.participants for rl in h.rounds] == \
            [tr.participants(r) for r in range(VKW["rounds"])]
    h = tr.evaluate(*test)
    got = h.client_test_acc + [h.global_test_acc]
    assert len(got) == len(want["acc"]) == VKW["n_clients"] + 1
    for a, b in zip(got, want["acc"]):
        assert abs(a - b) * N_TEST <= 1.0 + 1e-9
    # every state view of the JAX facade
    assert tr.n_params == tr.session.population.n_params > 0
    assert tr.client_params is tr.session.population.client_params
    assert tr.global_params is tr.session.population.global_params
    assert tr.client_opts is not None and tr.global_opt is not None
    assert tr.folds is tr.session.population.folds and tr.mesh is None


@pytest.mark.parametrize("case", list(HCASES))
def test_hetero_trainer_matches_jax(pool, jax_hetero, case):
    want = jax_hetero[case]
    cfg = HeteroConfig(**_hcfg(case))
    tr = HeteroTrainer(cfg, *pool, device="cpu")
    _load_jax(tr, *want["init"])
    for r in range(cfg.rounds):
        before = [{k: v.clone() for k, v in flatten(c).items()}
                  for c in tr.session.population.state_dict()["clients"]]
        tr.run(until=r + 1)
        assert tr._round == r + 1
        _hstate_close(tr.session.population.state_dict(), want["states"][r])
        rl = tr.history.rounds[-1]
        _round_close(rl, want["history"].rounds[r], 2e-5)
        if cfg.participation:
            (absent,) = set(range(cfg.n_clients)) - set(rl.participants)
            now = flatten(tr.session.population.state_dict()["clients"]
                          [absent])
            assert all(torch.equal(before[absent][k], now[k]) for k in now)
            assert rl.client_loss[absent] == 0.0
    assert tr.history.total_comm_bytes == \
        want["history"].total_comm_bytes
    if cfg.sparse_k:
        assert tr.session.strategy.name == "sparse-dml"
        assert tr.session.strategy.sparse_k == cfg.sparse_k
    else:
        d = comm_bytes_per_round(2, cfg.public_batch * 24, 512, 1)
        assert [rl.comm_bytes for rl in tr.history.rounds] == \
            [d["round"]] * cfg.rounds
        ev = tr.evaluate().client_eval_loss
        np.testing.assert_allclose(ev, want["evals"], rtol=0, atol=2e-5)
    assert isinstance(tr.history, HeteroHistory)
    assert isinstance(tr.history.rounds[0], HeteroRoundLog)
    assert tr.n_classes == 512 and len(tr.n_params) == cfg.n_clients
    assert len(tr.eval_fold) == cfg.public_batch
    assert set(tr._models) == set(cfg.archs) and tr.folds is not None
    params = list(tr.client_params)
    tr.client_params = params
    assert tr.session.population.client_params is params
    assert tr.client_opts is tr.session.population.client_opts


# ---------------------------------------------------------------------------
# the facades against the port's own Federation, bit for bit

def _vision_federation(fc, images, labels, mesh=None):
    """``Federation(VisionClients(...), fc.strategy())``, written out."""
    return Federation(VisionClients(
        reduced(), images, labels, n_clients=fc.n_clients, rounds=fc.rounds,
        local_epochs=fc.local_epochs, batch_size=fc.batch_size, lr=fc.lr,
        momentum=fc.momentum, clip_norm=fc.clip_norm,
        non_iid_alpha=fc.non_iid_alpha, seed=fc.seed,
        eval_batch=fc.eval_batch, mesh=mesh, device="cpu"),
        fc.strategy(), participation=fc.participation)


def _hetero_federation(cfg, pool):
    """``Federation(HeteroClients(...), cfg.strategy())``, written out."""
    return Federation(HeteroClients(
        cfg.archs, *pool, rounds=cfg.rounds, local_epochs=cfg.local_epochs,
        batch_size=cfg.batch_size, public_batch=cfg.public_batch, lr=cfg.lr,
        seed=cfg.seed, mutual_updates_per_round=cfg.mutual_epochs,
        device="cpu"), cfg.strategy(), participation=cfg.participation)


def _makers(vdata, pool, kind):
    """Makers of a fresh port facade (DML) and of the Federation it
    stands for, from one seed."""
    if kind == "vision":
        (tx, ty), _ = vdata
        fc = FederatedConfig(**_vcfg("dml", 0))
        return (lambda: FederatedTrainer(reduced(), fc, tx, ty, device="cpu"),
                lambda: _vision_federation(fc, tx, ty))
    cfg = HeteroConfig(**_hcfg("dml"))
    return (lambda: HeteroTrainer(cfg, *pool, device="cpu"),
            lambda: _hetero_federation(cfg, pool))


@pytest.fixture(scope="module")
def port_full(vdata, pool):
    """The uninterrupted DML run of each port facade."""
    out = {}
    for kind in ("vision", "hetero"):
        out[kind] = _makers(vdata, pool, kind)[0]()
        out[kind].run()
    return out


def _vision_pair(vdata, kind):
    """A FederatedTrainer (the reduced config's dropout 0.5) and the
    Federation it stands for, from one seed."""
    (tx, ty), _ = vdata
    method, part, extra, mesh = "dml", 0, {}, None
    if kind == "fedavg_two_of_three":
        method, part = "fedavg", 2
    elif kind == "non_iid":
        extra = dict(non_iid_alpha=0.5)
    elif kind == "mesh":
        mesh = ClientMesh(("cpu", "cpu"))
    fc = FederatedConfig(**_vcfg(method, part, **extra))
    return (FederatedTrainer(reduced(), fc, tx, ty, mesh=mesh, device="cpu"),
            _vision_federation(fc, tx, ty, mesh))


@pytest.mark.parametrize("kind", ["dml_dropout", "fedavg_two_of_three",
                                  "non_iid", "mesh"])
def test_federated_trainer_is_its_federation(vdata, kind):
    """With dropout (the reduced config's 0.5): the same draws."""
    tr, fed = _vision_pair(vdata, kind)
    assert tr.run() is tr.history
    fed.run()
    _sessions_equal(tr.session, fed)
    assert tr.dispatch_log == fed.dispatch_log and tr.dispatch_log
    if kind == "mesh":
        assert tr.mesh is fed.population.mesh is not None
        assert tr.mesh.shape["clients"] == 2


def test_hetero_trainer_is_its_federation(vdata, pool, port_full):
    tr, fed = port_full["hetero"], _makers(vdata, pool, "hetero")[1]()
    fed.run()
    _sessions_equal(tr.session, fed)
    assert tr.evaluate().client_eval_loss == \
        fed.evaluate().client_eval_loss


# ---------------------------------------------------------------------------
# checkpoints

def _assert_saved(path):
    meta = json.load(open(path + ".json"))["meta"]
    assert meta["round"] == 1
    assert set(np.load(path + ".npz").files)
    return meta


@pytest.mark.parametrize("kind", ["vision", "hetero"])
def test_jax_facade_checkpoint_resumes_in_port_facade(vdata, pool,
                                                      jax_vision, jax_hetero,
                                                      kind):
    """The JAX facade saved after round 0; the port's facade restores it
    and runs round 1, against the JAX facade's round 1."""
    if kind == "vision":
        (tx, ty), _ = vdata
        want = jax_vision["dml", 0]
        tr = FederatedTrainer(reduced().replace(dropout_rate=0.0),
                              FederatedConfig(**_vcfg("dml", 0)), tx, ty,
                              device="cpu")
        tr.restore_state(jax_vision["saved"])
        close, atol = _vstate_close, 1e-4
        assert _assert_saved(jax_vision["saved"])["engine"] == "federated"
    else:
        want = jax_hetero["dml"]
        tr = HeteroTrainer(HeteroConfig(**_hcfg("dml")), *pool,
                           device="cpu")
        tr.restore_state(jax_hetero["saved"])
        assert tr._round == 1
        close, atol = _hstate_close, 2e-5
        assert _assert_saved(jax_hetero["saved"])["engine"] == "hetero"
    assert tr.session.round == 1
    # round 0's log as JAX saved it (a float32 loss is written as its
    # string there) and as JAX holds it
    (got0,), want0 = tr.history.rounds, want["history"].rounds[0]
    assert got0.comm_bytes == want0.comm_bytes
    for name in ("client_loss", "kl_loss", "public_ce"):
        a, b = getattr(got0, name), getattr(want0, name)
        assert a == (b if b is None else [float(x) for x in b]), name
        assert a is None or all(type(x) is float for x in a)
    tr.run()
    close(tr.session.population.state_dict(), want["states"][1])
    _round_close(tr.history.rounds[1], want["history"].rounds[1], atol)
    assert tr.history.total_comm_bytes == want["history"].total_comm_bytes


@pytest.mark.parametrize("kind", ["vision", "hetero"])
@pytest.mark.parametrize("direction", ["facade_to_federation",
                                       "federation_to_facade"])
def test_port_checkpoints_cross(vdata, pool, port_full, tmp_path, kind,
                                direction):
    """Saved after round 0 by one of (facade, Federation) and restored by
    the other: the continued round equals the uninterrupted facade's, bit
    for bit; the files are the ``.npz`` + ``.json`` pair."""
    facade, session = _makers(vdata, pool, kind)
    full = port_full[kind]
    first, second = (facade(), session()) if \
        direction == "facade_to_federation" else (session(), facade())
    first.run(until=1)
    path = str(tmp_path / "state")
    first.save_state(path)
    meta = _assert_saved(path)
    assert meta["method"] == "dml"
    second.restore_state(path)
    second.run()
    other = second.session if isinstance(second, (FederatedTrainer,
                                                  HeteroTrainer)) else second
    _sessions_equal(full.session, other, resumed_at=1)


# ---------------------------------------------------------------------------
# refusals and the default device

def _refusal(vdata, pool, tmp_path, jax_saved, what):
    """(the port's call, the JAX package's call or None, the key); the
    archs' refusal restores the JAX facade's checkpoint."""
    (tx, ty), _ = vdata
    if what == "unknown_method":
        return (lambda: FederatedConfig(method="gossip").strategy(),
                lambda: jfederated.FederatedConfig(
                    method="gossip").strategy(), "gossip")
    if what == "mixed_modality":
        cfg = dict(archs=("qwen3-4b", "visionnet"))
        return (lambda: HeteroTrainer(HeteroConfig(**cfg), *pool,
                                      device="cpu"),
                lambda: jhetero.HeteroTrainer(jhetero.HeteroConfig(**cfg),
                                              *pool),
                "mix modalities")
    path = str(tmp_path / "state")
    if what == "config_mismatch":
        FederatedTrainer(reduced(), FederatedConfig(**_vcfg("dml", 0)), tx,
                         ty, device="cpu").save_state(path)
        tr = FederatedTrainer(reduced(), FederatedConfig(
            **dict(_vcfg("dml", 0), n_clients=2)), tx, ty, device="cpu")
        return lambda: tr.restore_state(path), None, "K="
    tr = HeteroTrainer(HeteroConfig(**_hcfg("dml", archs=ARCHS2[::-1])),
                       *pool, device="cpu")
    return lambda: tr.restore_state(jax_saved), None, "archs"


@pytest.mark.parametrize("what", ["config_mismatch", "archs_mismatch",
                                  "mixed_modality", "unknown_method"])
def test_refusals(vdata, pool, jax_hetero, tmp_path, what):
    """ValueError, the JAX package's type, with its message's key; where
    the JAX call is cheap it is made too."""
    port, jax_call, key = _refusal(vdata, pool, tmp_path,
                                   jax_hetero["saved"], what)
    with pytest.raises(ValueError, match=key):
        port()
    if jax_call is not None:
        with pytest.raises(ValueError, match=key):
            jax_call()


@pytest.mark.parametrize("kind", ["vision", "hetero"])
def test_default_device_is_the_card(vdata, pool, kind):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    (tx, ty), _ = vdata
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if kind == "vision":
            FederatedTrainer(reduced(), FederatedConfig(**_vcfg("dml", 0)),
                             tx, ty)
        else:
            HeteroTrainer(HeteroConfig(**_hcfg("dml")), *pool)
