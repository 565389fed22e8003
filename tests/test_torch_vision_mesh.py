"""The port's ``VisionClients`` on a client mesh, on the CPU: sessions
over 2 and 4 entries of the CPU against the JAX package's unsharded
sessions (DML, FedAvg, AsyncWeights at K = 3, full and 2 of 3; DML at K =
5, which spills past four entries), against the port's unsharded sessions with
the paper's dropout on, the weight syncs from one state in both layouts,
checkpoints crossing to an unsharded port session and to JAX, the
refusals, and the fleet-wide dropout draws.

Against JAX both populations are built at ``dropout_rate=0`` from the
same state, with ``test_torch_vision_session.py``'s tolerances (fp32:
per-round losses atol 1e-4; params atol 1e-4, velocities 1e-4 / lr;
steps, comm bytes and ``dispatch_log`` exactly; accuracies within one
example).  Against the port's unsharded engine, dropout 0.5: the masks
are the same draws (``visionnet.FleetDraws``) and the grouped convolutions
run at another group count, so every leaf and loss within atol 1e-5 (the
largest difference seen is 6e-6; bit for bit as in the JAX package needs
its width-2 chunks, which the port does not run).  A weight sync alone
gathers the mesh's state to natural order and runs the unsharded code:
the same bits.  The JAX sessions run once per module (a fixture).
"""
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
from repro.launch.mesh import make_client_mesh as jmake_client_mesh
from repro_torch import interop
from repro_torch.api import (DML, DPDML, AsyncWeights, FedAvg, Federation,
                             TrimmedDML, VisionClients)
from repro_torch.checkpoint import flatten
from repro_torch.configs.visionnet import reduced
from repro_torch.core import stacking
from repro_torch.models.visionnet import FleetDraws, dropout
from repro_torch.sharding import ClientMesh, make_mesh
from repro_torch.tree import tree_map

torch.set_num_threads(1)
LR = 0.05
KW = dict(rounds=2, local_epochs=2, batch_size=8, lr=LR, eval_batch=64)
N_TEST = 100
STRATEGIES = {
    "dml": (lambda: JDML(kl_weight=1.0), lambda: DML(kl_weight=1.0)),
    "fedavg": (JFedAvg, FedAvg),
    "async": (lambda: JAsyncWeights(delta=2, min_round=0),
              lambda: AsyncWeights(delta=2, min_round=0)),
}
# (strategy, K, participation) of the JAX sessions: K = 3 full and 2 of 3
# (over two entries one spills into a second slot); K = 5 spills over four
# entries too.  FedAvg and async at K = 5 are held against the port's
# unsharded engine below: a JAX compile at K = 5 costs 13 s a program.
CASES = [(name, 3, part) for name in STRATEGIES for part in (0, 2)] + \
    [("dml", 5, 0)]


def _mesh(n):
    return ClientMesh(("cpu",) * n)


@pytest.fixture(scope="module")
def data():
    return make_paper_datasets(image_size=32, n_train=300, n_test=N_TEST)


def _numpy_state(pop):
    return jax.tree.map(np.asarray, pop.state_dict())


def _port_pop(data, K, mesh=None, dropout_rate=0.0, **kw):
    (tx, ty), _ = data
    return VisionClients(reduced().replace(dropout_rate=dropout_rate), tx,
                         ty, n_clients=K, device="cpu", mesh=mesh,
                         **{**KW, **kw})


def _jax_pop(data, K, mesh=None):
    (tx, ty), _ = data
    return JVisionClients(jreduced().replace(dropout_rate=0.0), tx, ty,
                          n_clients=K, mesh=mesh, **KW)


def _state_close(got: dict, want: dict, atol=1e-4):
    """Params (atol), velocities (atol / lr) and steps (exactly) of two
    state_dicts; the PRNG key is each package's own."""
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


def _rounds_close(got, want, atol=1e-4):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.round, g.comm_bytes, g.layer, g.participants) == \
            (w.round, w.comm_bytes, w.layer, w.participants)
        np.testing.assert_allclose(g.client_loss, w.client_loss, rtol=0,
                                   atol=atol)
        np.testing.assert_allclose(g.kl_loss, w.kl_loss, rtol=0, atol=atol)


@pytest.fixture(scope="module")
def jax_sessions(data):
    """Per (strategy, K, participation): the JAX population's initial state
    and meta, its state after each round, its history, dispatch log and
    final accuracies."""
    out = {}
    for name, K, part in CASES:
        pop = _jax_pop(data, K)
        init = (_numpy_state(pop), pop.meta_dict())
        fed = JFederation(pop, STRATEGIES[name][0](), participation=part)
        states = []
        for r in range(KW["rounds"]):
            fed.run(until=r + 1)
            states.append(_numpy_state(pop))
        h = fed.evaluate(split=data[1])
        out[name, K, part] = dict(init=init, states=states, history=h,
                                  log=list(fed.dispatch_log))
    return out


@pytest.mark.parametrize("n", [2, 4], ids=["clients2", "clients4"])
@pytest.mark.parametrize("name,K,part", CASES,
                         ids=[f"{n}-K{k}-{'two' if p else 'all'}"
                              for n, k, p in CASES])
def test_mesh_session_matches_jax(data, jax_sessions, name, K, part, n):
    """A session over an n-entry mesh, from the JAX population's state,
    round by round against JAX's unsharded session."""
    want = jax_sessions[name, K, part]
    pop = _port_pop(data, K, _mesh(n))
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
    if part:
        assert all(len(rl.participants) == part for rl in h.rounds)


@pytest.mark.parametrize("name,K,n,part", [
    ("dml", 3, 2, 0), ("dml", 3, 2, 2), ("dml", 5, 4, 0),
    ("fedavg", 5, 2, 0), ("async", 5, 2, 0)])
def test_mesh_session_matches_the_unsharded_port_with_dropout(
        data, name, K, n, part):
    """The paper's dropout on: the sharded session draws the unsharded
    one's masks, so every leaf, loss and accuracy agrees within fp32
    rounding (atol 1e-5), and the state stays on the mesh between the
    DML rounds."""
    runs = []
    for mesh in (None, _mesh(n)):
        pop = _port_pop(data, K, mesh, dropout_rate=0.5)
        fed = Federation(pop, STRATEGIES[name][1](), participation=part)
        fed.run()
        if mesh is not None and name == "dml":
            assert pop._entries is not None
            assert [e["dense"]["w"].shape[0] for e in pop._entries[0]] == \
                [stacking.client_layout(K, n)[0]] * n
        runs.append((flatten(pop.state_dict()), fed.history,
                     fed.evaluate(split=data[1])))
    (a, ha, ea), (b, hb, eb) = runs
    assert sorted(a) == sorted(b)
    for key in a:
        if key == "key" or "step" in key:
            assert torch.equal(a[key], b[key]), key
        else:
            torch.testing.assert_close(a[key], b[key], atol=1e-5, rtol=0,
                                       msg=key)
    _rounds_close(ha.rounds, hb.rounds, atol=1e-5)
    assert ea.client_test_acc == eb.client_test_acc
    # dropout is live: the same session without it trains other params
    plain = Federation(_port_pop(data, K, _mesh(n)), STRATEGIES[name][1]())
    plain.run(until=1)
    assert not torch.equal(plain.population.client_params["dense"]["w"],
                           a["client_params/dense/w"])


@pytest.mark.parametrize("name", ["fedavg", "async"])
def test_weight_sync_alone_is_bitwise_on_a_mesh(data, name):
    """From one state (after a DML round), the sync of a population whose
    state sits on the mesh's entries and of an unsharded one: the same
    bits, global model included."""
    K = 5
    src = Federation(_port_pop(data, K, dropout_rate=0.5), DML())
    src.run(until=1)
    state, meta = src.population.state_dict(), src.population.meta_dict()
    pops = []
    for mesh in (_mesh(2), None):
        pop = _port_pop(data, K, mesh, dropout_rate=0.5)
        pop.load_state_dict(tree_map(torch.clone, state), meta)
        pop._last_folds = src.population._last_folds
        if mesh is not None:
            pop._to_mesh()
            assert pop._entries is not None
        part, pm = list(range(K)), np.ones(K, np.float32)
        pm[3] = 0.0
        if name == "fedavg":
            pop.fedavg_combine(part[:3] + part[4:], pm)
        else:
            pop.async_combine(1, part[:3] + part[4:], pm, 2, 0,
                              pop.weights_payload(1))
        pops.append(flatten(pop.state_dict()))
    a, b = pops
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_mesh_checkpoint_resumes_unsharded_and_in_jax(data, tmp_path):
    """A DML session on a mesh (from JAX's init) saved after round 1;
    restored by an unsharded port session and by a JAX session, whose
    round 2 agree with the sharded session's."""
    K = 3
    jpop = _jax_pop(data, K)
    pop = _port_pop(data, K, _mesh(2))
    pop.load_state_dict(interop.params_from_numpy(_numpy_state(jpop),
                                                  device="cpu"),
                        jpop.meta_dict())
    fed = Federation(pop, DML())
    fed.run(until=1)
    fed.save_state(str(tmp_path / "ck"))
    fed.run()
    plain = Federation(_port_pop(data, K), DML())
    plain.restore_state(str(tmp_path / "ck"))
    jfed = JFederation(_jax_pop(data, K), JDML())
    jfed.restore_state(str(tmp_path / "ck"))
    plain.run()
    jfed.run()
    for other in (plain.history.rounds[1:], jfed.history.rounds[1:]):
        _rounds_close(fed.history.rounds[1:], other)
    _state_close(pop.state_dict(), _numpy_state(jfed.population))
    _state_close(pop.state_dict(), plain.population.state_dict(),
                 atol=1e-5)


def test_mesh_refusals(data):
    """A mesh without a ``clients`` axis is a ValueError; DP, Byzantine
    senders, the robust combiners and the payload tap run unsharded only
    (NotImplementedError), with the JAX package's texts."""
    (tx, ty), _ = data
    bad = make_mesh((2,), ("data",), ["cpu", "cpu"])
    with pytest.raises(ValueError, match="mesh needs a 'clients' axis, "
                                         "got \\('data',\\)"):
        _port_pop(data, 3, bad)
    msg = ("DP / Byzantine / robust-combine / payload recording run on the "
           "unsharded engine only; drop mesh= or the feature")
    for kw, strategy in ((dict(), DPDML(dp_noise_multiplier=1.0)),
                         (dict(), TrimmedDML(trim=1)),
                         (dict(byzantine={0: "sign-flip"}), DML()),
                         (dict(record_payloads=True), DML())):
        pop = _port_pop(data, 3, _mesh(2), **kw)
        with pytest.raises(NotImplementedError) as got:
            Federation(pop, strategy).run(until=1)
        assert str(got.value) == msg
    # label-flip poisons local training only: it runs on a mesh
    pop = _port_pop(data, 3, _mesh(2), byzantine={1: "label-flip"})
    assert Federation(pop, DML()).run(until=1).rounds[0].comm_bytes > 0


def test_fleet_draws_are_the_unsharded_masks():
    """Each entry's rows of a ``FleetDraws`` step are the rows of the one
    draw an unsharded fleet makes from the same generator state, call by
    call; the next step draws anew."""
    K = 5
    x = torch.ones(K, 4, 6)
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    want = [dropout(x, 0.5, g1) for _ in range(2)]
    fleet = FleetDraws(g2, K)
    fleet.step()
    rows = [torch.tensor([0, 2, 4, 0]), torch.tensor([1, 3, 0, 1])]
    views = [fleet.rows(r) for r in rows]
    for call in range(2):
        for r, v in zip(rows, views):
            assert torch.equal(dropout(x[r], 0.5, v), want[call][r])
    fleet.step()
    assert not torch.equal(dropout(x, 0.5, fleet.rows(torch.arange(K))),
                           want[0])


@pytest.mark.multidevice
def test_mesh_session_matches_jax_sharded_session(data):
    """Against the JAX package's own clients=4 sharded session (K = 5 on
    4 fake host devices; run with ``-m multidevice``): the port over 4
    entries of the CPU, round by round."""
    K = 5
    jpop = _jax_pop(data, K, jmake_client_mesh(4))
    init = (_numpy_state(jpop), jpop.meta_dict())
    jfed = JFederation(jpop, JDML())
    pop = _port_pop(data, K, _mesh(4))
    pop.load_state_dict(interop.params_from_numpy(init[0], device="cpu"),
                        init[1])
    fed = Federation(pop, DML())
    for r in range(KW["rounds"]):
        jfed.run(until=r + 1)
        fed.run(until=r + 1)
        _state_close(pop.state_dict(), _numpy_state(jpop))
    _rounds_close(fed.history.rounds, jfed.history.rounds)
    assert fed.dispatch_log == list(jfed.dispatch_log)
    assert all(len(x.sharding.device_set) == 4
               for x in jax.tree.leaves(jpop.client_params)[:1])
