"""The port's client mesh on the CPU, against the JAX package: the
round-robin layout, the entry layout, ``launch.mesh``, the sharded fused
DML step and ``LMClients(mesh=...)`` sessions, and the CLI's ``--mesh``.

The port's mesh repeats the CPU (``ClientMesh(("cpu", "cpu"))``: two
entries of one device); the JAX side runs its ``make_sharded_dml_step``
on a ``clients=1`` mesh of its one CPU device, the same semantics at
another layout (JAX: K_loc = K rounded up to 2 on one device; the port:
K_loc = 2 on each of two entries).  Reduced qwen3-4b in fp32.

Tolerances: the layout helpers exactly; one sharded step against JAX's,
with a clip that bites: metrics atol/rtol 1e-5 (kld_avg atol 1e-6), the
updated params atol 1e-4 (an element whose gradient sits at rounding
level moves by up to lr under AdamW in either package, as in
``test_torch_train.py``) and the moments atol 1e-6; against the port's
unsharded step at ``clip_norm=None``: atol 1e-6 on every leaf and metric
(the same per-client arithmetic; the Eq.-2 term runs the rectangular
pair against the gathered fleet instead of the square one); a session's
per-round losses atol 2e-5 and its params atol 1e-4, as
``test_torch_train.py``'s.  The JAX sessions run once per module (a
fixture).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import DML as JDML
from repro.api import Federation as JFederation
from repro.api import LMClients as JLMClients
from repro.configs import get_reduced as jget_reduced
from repro.core import distributed as jD
from repro.core import stacking as jstacking
from repro.launch.mesh import make_client_mesh as jmake_client_mesh
from repro.launch.mesh import parse_mesh_spec as jparse_mesh_spec
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch import interop
from repro_torch.api import (DML, FedAvg, Federation, LMClients, SparseDML)
from repro_torch.checkpoint import flatten
from repro_torch.configs import get_reduced
from repro_torch.core import distributed as D
from repro_torch.core import stacking
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import train as train_cli
from repro_torch.optim import AdamWConfig, adamw_init, client_norms
from repro_torch.sharding import ClientMesh, make_mesh, map_entries
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
MESH = ClientMesh(("cpu", "cpu"))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _jax_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _trees_close(got, want, **tol):
    got, want = flatten(got), flatten(_jax_numpy(want))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(_np(got[key]), want[key], err_msg=key,
                                   **tol)


# ---------------------------------------------------------------------------
# the layout

@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("K", range(1, 10))
def test_layout_matches_jax(K, n):
    """``client_layout``, ``rr_send_indices``, ``rr_inverse_indices`` and
    the per-entry slot ids equal the JAX package's exactly."""
    assert stacking.client_layout(K, n) == jstacking.client_layout(K, n)
    assert stacking.CLIENT_CHUNK == jstacking.CLIENT_CHUNK
    assert stacking.CLIENT_AXIS == jstacking.CLIENT_AXIS == "clients"
    send = stacking.rr_send_indices(K, n)
    inv = stacking.rr_inverse_indices(K, n)
    np.testing.assert_array_equal(send, jstacking.rr_send_indices(K, n))
    np.testing.assert_array_equal(inv, jstacking.rr_inverse_indices(K, n))
    np.testing.assert_array_equal(send[inv[:K]], np.arange(K))
    k_loc, _ = stacking.client_layout(K, n)
    rows = stacking.entry_rows(K, n)
    for d in range(n):
        ids = stacking.local_client_ids(K, n, d).numpy()
        np.testing.assert_array_equal(ids, np.arange(k_loc) * n + d)
        np.testing.assert_array_equal(rows[d], ids % K)


def test_shard_unshard_and_entries_round_trip():
    """shard/unshard and to_entries/drain_entries invert, bit for bit, on a
    tree with a bf16 leaf, an int leaf, a list and the 0-d shared step
    (replicated, a copy per entry); the moving forms empty only the leaf
    lists they are handed, never a tree."""
    K, n = 5, 2
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(K, 3, 4, generator=g).to(torch.bfloat16),
            "conv": [{"b": torch.randn(K, 7, generator=g)}],
            "step": torch.arange(K, dtype=torch.int32),
            "shared": torch.tensor(3, dtype=torch.int32)}
    sh = stacking.shard_clients({k: v for k, v in tree.items()
                                 if k != "shared"}, K, n)
    assert sh["w"].shape[0] == stacking.client_layout(K, n)[1]
    back = stacking.unshard_clients(sh, K, n)
    for k in back:
        assert torch.equal(back[k] if k != "conv" else back[k][0]["b"],
                           tree[k] if k != "conv" else tree[k][0]["b"])
    assert back["w"].dtype == torch.bfloat16
    entries = stacking.to_entries(tree, K, MESH.devices)
    assert [e["w"].shape[0] for e in entries] == [4, 4]
    assert entries[0]["shared"] is not entries[1]["shared"]
    src = tree_map(torch.clone, tree)
    leaves = tree_leaves(src)
    entries = stacking.move_to_entries(leaves, stacking.tree_skeleton(src),
                                       K, MESH.devices)
    assert all(x is None for x in leaves)
    assert all(x is not None for x in tree_leaves(src))
    kept = list(entries)
    nat = stacking.drain_entries(entries, K, "cpu")
    assert entries == [] and all(x is not None for e in kept
                                 for x in tree_leaves(e))
    for a, b in zip(tree_leaves(nat), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    back = stacking.move_from_entries([tree_leaves(e) for e in kept],
                                      stacking.tree_skeleton(kept[0]), K,
                                      "cpu")
    for a, b in zip(tree_leaves(back), tree_leaves(tree)):
        assert torch.equal(a, b)


def test_gather_clients_is_natural_order_with_pads_trailing():
    """Each entry's shard of its slots' client ids, gathered: the K clients
    in natural order, then the pad slots, each holding the client its
    dummy re-hosts."""
    for K, n in ((3, 2), (5, 2), (5, 4), (4, 4), (1, 3)):
        ids = torch.arange(K)
        shards = [ids[torch.as_tensor(r)] for r in stacking.entry_rows(K, n)]
        got = stacking.gather_clients(shards, K, n, "cpu")
        k_pad = stacking.client_layout(K, n)[1]
        assert got.shape == (k_pad,)
        assert torch.equal(got[:K], ids)
        assert got[K:].tolist() == [c % K for c in range(K, k_pad)]


def test_client_mesh_and_parse_mesh_spec():
    """``make_client_mesh`` on the CPU, its refusal without a card, the
    mesh's axis and shape, ``make_mesh``'s checks, ``map_entries`` in
    entry order, and ``parse_mesh_spec`` with the JAX package's results
    and errors."""
    mesh = mesh_mod.make_client_mesh(3, device="cpu")
    assert mesh.shape == {"clients": 3} and mesh.size == 3
    assert mesh.axis_names == ("clients",)
    assert mesh_mod.make_client_mesh(0, device="cpu").size == 1
    assert mesh == ClientMesh(["cpu"] * 3) and hash(mesh) == \
        hash(ClientMesh(("cpu",) * 3))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_mod.make_client_mesh(2)
    assert make_mesh((2,), ("data",), ["cpu", "cpu"]).axis_names == ("data",)
    with pytest.raises(ValueError, match="needs 3 devices"):
        make_mesh((3,), ("clients",), ["cpu"])
    with pytest.raises(ValueError, match="only 1-D"):
        make_mesh((1, 1), ("a", "b"), ["cpu"])
    with pytest.raises(ValueError, match="one axis"):
        ClientMesh(("cpu",), ("a", "b"))
    assert map_entries(mesh, lambda d, dev, x: (d, dev.type, x),
                       "abc") == [(0, "cpu", "a"), (1, "cpu", "b"),
                                  (2, "cpu", "c")]
    for spec in ("clients=4", "clients=4,data=2", " clients=2 ,", ""):
        assert mesh_mod.parse_mesh_spec(spec) == jparse_mesh_spec(spec)
    for spec in ("clients=x", "clients", "clients=-1"):
        with pytest.raises(ValueError) as want:
            jparse_mesh_spec(spec)
        with pytest.raises(ValueError) as got:
            mesh_mod.parse_mesh_spec(spec)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the sharded fused step

def _step_inputs(K):
    cfg = jget_reduced("qwen3-4b")
    jparams = jD.stacked_init(jax.random.PRNGKey(1), cfg, K)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (K, 2, 24)).astype(np.int32)
    pub = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    return cfg, jparams, toks, pub


def _port_state(jparams):
    tp = interop.params_from_numpy(_jax_numpy(jparams), device="cpu")
    return tp, adamw_init(tp)


def _tt(a):
    return torch.as_tensor(a, dtype=torch.long)


@pytest.mark.parametrize("K", [3, 4], ids=["K3_one_dummy", "K4"])
def test_sharded_step_matches_jax(K):
    """One step of ``make_sharded_dml_step`` with clients 0 and 2 of 3 (or
    3 of 4) taking part and clip_norm 0.5, which every client's gradient
    norm (~20) exceeds: per-client clipping under test.  The port over two
    entries of the CPU against JAX's on a clients=1 mesh."""
    cfg, jparams, toks, pub = _step_inputs(K)
    opt = dict(lr=1e-3, warmup=2, total_steps=10, clip_norm=0.5)
    pm = np.ones(K, np.float32)
    pm[1] = 0.0
    jstep = jax.jit(jD.make_sharded_dml_step(cfg, JAdamWConfig(**opt),
                                             jmake_client_mesh(1), K,
                                             impl="ref"))
    jp, jo, jm = jstep(jparams, jD.stacked_adamw_init(jparams),
                       jnp.asarray(toks), jnp.asarray(pub),
                       jnp.asarray(pm))
    tp, to = _port_state(jparams)
    step = D.make_sharded_dml_step(get_reduced("qwen3-4b"),
                                   AdamWConfig(**opt), MESH, K, impl="ref")
    tp2, to2, tm = step(tp, to, _tt(toks), _tt(pub), pm)
    assert tp2 is tp and to2 is to
    assert float(np.min(np.asarray(jm["grad_norm"])[pm > 0])) > 10 * 0.5
    for key in ("private_loss", "public_ce", "grad_norm"):
        np.testing.assert_allclose(_np(tm[key]), np.asarray(jm[key]),
                                   err_msg=key, **TOL)
    np.testing.assert_allclose(_np(tm["kld_avg"]), np.asarray(jm["kld_avg"]),
                               atol=1e-6, rtol=1e-5)
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert float(tm["kld_avg"][1]) == 0.0
    _trees_close(tp, jp, atol=1e-4, rtol=0)
    _trees_close({"mu": to["mu"], "nu": to["nu"]},
                 {"mu": jo["mu"], "nu": jo["nu"]}, atol=1e-6, rtol=0)
    assert int(to["step"]) == int(jo["step"]) == 1


@pytest.mark.parametrize("K", [3, 4], ids=["K3_one_dummy", "K4"])
def test_sharded_step_matches_the_unsharded_step(K):
    """At clip_norm=None the sharded step's metrics, params and moments
    equal the port's unsharded ``make_dml_train_step``'s; so do its
    per-client gradients (``value_and_grad``, no update)."""
    _, jparams, toks, pub = _step_inputs(K)
    cfg = get_reduced("qwen3-4b")
    opt = AdamWConfig(lr=1e-3, warmup=2, total_steps=10, clip_norm=None)
    tol = dict(atol=1e-6, rtol=0)
    p1, o1 = _port_state(jparams)
    p2, o2 = _port_state(jparams)
    _, want_m, want_g = D.value_and_grad(D.dml_total_loss, p1, cfg, _tt(toks),
                                         _tt(pub), impl="ref")
    step = D.make_sharded_dml_step(cfg, opt, MESH, K, impl="ref")
    got_m, got_g = step.value_and_grad(
        stacking.to_entries(p2, K, MESH.devices), _tt(toks), _tt(pub))
    for key in want_m:
        torch.testing.assert_close(got_m[key], want_m[key], **tol)
    for a, b in zip(tree_leaves(got_g), tree_leaves(want_g)):
        torch.testing.assert_close(a, b, **tol)
    _, _, m1 = D.make_dml_train_step(cfg, opt, impl="ref")(
        p1, o1, _tt(toks), _tt(pub))
    _, _, m2 = step(p2, o2, _tt(toks), _tt(pub))
    for key in ("private_loss", "public_ce", "kld_avg"):
        torch.testing.assert_close(m2[key], m1[key], **tol)
    torch.testing.assert_close(m2["grad_norm"], client_norms(want_g),
                               atol=1e-5, rtol=1e-6)
    for a, b in zip(tree_leaves((p1, o1["mu"], o1["nu"])),
                    tree_leaves((p2, o2["mu"], o2["nu"]))):
        torch.testing.assert_close(a, b, **tol)
    assert int(o1["step"]) == int(o2["step"]) == 1


def test_sharded_step_keeps_absent_and_dummy_slots():
    """On the entry layout, 2 of 3 clients: the absent client's slot and
    the dummy slot keep their params and moments bit for bit, the others
    move, and every entry's copy of the shared step advances."""
    K = 3
    _, jparams, toks, pub = _step_inputs(K)
    tp, to = _port_state(jparams)
    params = stacking.to_entries(tp, K, MESH.devices)
    opts = stacking.to_entries(to, K, MESH.devices)
    before = tree_map(torch.clone, (params, opts))
    step = D.make_sharded_dml_step(get_reduced("qwen3-4b"), AdamWConfig(),
                                   MESH, K, impl="ref")
    m = step.on_entries(params, opts, _tt(toks), _tt(pub),
                        part_mask=[1.0, 0.0, 1.0])
    assert m["private_loss"].shape == (K,) and float(m["kld_avg"][1]) == 0
    # entry 0 holds clients 0 and 2; entry 1 client 1 and a dummy of 0
    for d, i, moved in ((0, 0, True), (0, 1, True), (1, 0, False),
                        (1, 1, False)):
        for tree, was in ((params[d], before[0][d]),
                          (opts[d]["mu"], before[1][d]["mu"]),
                          (opts[d]["nu"], before[1][d]["nu"])):
            same = all(torch.equal(a[i], b[i]) for a, b in
                       zip(tree_leaves(tree), tree_leaves(was)))
            assert same != moved, (d, i)
    assert [int(o["step"]) for o in opts] == [1, 1]


def test_client_scaled_adamw_runs_client_by_client(monkeypatch):
    """``adamw_update`` with a (K,) ``client_scale`` equals each client's
    own update on its gradient scaled in fp32, bit for bit, also where a
    leaf is longer than ``CHUNK`` (cut to 16 here) and runs client by
    client; ``client_norms`` in runs equals it taken whole; a host-int
    step reads no device step."""
    from repro_torch import optim
    g = torch.Generator().manual_seed(0)
    K = 3
    params = {"w": torch.randn(K, 8, 5, generator=g),
              "norm": torch.randn(K, 4, generator=g)}
    grads = tree_map(lambda t: torch.randn(t.shape, generator=g), params)
    scale = torch.tensor([0.5, 1.0, 0.25])
    cfg = AdamWConfig(lr=1e-2, warmup=0, schedule="constant",
                      clip_norm=None)
    want_p = tree_map(torch.clone, params)
    want_o = adamw_init(want_p)
    for c in range(K):
        optim.adamw_update(
            stacking.client_slice(want_p, c),
            tree_map(lambda t: t[c] * scale[c], grads),
            {"mu": stacking.client_slice(want_o["mu"], c),
             "nu": stacking.client_slice(want_o["nu"], c), "step": 0}, cfg)
    whole = client_norms(grads)
    monkeypatch.setattr(optim, "CHUNK", 16)
    got_p = tree_map(torch.clone, params)
    got_o = adamw_init(got_p)
    _, _, om = optim.adamw_update(
        got_p, grads, {"mu": got_o["mu"], "nu": got_o["nu"], "step": 0},
        cfg, client_scale=scale)
    assert om["grad_norm"] is None
    for a, b in zip(tree_leaves((got_p, got_o)), tree_leaves((want_p,
                                                               want_o))):
        assert torch.equal(a, b)
    torch.testing.assert_close(client_norms(grads), whole, atol=0,
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# LMClients sessions on a mesh

ROUNDS = 2
SESSION = dict(n_clients=3, rounds=ROUNDS, batch=2, seq=16, seed=0)


@pytest.fixture(scope="module")
def jax_sessions():
    """JAX's LMClients on a clients=1 mesh, full and at participation 2,
    with the state they started from."""
    out = {}
    for part in (0, 2):
        pop = JLMClients(jget_reduced("qwen3-4b"), **SESSION,
                         mesh=jmake_client_mesh(1), kernel_impl="ref")
        start = _jax_numpy(pop.state_dict())
        fed = JFederation(pop, JDML(), participation=part)
        fed.run()
        out[part] = (start, fed)
    return out


def _port_session(start, part, mesh=MESH, rounds=ROUNDS):
    pop = LMClients(get_reduced("qwen3-4b"), **{**SESSION, "rounds": rounds},
                    mesh=mesh, device="cpu")
    pop.load_state_dict(interop.params_from_numpy(start, device="cpu"), {})
    return Federation(pop, DML(), participation=part)


@pytest.mark.parametrize("part", [0, 2], ids=["full", "two_of_three"])
def test_federation_on_a_mesh_matches_jax(jax_sessions, part):
    """K=3 over two entries (one dummy slot) against JAX's clients=1
    session from the same params: participants, comm bytes, per-round
    losses, the final params and moments, and ``evaluate``."""
    start, jfed = jax_sessions[part]
    fed = _port_session(start, part)
    fed.run()
    for got, want in zip(fed.history.rounds, jfed.history.rounds):
        assert got.participants == want.participants
        assert got.comm_bytes == want.comm_bytes
        for key in ("client_loss", "kl_loss", "public_ce"):
            np.testing.assert_allclose(getattr(got, key), getattr(want, key),
                                       atol=2e-5, rtol=0, err_msg=key)
    assert len(fed.history.rounds) == ROUNDS
    pop = fed.population
    assert pop._entries is not None        # the state stayed on the mesh
    assert pop.params_per_client == jfed.population.params_per_client
    _trees_close(pop.client_params, jfed.population.client_params,
                 atol=1e-4, rtol=0)
    assert pop._entries is None            # reading it gathered it
    assert int(pop.client_opts["step"]) == ROUNDS
    h, jh = fed.evaluate(), jfed.evaluate()
    np.testing.assert_allclose(h.client_eval_loss, jh.client_eval_loss,
                               atol=2e-5, rtol=0)


def test_mesh_checkpoint_resumes_unsharded(jax_sessions, tmp_path):
    """A sharded session saved after round 1 restores into an unsharded
    port session (the natural layout is what a checkpoint holds), and
    round 2 of the two runs the same sharded step where the mesh is."""
    start, _ = jax_sessions[0]
    fed = _port_session(start, 0)
    fed.run(until=1)
    fed.save_state(str(tmp_path / "ck"))
    whole = fed.population.state_dict()
    plain = _port_session(start, 0, mesh=None)
    plain.restore_state(str(tmp_path / "ck"))
    assert plain.round == 1
    for a, b in zip(tree_leaves(plain.population.state_dict()),
                    tree_leaves(whole)):
        assert torch.equal(a, b)
    again = _port_session(start, 0)
    again.restore_state(str(tmp_path / "ck"))
    again.run()
    fed.run()
    assert again.history.rounds[1] == fed.history.rounds[1]


def test_a_tree_read_from_a_mesh_population_keeps_its_tensors():
    """``client_params`` / ``client_opts`` read between mesh rounds stay
    whole after the next round moves the state back to the entries: the
    move drops only the population's references, and the trees keep the
    values they were read with."""
    pop = LMClients(get_reduced("qwen3-4b"), **SESSION, mesh=MESH,
                    device="cpu")
    fed = Federation(pop, DML())
    fed.run(until=1)
    params, opts = pop.client_params, pop.client_opts
    was = [t.clone() for t in tree_leaves((params, opts))]
    fed.run()
    assert pop._entries is not None
    now = tree_leaves((params, opts))
    assert len(now) == len(was)
    assert all(torch.equal(a, b) for a, b in zip(now, was))
    assert not all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(pop.client_params), tree_leaves(params)))


def test_mesh_refusals():
    """The JAX package's refusals: a strategy other than dml on a mesh,
    and a prefix-token arch in the sharded step; the unsharded local step
    still serves a round of fewer than two participants."""
    pop = LMClients(get_reduced("qwen3-4b"), n_clients=2, rounds=1, batch=2,
                    seq=8, mesh=MESH, device="cpu")
    jpop = JLMClients(jget_reduced("qwen3-4b"), n_clients=2, rounds=1,
                      batch=2, seq=8, mesh=jmake_client_mesh(1),
                      kernel_impl="ref")
    for strategy in (SparseDML(k=4), FedAvg()):
        with pytest.raises(ValueError) as got:
            pop.validate_strategy(strategy)
        with pytest.raises(ValueError) as want:
            jpop.validate_strategy(strategy)
        assert str(got.value) == str(want.value)
        assert "mesh-sharded LM rounds support the dense dml" in \
            str(got.value)
    llava = get_reduced("llava-next-mistral-7b")
    with pytest.raises(ValueError, match="prefix-conditioned archs are not "
                                         "supported yet"):
        D.make_sharded_dml_step(llava, AdamWConfig(), MESH, 2, impl="ref")
    prefixed = LMClients(llava, n_clients=2, rounds=1, batch=2, seq=8,
                         mesh=MESH, device="cpu")
    with pytest.raises(ValueError, match="prefix-conditioned"):
        Federation(prefixed, DML()).run()
    alone = Federation(pop, DML(), participation=1).run()
    assert alone.rounds[0].comm_bytes == 0


def test_train_cli_mesh_on_cpu(capsys):
    """``--method dml --mesh clients=2 --device cpu``, and the refusal of
    another spec with the JAX CLI's text."""
    assert train_cli.main(["--method", "dml", "--clients", "3", "--steps",
                           "2", "--batch", "2", "--seq", "16", "--device",
                           "cpu", "--mesh", "clients=2"]) == 0
    out = capsys.readouterr().out
    assert "sharding 3 clients over 2 devices" in out
    assert "step    1 loss=" in out
    with pytest.raises(SystemExit, match="--mesh supports clients=N, got "
                                         "clients=2,data=2"):
        train_cli.main(["--method", "dml", "--device", "cpu", "--mesh",
                        "clients=2,data=2"])
