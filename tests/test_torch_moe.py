"""The port's mixture-of-experts FFN (``repro_torch.models.moe``) and the
MoE archs (dbrx-132b, qwen2-moe-a2.7b, jamba-1.5-large-398b) against the
JAX package on the CPU, at their reduced configs (fp32).

Inputs come from numpy with a seed; JAX params cross through
``interop.params_from_numpy``; the JAX references are jitted.

Tolerances, all fp32:
  - ``apply_moe``'s output, aux losses and gradients: each tensor within
    1e-5 of its largest magnitude (random-init experts of std E ** -0.5
    give outputs of a few hundred and router gradients of 1e4, so a plain
    atol of 1e-5 would ask for 1e-9 relative; the two packages differ by
    ~4e-7 relative: the same products summed in another order, and the
    fp32 combine of <= k terms);
  - logits, prefill and teacher-forced decode 2e-4 (the JAX suite's own
    pin for decode logits), aux losses 1e-5;
  - the loss 1e-5 and its gradients atol 1e-5 / rtol 1e-4, as in
    ``test_torch_train.py``;
  - a session's per-round losses atol 2e-5 and final params atol 1e-4, as
    in ``test_torch_train.py`` (AdamW divides by each gradient's RMS).
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.api import DML as JDML
from repro.api import AsyncWeights as JAsyncWeights
from repro.api import FedAvg as JFedAvg
from repro.api import Federation as JFederation
from repro.api import LMClients as JLMClients
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro_torch import checkpoint, interop
from repro_torch.api import (DML, AsyncWeights, FedAvg, Federation,
                             LMClients)
from repro_torch.checkpoint import flatten
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.core import distributed as D
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
MOE_ARCHS = ["dbrx-132b", "qwen2-moe-a2.7b", "jamba-1.5-large-398b"]
NEW_ARCHS = MOE_ARCHS + ["qwen3-8b", "minitron-4b", "qwen1.5-110b"]
LOGITS = dict(atol=2e-4, rtol=2e-4)
AUX = dict(atol=1e-5, rtol=1e-5)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _scaled_close(got, want, what=""):
    """Within 1e-5 of the tensor's largest magnitude."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= 1e-5 * max(np.abs(want).max(), 1.0), (what, err)


def _jax_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return interop.params_from_numpy(_jax_numpy(tree), device="cpu")


def _long(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def _trees_close(got, want, **tol):
    """Leaf by leaf, matched by their '/'-joined paths."""
    got, want = flatten(got), flatten(_jax_numpy(want))
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key], err_msg=key, **tol)


def _with_moe(cfg, **kw):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **kw))


def _no_drop(cfg):
    """The JAX suite's ``_no_drop`` (``tests/test_serve.py``): capacity for
    every choice, so a token's route does not depend on the others'."""
    return _with_moe(cfg, capacity_factor=float(cfg.moe.n_experts)
                     / cfg.moe.top_k)


# ---------------------------------------------------------------------------
# (a) the MoE FFN, its aux losses and gradients

MOE_CASES = {     # name: (arch, MoEConfig changes, S, zero the router)
    "qwen2-moe": ("qwen2-moe-a2.7b", {}, 40, False),
    "dbrx": ("dbrx-132b", {}, 40, False),
    "drops": ("qwen2-moe-a2.7b", {"capacity_factor": 0.5}, 40, False),
    "ties": ("dbrx-132b", {}, 40, True),
    "two-groups": ("dbrx-132b", {}, 512, False),
}


def _moe_case(name):
    arch, change, S, zero_router = MOE_CASES[name]
    cfg = _with_moe(jget_reduced(arch), **change)
    tcfg = _with_moe(get_reduced(arch), **change)
    K, B = 3, 1 if S > 256 else 2
    jp = jax.vmap(lambda k: jmoe.init_moe(k, cfg))(
        jax.random.split(jax.random.PRNGKey(0), K))
    if zero_router:
        jp["router"] = jnp.zeros_like(jp["router"])
    rng = np.random.default_rng(1)
    x = rng.standard_normal((K, B, S, cfg.d_model)).astype(np.float32)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    ga = rng.standard_normal((2, K)).astype(np.float32)
    return cfg, tcfg, jp, x, gy, ga


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_apply_moe_and_grads_match_jax(name):
    """``apply_moe`` on (K=3, B, S, d) against ``repro.models.moe.apply_moe``
    under ``jax.vmap`` over the clients: y, load_balance and router_z, and
    the gradients of <y, gy> + <aux, ga> with respect to x, the router,
    the experts and the shared experts.  "drops" (capacity_factor 0.5)
    drops choices; "ties" zeroes the router, so every prob ties and the
    lower experts must win (and past capacity, the later tokens drop);
    "two-groups" routes S = 512 in two groups of 256."""
    cfg, tcfg, jp, x, gy, ga = _moe_case(name)

    def jloss(p, xx):
        y, aux = jax.vmap(lambda pp, xc: jmoe.apply_moe(pp, cfg, xc))(p, xx)
        total = (jnp.sum(y * gy) + jnp.sum(aux["load_balance"] * ga[0])
                 + jnp.sum(aux["router_z"] * ga[1]))
        return total, (y, aux)
    (_, (wy, waux)), (wgp, wgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))

    tp = _port(jp)
    xt = torch.from_numpy(x).requires_grad_(True)
    for t in tree_leaves(tp):
        t.requires_grad_(True)
    moe.route_log = []
    try:
        y, aux = moe.apply_moe(tp, tcfg, xt)
        (idx, keep), = moe.route_log
    finally:
        moe.route_log = None
    total = ((y * torch.from_numpy(gy)).sum()
             + (aux["load_balance"] * torch.from_numpy(ga[0])).sum()
             + (aux["router_z"] * torch.from_numpy(ga[1])).sum())
    total.backward()
    _scaled_close(y, wy, "y")
    for key in ("load_balance", "router_z"):
        assert aux[key].shape == (3,) and aux[key].dtype == torch.float32
        _scaled_close(aux[key], waux[key], key)
    _scaled_close(xt.grad, wgx, "dx")
    grads = flatten(tree_map(lambda t: t.grad, tp))
    want = flatten(_jax_numpy(wgp))
    assert sorted(grads) == sorted(want)
    for key in want:
        _scaled_close(grads[key], want[key], key)
    dropped = int((~keep).sum())
    if name in ("drops", "ties"):
        assert dropped > 0
    if name == "ties":
        k = cfg.moe.top_k
        assert torch.equal(idx, torch.arange(k).expand(idx.shape))
    if name == "two-groups":
        assert idx.shape == (3, 512, cfg.moe.top_k)


def test_group_length_refused_as_in_jax():
    """A sequence longer than 256 that 256 does not divide: JAX asserts,
    the port raises before any work (no padding: it would change which
    tokens drop)."""
    cfg, tcfg = jget_reduced("dbrx-132b"), get_reduced("dbrx-132b")
    jp = jmoe.init_moe(jax.random.PRNGKey(0), cfg)
    with pytest.raises(AssertionError):
        jmoe.apply_moe(jp, cfg, jnp.zeros((1, 300, cfg.d_model)))
    tp = tfm._stack1(_port(jp))
    with pytest.raises(ValueError, match="multiple of 256"):
        moe.apply_moe(tp, tcfg, torch.zeros(1, 1, 300, tcfg.d_model))
    assert [moe.group_size(s) for s in (1, 200, 256, 512, 1024)] == \
        [1, 200, 256, 256, 256]


def test_experts_without_tokens_get_zero_gradients():
    """An expert that no token chose stays in the autograd graph:
    ``distributed.value_and_grad`` (``torch.autograd.grad`` on every leaf)
    returns its gradient, exactly zero, as JAX gives it."""
    cfg, tcfg = jget_reduced("qwen2-moe-a2.7b"), get_reduced("qwen2-moe-a2.7b")
    jp = jax.vmap(lambda k: jmoe.init_moe(k, cfg))(
        jax.random.split(jax.random.PRNGKey(2), 2))
    # positive inputs against a router column of -1: expert 3's logit is
    # about -230, far below the others', so no token chooses it
    jp["router"] = jp["router"].at[..., 3].set(-1.0)
    x = 1 + np.abs(np.random.default_rng(3).standard_normal(
        (2, 2, 24, cfg.d_model))).astype(np.float32)
    wg = jax.jit(jax.grad(lambda p: jnp.sum(jax.vmap(
        lambda pp, xc: jmoe.apply_moe(pp, cfg, xc)[0])(p, jnp.asarray(x)))))(
            jp)
    _, _, grads = D.value_and_grad(
        lambda p: (moe.apply_moe(p, tcfg, torch.from_numpy(x))[0].sum(),
                   None), _port(jp))
    for name in ("w_gate", "w_up", "w_down"):
        assert not grads[name][:, 3].any()
        assert not np.asarray(wg[name])[:, 3].any()
        assert grads[name][:, :3].abs().sum() > 0
        _scaled_close(grads[name], wg[name], name)


# ---------------------------------------------------------------------------
# (b) init

def test_init_moe_distributions_and_dtypes():
    """bf16 params: the router stays fp32 with std d ** -0.5; the experts
    (E, d, de) and (E, de, d) take the JAX fan-in rule, std E ** -0.5
    (0.129 for qwen2-moe's 60 experts at full width); the shared experts
    d ** -0.5 and (n_shared * de) ** -0.5 -- each a normal cut at two std
    (std factor 0.8796), as the JAX init draws them."""
    tcfg = get_reduced("qwen2-moe-a2.7b").replace(param_dtype="bfloat16",
                                                   compute_dtype="bfloat16")
    p = tfm.init_model(0, tcfg, n_clients=2, device="cpu")
    f = p["periods"]["slot0"]["ffn"]
    m, d = tcfg.moe, tcfg.d_model
    L = tcfg.n_periods
    assert f["router"].dtype == torch.float32
    assert f["router"].shape == (2, L, d, m.n_experts)
    assert f["w_gate"].shape == (2, L, m.n_experts, d, m.d_expert)
    assert f["w_down"].shape == (2, L, m.n_experts, m.d_expert, d)
    ds = m.n_shared_experts * m.d_expert
    assert f["shared"]["w_down"].shape == (2, L, ds, d)
    trunc = 0.8796
    cases = {"router": d ** -0.5, "w_gate": m.n_experts ** -0.5,
             "w_up": m.n_experts ** -0.5, "w_down": m.n_experts ** -0.5}
    jf = jmoe.init_moe(jax.random.PRNGKey(0),
                       jget_reduced("qwen2-moe-a2.7b").replace(
                           param_dtype="bfloat16"))
    for name, std in cases.items():
        t = f[name].float()
        assert f[name].dtype == (torch.float32 if name == "router"
                                 else torch.bfloat16)
        assert abs(t.std().item() / (trunc * std) - 1) < 0.03, name
        assert t.abs().max().item() <= 2 * std * 1.01, name
        jt = np.asarray(jf[name]).astype(np.float32)
        assert abs(jt.std() / t.std().item() - 1) < 0.05, name
        # each (client, layer) slice is its own draw
        assert not torch.equal(t[0, 0], t[1, 0])
        assert not torch.equal(t[0, 0], t[0, 1])
    for name, fan in (("w_gate", d), ("w_up", d), ("w_down", ds)):
        t = f["shared"][name].float()
        assert abs(t.std().item() / (trunc * fan ** -0.5) - 1) < 0.03
    full = get_config("qwen2-moe-a2.7b")
    assert round(full.moe.n_experts ** -0.5, 3) == 0.129


# ---------------------------------------------------------------------------
# (c) whole models: forward with aux, prefill, decode, loss

_S = 40


@functools.lru_cache(maxsize=None)
def _model(arch):
    cfg, tcfg = jget_reduced(arch), get_reduced(arch)
    params = jax.jit(lambda k: jtfm.init_model(k, cfg))(
        jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, _S)).astype(np.int32)
    return arch, cfg, tcfg, params, _port(params), toks


@pytest.fixture(params=MOE_ARCHS)
def model(request):
    return _model(request.param)


def test_forward_logits_and_aux_match_jax(model):
    """Logits and the aux losses summed over the MoE layers, against
    ``repro.models.transformer.forward``."""
    _, cfg, tcfg, params, tparams, toks = model
    want, waux = jax.jit(lambda p, t: jtfm.forward(
        p, cfg, t, remat=False, impl="ref"))(params, jnp.asarray(toks))
    x, aux = tfm.forward_hidden_clients(tfm._stack1(tparams), tcfg,
                                        _long(toks), remat=False, impl="ref")
    _close(tfm._unembed(tfm._stack1(tparams), tcfg, x)[0], want, **LOGITS)
    for key in ("load_balance", "router_z"):
        assert float(waux[key]) > 0
        _close(aux[key][0], waux[key], **AUX)


def test_prefill_and_decode_steps_match_jax(model):
    """Prefill (last-token logits) and 3 teacher-forced decode steps
    against JAX's, drops and all."""
    _, cfg, tcfg, params, tparams, toks = model
    S0 = _S - 3
    want, wcache = jax.jit(lambda p, t: jtfm.prefill(
        p, cfg, t, max_seq=_S))(params, jnp.asarray(toks[:, :S0]))
    got, cache = tfm.prefill(tparams, tcfg, _long(toks[:, :S0]), max_seq=_S,
                             impl="ref")
    _close(got, want, **LOGITS)
    step = jax.jit(lambda p, t, c, pos: jtfm.decode_step(p, cfg, t, c, pos))
    for t in range(S0, _S):
        want, wcache = step(params, jnp.asarray(toks[:, t:t + 1]), wcache,
                            jnp.int32(t))
        got, cache = tfm.decode_step(tparams, tcfg, _long(toks[:, t:t + 1]),
                                     cache, t)
        _close(got, want, **LOGITS)


def test_decode_matches_forward_without_drops(model):
    """With capacity for every choice (the JAX suite's ``_no_drop``),
    prefill + decode reproduce the port's teacher-forced forward."""
    _, _, tcfg, _, tparams, toks = model
    tcfg = _no_drop(tcfg)
    full = tfm.forward(tparams, tcfg, _long(toks), impl="ref")
    lg, cache = tfm.prefill(tparams, tcfg, _long(toks[:, :_S - 3]),
                            max_seq=_S, impl="ref")
    torch.testing.assert_close(lg, full[:, _S - 4], **LOGITS)
    for t in range(_S - 3, _S - 1):
        lg, cache = tfm.decode_step(tparams, tcfg, _long(toks[:, t:t + 1]),
                                    cache, t)
        torch.testing.assert_close(lg, full[:, t], **LOGITS)


@pytest.mark.parametrize("arch,remat,ce_impl", [
    ("dbrx-132b", True, "dense"), ("qwen2-moe-a2.7b", False, "chunked"),
    ("qwen2-moe-a2.7b", True, "dense"),
    ("jamba-1.5-large-398b", True, "dense")])
def test_loss_fn_with_aux_and_grads_match_jax(arch, remat, ce_impl):
    """``loss_fn`` = CE + load_balance + router_z and its gradient against
    JAX's.  Under remat the aux losses leave each checkpointed period as
    outputs, so their gradient reaches the routers."""
    _, cfg, tcfg, params, tparams, toks = _model(arch)
    (want, wm), wg = jax.jit(jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, cfg, jnp.asarray(toks), remat=remat,
                               ce_impl=ce_impl, impl="ref"),
        has_aux=True))(params)
    got, gm, grads = D.value_and_grad(
        lambda p: tfm.loss_fn(p, tcfg, _long(toks), remat=remat,
                              ce_impl=ce_impl, impl="ref"), tparams)
    _close(got, want, atol=1e-5, rtol=1e-5)
    for key in ("ce", "load_balance", "router_z"):
        _close(gm[key], wm[key], **AUX)
    _trees_close(grads, wg, atol=1e-5, rtol=1e-4)
    routers = [g for k, g in flatten(grads).items() if k.endswith("router")]
    assert routers and all(g.abs().sum() > 0 for g in routers)


# ---------------------------------------------------------------------------
# (d) Federation sessions, round by round

SESSIONS = {      # name: (arch, strategy factory, participation, rounds)
    "qwen2-moe-dml": ("qwen2-moe-a2.7b", lambda m: m.DML(), 0, 2),
    "qwen2-moe-dml-partial": ("qwen2-moe-a2.7b", lambda m: m.DML(), 2, 2),
    "jamba-dml-partial": ("jamba-1.5-large-398b", lambda m: m.DML(), 2, 2),
    "qwen2-moe-fedavg": ("qwen2-moe-a2.7b", lambda m: m.FedAvg(), 0, 1),
    "qwen2-moe-async": ("qwen2-moe-a2.7b",
                        lambda m: m.AsyncWeights(delta=2, min_round=0), 0, 1),
}


class _Jax:
    DML, FedAvg, AsyncWeights = JDML, JFedAvg, JAsyncWeights


class _Port:
    DML, FedAvg, AsyncWeights = DML, FedAvg, AsyncWeights


def _population(mod, name, **kw):
    arch, _, _, rounds = SESSIONS[name]
    get = jget_reduced if mod is _Jax else get_reduced
    make = JLMClients if mod is _Jax else LMClients
    return make(get(arch), n_clients=3, rounds=rounds, batch=2, seq=16,
                seed=0, **kw)


@pytest.fixture(scope="module")
def jax_sessions():
    """The JAX sessions (run once), with the params they started from."""
    out = {}
    for name, (_, make, part, _) in SESSIONS.items():
        pop = _population(_Jax, name, kernel_impl="ref")
        start = _jax_numpy(pop.state_dict())
        fed = JFederation(pop, make(_Jax), participation=part)
        fed.run()
        out[name] = (start, fed)
    return out


@pytest.mark.parametrize("name", list(SESSIONS))
def test_session_matches_jax_round_by_round(jax_sessions, name):
    """K=3 reduced MoE sessions from JAX-initialised params (the fp32
    routers and the experts as any other leaf under ``periods``):
    participants, comm bytes, the async layer, per-round losses (the
    private loss carries the aux losses), and the final params.  jamba
    runs 2-of-3 participation only: its JAX session takes ~30 s to compile
    for each participation mode, and qwen2-moe covers both."""
    _, make, part, rounds = SESSIONS[name]
    start, jfed = jax_sessions[name]
    pop = _population(_Port, name, device="cpu")
    pop.load_state_dict(interop.params_from_numpy(start, device="cpu"), {})
    fed = Federation(pop, make(_Port), participation=part)
    fed.run()
    assert len(fed.history.rounds) == len(jfed.history.rounds) == rounds
    for got, want in zip(fed.history.rounds, jfed.history.rounds):
        assert got.participants == want.participants
        assert got.comm_bytes == want.comm_bytes > 0
        assert got.layer == want.layer
        _close(got.client_loss, want.client_loss, atol=2e-5, rtol=0)
        if want.kl_loss is not None:
            _close(got.kl_loss, want.kl_loss, atol=2e-5, rtol=0)
        if want.public_ce is not None:
            _close(got.public_ce, want.public_ce, atol=2e-5, rtol=0)
    assert fed.history.total_comm_bytes == jfed.history.total_comm_bytes
    _trees_close(pop.client_params, jfed.population.client_params,
                 atol=1e-4, rtol=0)
    if name.endswith("async"):      # shallow: period 0 synced, period 1 not
        router = pop.client_params["periods"]["slot0"]["ffn"]["router"]
        assert fed.history.rounds[0].layer == "shallow"
        assert torch.equal(router[0, 0], router[1, 0])
        assert not torch.equal(router[0, 1], router[1, 1])


# ---------------------------------------------------------------------------
# (e) checkpoints, configs, CLIs

def test_npz_round_trip_fp32_router_among_bf16(tmp_path):
    """A bf16 qwen2-moe population with its fp32 routers: port -> npz ->
    JAX keeps every leaf's dtype and bits, and JAX -> npz -> port too."""
    arch = "qwen2-moe-a2.7b"
    tcfg = get_reduced(arch).replace(param_dtype="bfloat16")
    tp = tfm.init_model(3, tcfg, n_clients=2, device="cpu")
    checkpoint.save(str(tmp_path / "port"), {"client_params": tp},
                    {"arch": arch})
    jtree, meta = jckpt.restore(str(tmp_path / "port.npz"))
    assert meta == {"arch": arch}
    mine = flatten(tp)
    dtypes = set()
    for key, leaf in jckpt._flatten(jtree["client_params"]).items():
        assert str(leaf.dtype) == str(mine[key].dtype)[6:], key
        dtypes.add((key.rsplit("/", 1)[-1], str(leaf.dtype)))
        if mine[key].dtype == torch.bfloat16:
            assert np.array_equal(leaf.view(np.uint16), mine[key].view(
                torch.int16).numpy().view(np.uint16))
        else:
            assert np.array_equal(leaf, mine[key].numpy())
    assert ("router", "float32") in dtypes and \
        ("w_gate", "bfloat16") in dtypes
    jckpt.save(str(tmp_path / "jax"), jtree, {"arch": arch})
    back, _ = checkpoint.restore(str(tmp_path / "jax"))
    back = flatten(back["client_params"])
    assert sorted(back) == sorted(mine)
    for key, a in back.items():
        assert a.dtype == mine[key].dtype and torch.equal(a, mine[key])


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_full_width_config_matches_jax(arch):
    """The port's copy of each new arch's full-width CONFIG and reduced()
    equals the JAX package's field by field, and counts the same params
    (total and active)."""
    for mine, ref in ((get_config(arch), jget_config(arch)),
                      (get_reduced(arch), jget_reduced(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.param_count() == ref.param_count()
        assert mine.active_param_count() == ref.active_param_count()
    assert arch in ARCH_IDS


def test_registry_lists_every_arch_but_the_prefix_ones():
    """Named for the eight archs it pinned before the prefix frontend was
    ported: the registry now lists all ten archs of the JAX package's, in
    its order; every MoE arch initialises."""
    from repro.configs import ARCH_IDS as JARCH_IDS
    assert ARCH_IDS == JARCH_IDS and len(ARCH_IDS) == 10
    for arch in MOE_ARCHS:
        p = tfm.init_model(0, get_reduced(arch), device="cpu")
        assert sum(k == "router" for k in flatten(p)
                   for k in [k.rsplit("/", 1)[-1]]) == sum(
            s.ffn == "moe" for s in get_reduced(arch).period)


def test_clis_run_qwen2_moe_on_cpu(tmp_path):
    """``launch.train`` and ``launch.serve`` with ``--arch
    qwen2-moe-a2.7b`` on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = [["repro_torch.launch.train", "--arch", "qwen2-moe-a2.7b",
             "--method", "dml", "--clients", "3", "--steps", "2", "--batch",
             "2", "--seq", "16", "--device", "cpu"],
            ["repro_torch.launch.serve", "--arch", "qwen2-moe-a2.7b",
             "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen",
             "4"]]
    outs = []
    for args in runs:
        proc = subprocess.run([sys.executable, "-m", *args], env=env,
                              cwd=ROOT, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr
        outs.append(proc.stdout)
    assert any(line.startswith("step    1 loss=")
               for line in outs[0].splitlines()), outs[0]
    assert "arch=qwen2-moe-a2.7b random-init" in outs[1]
    assert "generated (2, 4)" in outs[1] and "impl=ref" in outs[1]
