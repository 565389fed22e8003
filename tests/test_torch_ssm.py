"""The port's Mamba2 path (``repro_torch``: the SSD scan's plain version and
wrapper, the Mamba2 block, prefill and decode, a hybrid period, the
optimizer and checkpoints on a mixed-dtype tree, a K=3 DML session and the
serving engine) against the JAX package on the CPU, at reduced mamba2-780m
(2 layers, d 128, N 16, P 32, chunk 32, fp32).

Inputs come from numpy with a seed; JAX params cross through
``interop.params_from_numpy``.  The JAX side runs its plain versions and
its Pallas SSD kernel in interpret mode, as its own suite does; the port
runs its plain versions (on CPU tensors the kernel wrappers take them).

Tolerances, all fp32:
  - the SSD scan: y and final state atol/rtol 1e-4, each of the five
    gradients within 1e-4 by relative norm (the same chunked math, summed
    in another order);
  - layer outputs 1e-5; logits, prefill and teacher-forced decode 2e-4 (the
    JAX suite's own pin for decode logits);
  - a session's per-round losses atol 2e-5 and final params atol 1e-4, as
    in ``test_torch_train.py`` (AdamW divides by each gradient's RMS).
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

from repro import checkpoint as jckpt
from repro.api import DML as JDML
from repro.api import Federation as JFederation
from repro.api import LMClients as JLMClients
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.configs.base import LayerSpec as JLayerSpec
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as jssd_scan
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro.optim import _wd_mask as j_wd_mask
from repro.optim import clip_by_global_norm as jclip
from repro.serve import ServeEngine as JaxEngine
from repro_torch import checkpoint, interop
from repro_torch.api import DML, Federation, LMClients
from repro_torch.checkpoint import flatten
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import LayerSpec
from repro_torch.core import distributed as D
from repro_torch.kernels import ops, ref, ssd_scan
from repro_torch.models import layers, ssm
from repro_torch.models import transformer as tfm
from repro_torch.optim import _leaves_with_path, _wd_mask, clip_by_global_norm
from repro_torch.serve import ServeEngine
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
ARCH = "mamba2-780m"
SSD = dict(atol=1e-4, rtol=1e-4)
LAYER = dict(atol=1e-5, rtol=1e-5)
LOGITS = dict(atol=2e-4, rtol=2e-4)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _rel(got, want) -> float:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _long(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def _jax_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return interop.params_from_numpy(_jax_numpy(tree), device="cpu")


def _trees_close(got, want, **tol):
    got, want = flatten(got), flatten(_jax_numpy(want))
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key], tol)


# ---------------------------------------------------------------------------
# the SSD scan

def _ssd_inputs(B, S, H, P, G, N, seed=0, init=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    if init:        # mamba2's initialisation: A = -(1..H), dt up to 0.1
        dt = rng.uniform(1e-3, 0.1, (B, S, H)).astype(np.float32)
        A = -np.arange(1, H + 1, dtype=np.float32)
    else:
        dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))) \
            .astype(np.float32)
        A = -np.exp(rng.standard_normal((H,))).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    ds = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return (x, dt, A, Bm, Cm), (dy, ds)


SSD_CASES = {           # B, S, H, P, G, N, chunk, mamba2 init
    "chunks": (2, 64, 4, 16, 1, 8, 16, False),
    "ragged-groups": (1, 50, 4, 16, 2, 8, 16, False),
    "shorter-than-chunk": (2, 10, 2, 8, 2, 4, 16, False),
    "one-token": (1, 1, 2, 8, 1, 4, 16, False),
    "three-groups": (1, 40, 6, 8, 3, 4, 16, False),
    "mamba2-decay": (1, 256, 48, 4, 1, 4, 256, True),
}


@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_and_grads_match_jax(case):
    """``ref.ssd`` against the JAX oracle and the interpreted Pallas kernel
    with its custom VJP: y, the final state, and the gradients of x, dt,
    A, B and C under cotangents on both outputs.  "mamba2-decay" takes the
    cumulative decay to about -1200 within a chunk."""
    B, S, H, P, G, N, chunk, init = SSD_CASES[case]
    ins, (dy, ds) = _ssd_inputs(B, S, H, P, G, N, init=init)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    y, state = ref.ssd(*leaves, chunk=chunk)
    grads = torch.autograd.grad((y * torch.from_numpy(dy)).sum()
                                + (state * torch.from_numpy(ds)).sum(),
                                leaves)
    for fn in (lambda *a: jref.ssd(*a, chunk=chunk),
               lambda *a: jssd_scan(*a, chunk=chunk, interpret=True)):
        (wy, ws), vjp = jax.vjp(fn, *map(jnp.asarray, ins))
        _close(y, wy, SSD)
        _close(state, ws, SSD)
        for got, want in zip(grads, vjp((jnp.asarray(dy), jnp.asarray(ds)))):
            assert _rel(got, want) <= 1e-4


def test_ssd_initial_state_and_dispatch():
    """``ops.ssd``: a continuation from ``initial_state`` runs at impl
    "ref" (and matches JAX's) and "cuda" refuses it, since the kernels
    start from the zero state; every call needs an impl, "ref" is the
    plain version, and "cuda" refuses CPU tensors; the kernel wrapper
    takes the plain version on CPU tensors."""
    ins, _ = _ssd_inputs(2, 40, 4, 8, 2, 4)
    t = [torch.from_numpy(a) for a in ins]
    s0 = np.random.default_rng(3).standard_normal((2, 4, 8, 4)) \
        .astype(np.float32)
    wy, ws = jref.ssd(*map(jnp.asarray, ins), chunk=16,
                      initial_state=jnp.asarray(s0))
    y, s = ops.ssd(*t, chunk=16, initial_state=torch.from_numpy(s0),
                   impl="ref")
    _close(y, wy, SSD)
    _close(s, ws, SSD)
    with pytest.raises(ValueError, match="zero state"):
        ops.ssd(*t, chunk=16, initial_state=torch.from_numpy(s0),
                impl="cuda")
    with pytest.raises(ValueError, match="explicit impl"):
        ops.ssd(*t, chunk=16, initial_state=torch.from_numpy(s0))
    with pytest.raises(ValueError, match="explicit impl"):
        ops.ssd(*t, chunk=16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.ssd(*t, chunk=16, impl="cuda")
    with pytest.raises(ValueError, match="unknown kernel impl"):
        ops.ssd(*t, chunk=16, impl="interpret")
    want = ref.ssd(*t, chunk=16)
    for got in (ops.ssd(*t, chunk=16, impl="ref"),
                ssd_scan.ssd_scan(*t, chunk=16)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    launched = ssd_scan.launches
    ssd_scan.ssd_scan(*t, chunk=16)
    assert ssd_scan.launches == launched       # the plain version ran


# ---------------------------------------------------------------------------
# the Mamba2 block

@pytest.fixture(scope="module")
def small():
    """Reduced mamba2-780m: JAX-initialised params, their port copy, and
    seeded tokens."""
    cfg, tcfg = jget_reduced(ARCH), get_reduced(ARCH)
    params = jtfm.init_model(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 70)).astype(np.int32)
    return cfg, tcfg, params, _port(params), toks


def test_gated_rms_norm_and_causal_conv_match_jax(small):
    cfg, _, params, tparams, _ = small
    rng = np.random.default_rng(1)
    x, z = rng.standard_normal((2, 2, 9, 64)).astype(np.float32) * 3
    w = rng.standard_normal((64,)).astype(np.float32)
    _close(layers.gated_rms_norm(torch.from_numpy(x), torch.from_numpy(z),
                                 torch.from_numpy(w)),
           jlayers.gated_rms_norm(jnp.asarray(x), jnp.asarray(z),
                                  jnp.asarray(w)), LAYER)
    mixer = params["periods"]["slot0"]["mixer"]
    tm = tparams["periods"]["slot0"]["mixer"]
    xbc = rng.standard_normal((2, 9, mixer["conv_w"].shape[-1])) \
        .astype(np.float32)
    want = jssm._causal_conv(jnp.asarray(xbc), mixer["conv_w"][0],
                             mixer["conv_b"][0])
    got = ssm._causal_conv(torch.from_numpy(xbc)[None], tm["conv_w"][:1],
                           tm["conv_b"][:1])[0]
    _close(got, want, LAYER)


@pytest.mark.parametrize("S", [70, 2])
def test_mamba_forward_and_state_match_jax(small, S):
    """One Mamba2 block with a client axis of 2 (two layers' weights as two
    clients), and its prefill state; S = 2 < d_conv - 1 left-pads the conv
    state."""
    cfg, tcfg, params, tparams, _ = small
    u = np.random.default_rng(2).standard_normal((2, S, cfg.d_model)) \
        .astype(np.float32)
    tm = tparams["periods"]["slot0"]["mixer"]       # (n_periods = 2, ...)
    out, (conv, st) = ssm.mamba_forward(tm, tcfg, torch.from_numpy(u)[None]
                                        .expand(2, -1, -1, -1),
                                        return_state=True, impl="ref")
    for k in range(2):
        jm = jax.tree.map(lambda t: t[k], params["periods"]["slot0"]["mixer"])
        want, (wconv, wst) = jssm.mamba_forward(jm, cfg, jnp.asarray(u),
                                                return_state=True,
                                                impl="interpret")
        _close(out[k], want, LAYER)
        _close(conv[k], wconv, LAYER)
        _close(st[k], wst, SSD)


def test_init_mamba_tree_dtypes_and_distributions():
    """The port's init: the JAX tree's shapes and dtypes -- fp32 A_log, D
    and dt_bias in a bf16 tree -- and its distributions."""
    cfg = jget_reduced(ARCH).replace(param_dtype="bfloat16",
                                     compute_dtype="bfloat16")
    tcfg = get_reduced(ARCH).replace(param_dtype="bfloat16",
                                     compute_dtype="bfloat16")
    want = jax.tree.map(lambda t: (t.shape, str(t.dtype)),
                        jax.eval_shape(lambda: jtfm.init_model(
                            jax.random.PRNGKey(0), cfg)))
    tp = tfm.init_model(0, tcfg, device="cpu")
    got = tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tp)
    assert got == want
    m = tp["periods"]["slot0"]["mixer"]
    s = tcfg.ssm
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert bool(((dt >= s.dt_min * 0.999) & (dt <= s.dt_max * 1.001)).all())
    nh = s.n_heads(tcfg.d_model)
    assert torch.equal(m["A_log"][0], torch.log(torch.arange(1., nh + 1)))
    assert bool((m["D"] == 1).all()) and not m["norm"].any()
    assert not m["conv_b"].any()
    assert abs(m["in_proj"].float().std().item() * tcfg.d_model ** 0.5
               - 0.8796) < 0.03
    stacked = tfm.init_model(0, tcfg, n_clients=3, device="cpu")
    assert stacked["periods"]["slot0"]["mixer"]["A_log"].shape == (3, 2, nh)
    assert sum(t.numel() for t in tree_leaves(tp)) == tcfg.param_count()


def test_full_width_config_matches_jax():
    j, t = jget_config(ARCH), get_config(ARCH)
    assert {f: getattr(t, f) for f in t.__dataclass_fields__
            if f not in ("period", "ssm")} == \
        {f: getattr(j, f) for f in t.__dataclass_fields__
         if f not in ("period", "ssm")}
    assert [(s.mixer, s.ffn) for s in t.period] == \
        [(s.mixer, s.ffn) for s in j.period]
    assert vars(t.ssm) == vars(j.ssm)
    assert t.param_count() == j.param_count()
    assert t.pdtype() == t.cdtype() == torch.bfloat16


# ---------------------------------------------------------------------------
# whole model: forward, prefill, decode

def test_forward_logits_match_jax(small):
    cfg, tcfg, params, tparams, toks = small
    want, _ = jtfm.forward(params, cfg, jnp.asarray(toks), remat=False,
                           impl="interpret")
    _close(tfm.forward(tparams, tcfg, _long(toks), impl="ref"), want, LOGITS)


@pytest.mark.parametrize("S0", [60, 2])
def test_prefill_and_decode_steps_match_jax(small, S0):
    """Prefill logits and caches (conv in the compute dtype, ssm fp32),
    then 8 teacher-forced decode steps, each against JAX."""
    cfg, tcfg, params, tparams, toks = small
    with jops.use_impl("interpret"):       # JAX prefill through the kernel
        want, wcache = jtfm.prefill(params, cfg, jnp.asarray(toks[:, :S0]),
                                    max_seq=80)
    got, cache = tfm.prefill(tparams, tcfg, _long(toks[:, :S0]), max_seq=80,
                             impl="ref")
    _close(got, want, LOGITS)
    assert cache["slot0"]["conv"].dtype == torch.float32     # cdtype
    for name in ("conv", "ssm"):
        _close(cache["slot0"][name], wcache["slot0"][name], SSD)
    for t in range(S0, S0 + 8):
        want, wcache = jtfm.decode_step(params, cfg,
                                        jnp.asarray(toks[:, t:t + 1]),
                                        wcache, t)
        got, cache = tfm.decode_step(tparams, tcfg, _long(toks[:, t:t + 1]),
                                     cache, t)
        _close(got, want, LOGITS)
    for name in ("conv", "ssm"):
        _close(cache["slot0"][name], wcache["slot0"][name], SSD)


def test_decode_logits_match_forward(small):
    """Prefill + decode == the teacher-forced forward, within the port."""
    _, tcfg, _, tparams, toks = small
    full = tfm.forward(tparams, tcfg, _long(toks), impl="ref")
    _, cache = tfm.prefill(tparams, tcfg, _long(toks[:, :64]), max_seq=80,
                           impl="ref")
    for t in range(64, 70):
        got, cache = tfm.decode_step(tparams, tcfg, _long(toks[:, t:t + 1]),
                                     cache, t)
        torch.testing.assert_close(got, full[:, t], **LOGITS)


def test_stacked_clients_equal_each_client_alone(small):
    """The clients become heads of one scan: K clients in one call give
    each client's own single-model result, in prefill and in decode."""
    cfg, tcfg, _, _, toks = small
    stacked = jax.vmap(lambda k: jtfm.init_model(k, cfg))(
        jax.random.split(jax.random.PRNGKey(1), 3))
    sp = _port(stacked)
    got, cache = tfm.prefill_clients(sp, tcfg, _long(toks[:, :40]),
                                     max_seq=64, impl="ref")
    step, _ = tfm.decode_step_clients(sp, tcfg, _long(toks[:, 40:41]), cache,
                                      40)
    for c in range(3):
        one = tree_map(lambda t: t[c], sp)
        want, c1 = tfm.prefill(one, tcfg, _long(toks[:, :40]), max_seq=64,
                               impl="ref")
        torch.testing.assert_close(got[c], want, **LAYER)
        want, _ = tfm.decode_step(one, tcfg, _long(toks[:, 40:41]), c1, 40)
        torch.testing.assert_close(step[c], want, **LAYER)


def _hybrid(cfg):
    return cfg.replace(
        n_layers=4, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
        period=(type(cfg.period[0])("attn", "mlp"),
                type(cfg.period[0])("mamba", "none")))


def test_hybrid_period_matches_jax():
    """A reduced two-slot period (attn + mlp, then mamba + none), built on
    both packages: forward, prefill and 3 decode steps."""
    cfg, tcfg = _hybrid(jget_reduced(ARCH)), _hybrid(get_reduced(ARCH))
    assert isinstance(cfg.period[0], JLayerSpec)
    assert isinstance(tcfg.period[0], LayerSpec)
    params = jtfm.init_model(jax.random.PRNGKey(2), cfg)
    tp = _port(params)
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    with jops.use_impl("interpret"):
        want, _ = jtfm.forward(params, cfg, jnp.asarray(toks), remat=False)
        wl, wc = jtfm.prefill(params, cfg, jnp.asarray(toks[:, :37]),
                              max_seq=64)
    _close(tfm.forward(tp, tcfg, _long(toks), impl="ref"), want, LOGITS)
    gl, gc = tfm.prefill(tp, tcfg, _long(toks[:, :37]), max_seq=64,
                         impl="ref")
    _close(gl, wl, LOGITS)
    assert sorted(gc["slot0"]) == ["k", "pos", "v"]
    assert sorted(gc["slot1"]) == ["conv", "ssm"]
    for t in range(37, 40):
        wl, wc = jtfm.decode_step(params, cfg, jnp.asarray(toks[:, t:t + 1]),
                                  wc, t)
        gl, gc = tfm.decode_step(tp, tcfg, _long(toks[:, t:t + 1]), gc, t)
        _close(gl, wl, LOGITS)


# ---------------------------------------------------------------------------
# training pieces on a mamba tree

def test_loss_and_grads_match_jax(small):
    """``loss_fn`` under remat and its gradient for every leaf, fp32 A_log,
    D and dt_bias included, against JAX's."""
    cfg, tcfg, params, tparams, toks = small
    (want, _), wg = jax.jit(jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, cfg, jnp.asarray(toks), impl="ref"),
        has_aux=True))(params)
    got, _, grads = D.value_and_grad(
        lambda p: tfm.loss_fn(p, tcfg, _long(toks), impl="ref"), tparams)
    _close(got, want, LAYER)
    _trees_close(grads, wg, atol=1e-5, rtol=1e-4)


def test_wd_mask_on_mamba_tree(small):
    """Weight decay reaches in_proj, conv_w and out_proj (and the
    embedding), never A_log, D, dt_bias, conv_b or a norm -- as in JAX."""
    _, _, params, tparams, _ = small
    got = {"/".join(map(str, path)): _wd_mask(path)
           for path, _ in _leaves_with_path(tparams)}
    want = {"/".join(str(k.key) for k in path): j_wd_mask(path)
            for path, _ in jax.tree_util.tree_leaves_with_path(params)}
    assert got == want
    mixer = {k.split("/")[-1]: v for k, v in got.items() if "mixer" in k}
    assert mixer == {"in_proj": True, "conv_w": True, "conv_b": False,
                     "A_log": False, "D": False, "dt_bias": False,
                     "norm": False, "out_proj": True}


def test_clip_spans_both_dtypes(small):
    """One global norm over bf16 matrices and fp32 A_log/D/dt_bias, one
    scale for all, as in JAX."""
    _, _, params, _, _ = small
    rng = np.random.default_rng(6)
    grads = jax.tree.map(lambda t: jnp.asarray(
        rng.standard_normal(t.shape), t.dtype if t.ndim < 3 or
        t.dtype != jnp.float32 else jnp.bfloat16), params)
    dtypes = {str(t.dtype) for t in jax.tree.leaves(grads)}
    assert dtypes == {"float32", "bfloat16"}
    jclipped, jnorm = jclip(grads, 1.0)
    clipped, norm = clip_by_global_norm(_port(grads), 1.0)
    _close(norm, jnorm, dict(atol=0, rtol=1e-5))   # fp32, another order
    _trees_close(clipped, jclipped, atol=1e-6, rtol=1e-5)


def test_npz_round_trip_mixed_dtypes(tmp_path):
    """A bf16 mamba tree with fp32 A_log/D/dt_bias: port -> npz -> JAX
    keeps every leaf's dtype and bits, and JAX -> npz -> port too."""
    tcfg = get_reduced(ARCH).replace(param_dtype="bfloat16")
    tp = tfm.init_model(3, tcfg, n_clients=2, device="cpu")
    checkpoint.save(str(tmp_path / "port"), {"client_params": tp},
                    {"arch": ARCH})
    jtree, _ = jckpt.restore(str(tmp_path / "port.npz"))
    for key, leaf in jckpt._flatten(jtree["client_params"]).items():
        mine = flatten(tp)[key]
        assert str(leaf.dtype) == str(mine.dtype)[6:]
        if mine.dtype == torch.bfloat16:
            assert np.array_equal(leaf.view(np.uint16),
                                  mine.view(torch.int16).numpy()
                                  .view(np.uint16))
        else:
            assert np.array_equal(leaf, mine.numpy())
    jckpt.save(str(tmp_path / "jax"), jtree, {"arch": ARCH})
    back, _ = checkpoint.restore(str(tmp_path / "jax"))
    back, mine = flatten(back["client_params"]), flatten(tp)
    assert sorted(back) == sorted(mine)
    for key, a in back.items():
        assert a.dtype == mine[key].dtype and torch.equal(a, mine[key])


# ---------------------------------------------------------------------------
# the K=3 DML session, round by round

SESSIONS = {"ref": 0, "ref-partial": 2}       # name: participation


@pytest.fixture(scope="module")
def jax_sessions():
    """The JAX sessions (run once), with the params they started from."""
    out = {}
    for name, part in SESSIONS.items():
        pop = JLMClients(jget_reduced(ARCH), n_clients=3, rounds=2, batch=2,
                         seq=16, seed=0, kernel_impl="ref")
        start = _jax_numpy(pop.state_dict())
        fed = JFederation(pop, JDML(), participation=part)
        fed.run()
        out[name] = (start, fed)
    return out


@pytest.mark.parametrize("name", list(SESSIONS))
def test_federation_matches_jax_round_by_round(jax_sessions, name):
    """K=3 reduced mamba2 DML sessions from JAX-initialised params:
    participants, comm bytes, per-round losses, and the final params and
    AdamW state (fp32 leaves in a fp32 tree here)."""
    start, jfed = jax_sessions[name]
    pop = LMClients(get_reduced(ARCH), n_clients=3, rounds=2, batch=2,
                    seq=16, seed=0, device="cpu")
    pop.load_state_dict(interop.params_from_numpy(start, device="cpu"), {})
    fed = Federation(pop, DML(), participation=SESSIONS[name])
    fed.run()
    for got, want in zip(fed.history.rounds, jfed.history.rounds):
        assert got.participants == want.participants
        assert got.comm_bytes == want.comm_bytes
        _close(got.client_loss, want.client_loss, dict(atol=2e-5, rtol=0))
        _close(got.kl_loss, want.kl_loss, dict(atol=2e-5, rtol=0))
        _close(got.public_ce, want.public_ce, dict(atol=2e-5, rtol=0))
    assert len(fed.history.rounds) == len(jfed.history.rounds) == 2
    _trees_close(pop.client_params, jfed.population.client_params,
                 atol=1e-4, rtol=0)
    _trees_close(pop.client_opts["mu"], jfed.population.client_opts["mu"],
                 atol=1e-5, rtol=1e-3)


# ---------------------------------------------------------------------------
# serving

@pytest.mark.parametrize("mode", ["average", "route"])
def test_generate_matches_jax_engine(small, mode):
    """Greedy ``generate`` of a K=2 population: the same tokens as the JAX
    engine (whose prefill runs the interpreted SSD kernel), logits within
    2e-4, the same program calls."""
    cfg, tcfg, _, _, toks = small
    params = jax.vmap(lambda k: jtfm.init_model(k, cfg))(
        jax.random.split(jax.random.PRNGKey(4), 2))
    kw = dict(mode=mode, slots=2, max_seq=64)
    jeng = JaxEngine(cfg, params, **kw)
    teng = ServeEngine(tcfg, _port(params), device="cpu", **kw)
    with jops.use_impl("interpret"):
        want, wlg = jeng.generate(toks[:, :33], 4, return_logits=True)
    got, lg = teng.generate(toks[:, :33], 4, return_logits=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    _close(lg, wlg, LOGITS)
    assert teng.dispatch_counts() == jeng.dispatch_counts()


def test_continuous_batching_matches_jax_engine(small):
    """Mixed requests through 2 slots: admission writes a slot's conv
    (compute dtype) and ssm (fp32) state; the tokens equal JAX's."""
    cfg, tcfg, params, tparams, _ = small
    one = lambda t: t[None]                                # noqa: E731
    kw = dict(mode="average", slots=2, max_seq=64, chunk=3)
    jeng = JaxEngine(cfg, jax.tree.map(one, params), **kw)
    teng = ServeEngine(tcfg, tree_map(one, tparams), device="cpu", **kw)
    rng = np.random.default_rng(2)
    reqs = [(rng.integers(0, cfg.vocab_size, (3 + 11 * i,)).astype(np.int32),
             4 + i % 3) for i in range(4)]
    with jops.use_impl("interpret"):
        jr = [jeng.submit(p, n) for p, n in reqs]
        want = jeng.run()
    tr = [teng.submit(p, n) for p, n in reqs]
    got = teng.run()
    for a, b in zip(tr, jr):
        np.testing.assert_array_equal(got[a], np.asarray(want[b]))
    arena = teng._arena["slot0"]
    assert arena["conv"].dtype == torch.float32 and \
        arena["ssm"].dtype == torch.float32


def test_clis_run_mamba2_on_cpu(tmp_path):
    """``launch.train`` and ``launch.serve`` with ``--arch mamba2-780m``
    on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = [["repro_torch.launch.train", "--arch", ARCH, "--method", "dml",
             "--clients", "3", "--steps", "2", "--batch", "2", "--seq",
             "16", "--device", "cpu"],
            ["repro_torch.launch.serve", "--arch", ARCH, "--device", "cpu",
             "--batch", "2", "--prompt-len", "8", "--gen", "4"]]
    for args in runs:
        proc = subprocess.run([sys.executable, "-m", *args], env=env,
                              cwd=ROOT, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr
    assert "generated (2, 4)" in proc.stdout and "impl=ref" in proc.stdout
