"""The port's prefix-token frontend (llava-next-mistral-7b and
musicgen-medium) against the JAX package on the CPU, at their reduced
configs (fp32): the configs, the model's forward, loss and gradients
(``projector`` included), prefill and decode behind a prefix (through a
wrapped ring), and the serving engine in all three modes and under
continuous batching with per-request prefixes.

Inputs come from numpy with a seed; JAX params cross through
``interop.params_from_numpy``; the JAX references are jitted and run the
plain attention (``impl="ref"``, the JAX engine's default on the CPU).

Tolerances, all fp32: logits, prefill and decode atol/rtol 2e-4 (the JAX
suite's pin for decode logits, ``tests/test_serve.py``); the loss 1e-5
and its gradients atol 1e-5 / rtol 1e-4, as in ``test_torch_train.py``;
greedy tokens equal up to the first step where JAX's top-1/top-2 margin
is below 2e-4 (a near-tie may flip either way).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.models import transformer as jtfm
from repro.serve import ServeEngine as JaxEngine
from repro_torch import interop
from repro_torch.checkpoint import flatten
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.core import distributed as D
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as tfm
from repro_torch.serve import ServeEngine
from repro_torch.tree import tree_map

torch.set_num_threads(1)
ARCHS = ["llava-next-mistral-7b", "musicgen-medium"]
LOGITS = dict(atol=2e-4, rtol=2e-4)
ATOL = 2e-4
S = 24                     # tokens behind the prefix in the model tests


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _long(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def _prefix(cfg, batch, seed):
    return np.random.default_rng(seed).normal(
        0, 1, (batch, cfg.prefix_tokens, cfg.prefix_dim)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(cfg, port cfg, JAX params of one model and of K = 2 stacked,
    the port's copies, tokens (2, S), prefix (2, P, pd))."""
    cfg, tcfg = jget_reduced(arch), get_reduced(arch)
    init = jax.jit(lambda k: jtfm.init_model(k, cfg))
    params = init(jax.random.PRNGKey(0))
    sparams = jax.vmap(init)(jax.random.split(jax.random.PRNGKey(1), 2))
    port = lambda p: interop.params_from_numpy(        # noqa: E731
        jax.tree.map(np.asarray, p), device="cpu")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32)
    return (cfg, tcfg, params, sparams, port(params), port(sparams), toks,
            _prefix(cfg, 2, 1))


@pytest.fixture(params=ARCHS)
def model(request):
    return _model(request.param)


# ---------------------------------------------------------------------------
# (a) configs

@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch):
    """The port's copy of CONFIG and reduced() equals the JAX package's
    field by field and counts the same params (the projector included);
    the registry lists both archs."""
    for mine, ref in ((get_config(arch), jget_config(arch)),
                      (get_reduced(arch), jget_reduced(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.param_count() == ref.param_count()
        assert mine.prefix_tokens > 0 and mine.prefix_dim > 0
    assert arch in ARCH_IDS


# ---------------------------------------------------------------------------
# (b) the model: forward, loss and gradients

def test_forward_logits_over_prefix_and_tokens_match_jax(model):
    """Logits (B, P + S, V) with one prefix shared by the batch, and K = 2
    clients each with its own prefix (K, B, P, pd)."""
    cfg, tcfg, params, sparams, tparams, tsparams, toks, prefix = model
    fwd = jax.jit(lambda p, t, pe: jtfm.forward(p, cfg, t, pe, remat=False,
                                                impl="ref")[0])
    want = fwd(params, jnp.asarray(toks), jnp.asarray(prefix))
    got = tfm.forward(tparams, tcfg, _long(toks), torch.from_numpy(prefix),
                      remat=False, impl="ref")
    assert got.shape == (2, cfg.prefix_tokens + S, cfg.vocab_size)
    _close(got, want, **LOGITS)
    per_client = np.stack([prefix, _prefix(cfg, 2, 2)])
    want = jax.vmap(fwd, in_axes=(0, None, 0))(
        sparams, jnp.asarray(toks), jnp.asarray(per_client))
    got = tfm.forward_clients(tsparams, tcfg, _long(toks),
                              torch.from_numpy(per_client), remat=False,
                              impl="ref")
    _close(got, want, **LOGITS)


@pytest.mark.parametrize("ce_impl", ["dense", "chunked"])
def test_loss_and_grads_match_jax(model, ce_impl):
    """``loss_fn`` with the prefix offset (logits at P-1 .. P+S-2 predict
    tokens[0:]) and its gradient, the ``projector`` leaves included, under
    remat."""
    cfg, tcfg, params, _, tparams, _, toks, prefix = model
    (want, wm), wg = jax.jit(jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, cfg, jnp.asarray(toks),
                               jnp.asarray(prefix), ce_impl=ce_impl,
                               impl="ref"), has_aux=True))(params)
    got, gm, grads = D.value_and_grad(
        lambda p: tfm.loss_fn(p, tcfg, _long(toks), torch.from_numpy(prefix),
                              ce_impl=ce_impl, impl="ref"), tparams)
    _close(got, want, atol=1e-5, rtol=1e-5)
    _close(gm["ce"], wm["ce"], atol=1e-5, rtol=1e-5)
    got, want = flatten(grads), flatten(jax.tree.map(np.asarray, wg))
    assert sorted(got) == sorted(want)
    assert {"projector/w", "projector/b"} <= set(got)
    for key in want:
        _close(got[key], want[key], atol=1e-5, rtol=1e-4, err_msg=key)
    assert got["projector/w"].abs().sum() > 0


# ---------------------------------------------------------------------------
# (c) prefill and decode behind a prefix

@pytest.mark.parametrize("arch,Sp", [("llava-next-mistral-7b", 9),
                                     ("llava-next-mistral-7b", 60),
                                     ("musicgen-medium", 9)])
def test_prefill_decode_with_prefix(arch, Sp):
    """``tests/test_serve.py::test_vlm_prefill_decode_with_prefix`` for the
    port: prefill's last-token logits and teacher-forced decode steps at
    positions P + Sp + t equal the port's full forward and the JAX
    package's prefill/decode.  With Sp = 60, P + Sp = 76 is past reduced
    llava's window of 64: the ring (64 slots) holds the prompt's tail and
    decode wraps around it."""
    cfg, tcfg, params, _, tparams, _, _, _ = _model(arch)
    P, n_dec = cfg.prefix_tokens, 3
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, Sp + n_dec)).astype(np.int32)
    prefix = _prefix(cfg, 1, 4)
    max_seq = P + Sp + n_dec
    full = tfm.forward(tparams, tcfg, _long(toks), torch.from_numpy(prefix),
                       impl="ref")
    lg, cache = tfm.prefill(tparams, tcfg, _long(toks[:, :Sp]),
                            torch.from_numpy(prefix), max_seq=max_seq,
                            impl="ref")
    want, wcache = jax.jit(lambda p, t, pe: jtfm.prefill(
        p, cfg, t, pe, max_seq=max_seq))(params, jnp.asarray(toks[:, :Sp]),
                                         jnp.asarray(prefix))
    if cfg.sliding_window and P + Sp > cfg.sliding_window:
        assert cache["slot0"]["k"].shape[2] == cfg.sliding_window
    _close(lg, full[:, P + Sp - 1], **LOGITS)
    _close(lg, want, **LOGITS)
    step = jax.jit(lambda p, t, c, pos: jtfm.decode_step(p, cfg, t, c, pos))
    for t in range(n_dec - 1):
        tok = toks[:, Sp + t:Sp + t + 1]
        lg, cache = tfm.decode_step(tparams, tcfg, _long(tok), cache,
                                    P + Sp + t)
        want, wcache = step(params, jnp.asarray(tok), wcache,
                            jnp.int32(P + Sp + t))
        _close(lg, full[:, P + Sp + t], **LOGITS)
        _close(lg, want, **LOGITS)


# ---------------------------------------------------------------------------
# (d) the serving engine

def _engines(arch, mode, **kw):
    cfg, tcfg, params, sparams, tparams, tsparams, _, _ = _model(arch)
    if mode == "single":
        sparams, tsparams = params, tparams
    kw = dict(mode=mode, slots=2, max_seq=cfg.prefix_tokens + 72, **kw)
    return (JaxEngine(cfg, sparams, **kw),
            ServeEngine(tcfg, tsparams, device="cpu", **kw))


def _agree_until_near_tie(want_toks, got_toks, want_lg):
    """Tokens equal up to the first step whose top-2 margin < ATOL."""
    top2 = -np.sort(-want_lg, axis=-1)[..., :2]
    margin = top2[..., 0] - top2[..., 1]            # (B, G) for emissions 1..
    for b in range(want_toks.shape[0]):
        for t in range(want_toks.shape[1]):
            if t > 0 and margin[b, t - 1] < ATOL:
                break
            assert want_toks[b, t] == got_toks[b, t], (b, t)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["single", "average", "route"])
def test_generate_matches_jax_engine(arch, mode):
    """Two prompts of 60 behind their prefixes, 6 new tokens: decode
    starts at P + 60 (reduced llava: past its window of 64, so the ring
    wraps)."""
    cfg, _, _, _, _, _, _, _ = _model(arch)
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 60)).astype(np.int32)
    prefix = _prefix(cfg, 2, 6)
    jeng, teng = _engines(arch, mode)
    want_toks, want_lg = jeng.generate(prompts, 6, prefix=prefix,
                                       return_logits=True)
    got_toks, got_lg = teng.generate(prompts, 6, prefix=prefix,
                                     return_logits=True)
    np.testing.assert_allclose(got_lg, np.asarray(want_lg), atol=ATOL,
                               rtol=ATOL)
    _agree_until_near_tie(np.asarray(want_toks), got_toks,
                          np.asarray(want_lg))
    assert teng.dispatch_counts() == jeng.dispatch_counts()


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_batching_with_prefixes_matches_jax_engine(arch):
    """Five requests over two slots, each with its own prefix: an admitted
    slot decodes from P + len(prompt)."""
    cfg, _, _, _, _, _, _, _ = _model(arch)
    jeng, teng = _engines(arch, "average", chunk=3)
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(0, cfg.vocab_size, (3 + 13 * i,)).astype(np.int32),
             4 + i % 3, _prefix(cfg, 1, 10 + i)[0]) for i in range(5)]
    for p, n, pe in reqs:
        jeng.submit(p, n, prefix=pe)
        teng.submit(p, n, prefix=pe)
    want, got = jeng.run(), teng.run()
    assert set(got) == set(want) == set(range(5))
    for rid in want:
        assert np.array_equal(got[rid], want[rid]), rid
    assert teng.dispatch_counts() == jeng.dispatch_counts()
    assert teng.scheduler.idle


def test_prefix_requests_refused_as_in_jax():
    """The two ``ValueError``s: a request past the arena (P + prompt +
    new > max_seq) in ``generate`` and ``submit``, and a prefix arch's
    request without its prefix."""
    arch = "llava-next-mistral-7b"
    prefix = _prefix(get_reduced(arch), 1, 0)
    for eng in _engines(arch, "single"):      # max_seq = P + 72
        with pytest.raises(ValueError, match="exceeds max_seq"):
            eng.generate(np.zeros((1, 70), np.int32), 3, prefix=prefix)
        with pytest.raises(ValueError, match="exceeds max_seq"):
            eng.submit(np.zeros(70, np.int32), 3, prefix=prefix[0])
        with pytest.raises(ValueError, match="prefix embedding"):
            eng.submit(np.zeros(8, np.int32), 3)
        assert eng.submit(np.zeros(70, np.int32), 2, prefix=prefix[0]) == 0


def test_serve_cli_llava_requests_on_cpu(capsys):
    """``launch.serve --arch llava-next-mistral-7b --requests 3`` draws a
    prefix per request and serves them all."""
    assert serve_cli.main(["--arch", "llava-next-mistral-7b", "--requests",
                           "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "arch=llava-next-mistral-7b random-init" in out
    assert "served 3 requests" in out and "impl=ref" in out


def test_port_engine_takes_prefix_params_from_init():
    """``init_model`` of a prefix arch makes the projector leaves the
    engine's prefill reads: a K = 2 ensemble of port-initialised clients
    serves a prefixed prompt, and another prefix changes the logits."""
    tcfg = get_reduced("musicgen-medium")
    sp = tfm.init_model(0, tcfg, n_clients=2, device="cpu")
    assert sp["projector"]["w"].shape == (2, tcfg.prefix_dim, tcfg.d_model)
    eng = ServeEngine(tcfg, sp, mode="average", slots=1,
                      max_seq=tcfg.prefix_tokens + 16, device="cpu")
    prompts = np.arange(8, dtype=np.int32)[None]
    a = eng.generate(prompts, 2, prefix=_prefix(tcfg, 1, 0),
                     return_logits=True)[1]
    b = eng.generate(prompts, 2, prefix=_prefix(tcfg, 1, 1),
                     return_logits=True)[1]
    assert np.isfinite(a).all() and not np.allclose(a, b)
    assert tree_map(lambda t: t.shape, sp)["projector"]["b"] == (
        2, tcfg.d_model)
