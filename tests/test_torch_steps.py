"""The port's single-model path against the JAX package on the CPU: the
step factories of ``launch/steps.py`` (the train step with AdamW, dense
and MoE, with the chunked CE and with ``slot_remat``; prefill and decode;
the multi-step decode), ``launch/serve.py::greedy_generate``, the shapes
and ``decode_window``, and ``launch/train.py --method single``.

JAX params cross through ``interop.params_from_numpy``; tokens come from
the copied ``make_token_stream``.  Tolerances, fp32, those of
``tests/test_torch_train.py``: one call's values and gradients atol/rtol
1e-5; per-step losses atol 2e-5 (and grad_norm rtol 1e-5); params after 3 AdamW steps atol 1e-4;
decode logits against the teacher-forced forward atol 2e-4 (the JAX
suite's pin); greedy tokens exactly.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_reduced as jget_reduced
from repro.configs import get_shape as jget_shape
from repro.launch import steps as jsteps
from repro.launch.serve import greedy_generate as jgreedy
from repro.models import transformer as jtfm
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch import checkpoint, interop
from repro_torch.checkpoint import flatten
from repro_torch.configs import SHAPES, get_config, get_reduced, get_shape
from repro_torch.core.distributed import value_and_grad
from repro_torch.data.synthetic import make_token_stream
from repro_torch.launch import steps
from repro_torch.launch import train as cli
from repro_torch.launch.serve import greedy_generate
from repro_torch.models import transformer as tfm
from repro_torch.optim import AdamWConfig, adamw_init

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _close(got, want, **kw):
    np.testing.assert_allclose(_np(got), _np(want), **{**TOL, **kw})


def _trees_close(got, want, **tol):
    got, want = flatten(got), flatten(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key], err_msg=key, **tol)


def _params(arch, seed=0):
    cfg = jget_reduced(arch)
    jp = jtfm.init_model(jax.random.PRNGKey(seed), cfg)
    return jp, interop.params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")


def _batch(step, B=2, S=16, V=512):
    return make_token_stream(B, S + 1, V, seed=1000 * step, domain=0)[:, :S]


@pytest.mark.parametrize("arch,ce_impl", [("qwen3-4b", "dense"),
                                          ("qwen2-moe-a2.7b", "dense"),
                                          ("qwen3-4b", "chunked")])
def test_train_step_matches_jax_over_three_steps(arch, ce_impl):
    """``make_train_step`` (loss, gradient, AdamW with the global-norm
    clip) for 3 steps from the same params and batches: every metric
    (ce, the MoE aux losses, grad_norm, lr) each step, the params and
    moments after."""
    cfg = get_reduced(arch)
    jp, params = _params(arch)
    jopt_cfg = JAdamWConfig(lr=1e-3, warmup=2, total_steps=3)
    jstep = jax.jit(jsteps.make_train_step(jget_reduced(arch), jopt_cfg,
                                           ce_impl=ce_impl))
    step = steps.make_train_step(cfg, AdamWConfig(lr=1e-3, warmup=2,
                                                  total_steps=3),
                                 ce_impl=ce_impl, impl="ref")
    jo, opt = jadamw_init(jp), adamw_init(params)
    for i in range(3):
        toks = _batch(i)
        jp, jo, jm = jstep(jp, jo, jnp.asarray(toks))
        params, opt, m = step(params, opt, torch.as_tensor(toks).long())
        assert sorted(m) == sorted(jm)
        for k in jm:          # losses atol 2e-5, grad_norm rtol 1e-5
            _close(m[k], jm[k], atol=2e-5, err_msg=k)
    _trees_close(params, jp, atol=1e-4, rtol=0)
    _trees_close(opt["mu"], jo["mu"], atol=1e-5, rtol=0)
    assert int(opt["step"]) == int(jo["step"]) == 3


def test_slot_remat_changes_no_number():
    """The gradient of the loss with each slot checkpointed on its own
    equals the gradient with whole periods checkpointed and without any
    checkpoint, bit for bit, on jamba's 8-slot period (attention, Mamba,
    MLP and MoE slots), with the loss and its metrics.  (The JAX package's
    loss is held against the port's in ``tests/test_torch_moe.py``.)"""
    arch = "jamba-1.5-large-398b"
    cfg = get_reduced(arch)
    _, params = _params(arch)
    toks = _batch(0, S=32)
    grads = {}
    for name, kw in (("slot", dict(slot_remat=True)),
                     ("period", dict(remat=True)),
                     ("none", dict(remat=False))):
        loss, m, g = value_and_grad(tfm.loss_fn, params, cfg,
                                    torch.as_tensor(toks).long(),
                                    impl="ref", **kw)
        grads[name] = (loss, m, flatten(g))
    for name in ("period", "none"):
        assert torch.equal(grads[name][0], grads["slot"][0])
        assert all(torch.equal(grads[name][2][k], v)
                   for k, v in grads["slot"][2].items())
    assert all(torch.equal(grads["none"][1][k], v)
               for k, v in grads["slot"][1].items())


@pytest.fixture(scope="module")
def decode_case():
    """qwen3-4b reduced, 2 prompts of 8, 6 new tokens: the JAX prefill,
    decode, multi-step decode and greedy generation."""
    arch, S0, n = "qwen3-4b", 8, 6
    jcfg = jget_reduced(arch)
    jp, params = _params(arch, seed=3)
    prompts = make_token_stream(2, S0, jcfg.vocab_size, seed=5)
    max_seq = S0 + n
    jlogits, jcache = jax.jit(jsteps.make_prefill_step(jcfg, max_seq))(
        jp, jnp.asarray(prompts))
    tok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    jdec = jax.jit(jsteps.make_decode_step(jcfg))(jp, tok, jcache,
                                                  jnp.int32(S0))[0]
    _, jcache = jax.jit(jsteps.make_prefill_step(jcfg, max_seq))(
        jp, jnp.asarray(prompts))
    jmulti = jax.jit(jsteps.make_multistep_decode(jcfg, n))(
        jp, tok, jcache, jnp.int32(S0), jax.random.PRNGKey(0))
    jtoks = jgreedy(jcfg, jp, jnp.asarray(prompts), n)
    return dict(arch=arch, S0=S0, n=n, params=params, prompts=prompts,
                prefill=np.asarray(jlogits), decode=np.asarray(jdec),
                multi_toks=np.asarray(jmulti[0]),
                multi_logits=np.asarray(jmulti[1]), greedy=np.asarray(jtoks))


def test_prefill_and_decode_steps_match_jax(decode_case):
    c = decode_case
    cfg = get_reduced(c["arch"])
    prefill = steps.make_prefill_step(cfg, max_seq=c["S0"] + c["n"],
                                      impl="ref")
    logits, cache = prefill(c["params"], torch.as_tensor(c["prompts"]).long())
    _close(logits, c["prefill"])
    tok = torch.argmax(logits, -1)[:, None]
    dec, _ = steps.make_decode_step(cfg)(c["params"], tok, cache, c["S0"])
    _close(dec, c["decode"])


def test_multistep_decode_matches_greedy_and_jax(decode_case):
    """Greedy tokens of ``make_multistep_decode`` equal ``greedy_generate``'s
    and the JAX package's; its logits are JAX's and align with the
    teacher-forced forward of prompt + tokens (atol 2e-4); chaining two
    calls through the carried (token, pos, generator) equals one call."""
    c = decode_case
    cfg = get_reduced(c["arch"])
    S0, n = c["S0"], c["n"]
    prompts = torch.as_tensor(c["prompts"]).long()

    def start():
        logits, cache = steps.make_prefill_step(cfg, max_seq=S0 + n,
                                                impl="ref")(c["params"],
                                                            prompts)
        return torch.argmax(logits, -1)[:, None], cache

    tok, cache = start()
    gen = torch.Generator().manual_seed(0)
    toks, logits, _, nxt, pos, g = steps.make_multistep_decode(cfg, n)(
        c["params"], tok, cache, S0, gen)
    assert toks.shape == (2, n) and logits.shape == (2, n, cfg.vocab_size)
    assert pos == S0 + n and g is gen and nxt.shape == (2, 1)
    greedy = greedy_generate(cfg, c["params"], prompts, n, impl="ref")
    assert torch.equal(toks, greedy)
    assert np.array_equal(toks.numpy(), c["multi_toks"])
    assert np.array_equal(greedy.numpy(), c["greedy"])
    _close(logits, c["multi_logits"])
    full = tfm.forward(c["params"], cfg, torch.cat([prompts, toks], 1),
                       impl="ref")
    _close(logits, full[:, S0:S0 + n], atol=2e-4, rtol=0)
    tok, cache = start()
    a = steps.make_multistep_decode(cfg, 2)(c["params"], tok, cache, S0,
                                            gen)
    b = steps.make_multistep_decode(cfg, n - 2)(c["params"], a[3], a[2],
                                                a[4], a[5])
    assert torch.equal(torch.cat([a[0], b[0]], 1), toks)


def test_shapes_and_decode_window_match_jax():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    from repro.configs import get_config as jget_config
    for name in SHAPES:
        assert dataclasses.asdict(get_shape(name)) == \
            dataclasses.asdict(jget_shape(name))
        for arch in ("qwen3-4b", "mamba2-780m", "llava-next-mistral-7b",
                     "jamba-1.5-large-398b"):
            assert steps.decode_window(get_config(arch), get_shape(name)) \
                == jsteps.decode_window(jget_config(arch), jget_shape(name))


def test_single_method_is_the_cli_default(tmp_path, capsys):
    """``launch.train`` without ``--method`` trains one model (the JAX
    CLI's default) and ``--save`` writes its params with the JAX CLI's
    meta, which the npz schema restores."""
    path = str(tmp_path / "single")
    assert cli.main(["--steps", "2", "--seq", "16", "--batch", "2",
                     "--device", "cpu", "--save", path]) == 0
    out = capsys.readouterr().out
    assert "model: qwen3-4b on cpu, kernels ref" in out
    assert "step    0 ce=" in out and "step    1 ce=" in out
    assert os.path.exists(path + ".npz")
    params, meta = checkpoint.restore(path)
    assert meta == {"arch": "qwen3-4b", "method": "single", "steps": 2}
    want = tfm.init_model(0, get_reduced("qwen3-4b"), device="cpu")
    assert sorted(flatten(params)) == sorted(flatten(want))
