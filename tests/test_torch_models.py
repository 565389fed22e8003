"""The port's model stack (``repro_torch.models``) against the JAX package
at reduced qwen3-4b (fp32), weights carried across with
``interop.params_from_numpy``.

Tolerance: atol/rtol 2e-4 on logits -- the JAX suite's own pin for
teacher-forced decode logits; layer outputs 1e-5 (one fp32 op chain, only
the summation order differs).  Prompts span more than one 128-block.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_reduced as jget_reduced
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro_torch import checkpoint, interop
from repro_torch.checkpoint import flatten
from repro_torch.configs import get_config, get_reduced
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)
LOGITS = dict(atol=2e-4, rtol=2e-4)
LAYER = dict(atol=1e-5, rtol=1e-5)
S = 150


@functools.lru_cache(maxsize=None)
def _setup(variant=""):
    cfg = jget_reduced("qwen3-4b")
    tcfg = get_reduced("qwen3-4b")
    if variant == "bias":
        cfg, tcfg = cfg.replace(qkv_bias=True), tcfg.replace(qkv_bias=True)
    params = jtfm.init_model(jax.random.PRNGKey(0), cfg)
    if variant == "bias":                   # a non-zero bias to test
        b = params["periods"]["slot0"]["mixer"]["b_qkv"]
        params["periods"]["slot0"]["mixer"]["b_qkv"] = jax.random.normal(
            jax.random.PRNGKey(5), b.shape)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    return cfg, tcfg, params, tparams, toks


def _long(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# layers

def test_rms_norm_scales_by_one_plus_weight():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64), np.float32) * 3
    w = rng.standard_normal((64,), np.float32)
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    _close(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           want, LAYER)


def test_rope_split_halves_fp32_angles():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 4, 32), np.float32)
    pos = np.asarray([[0, 1, 2, 3, 100, 1000, 4095]] * 2, np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    _close(tlayers.apply_rope(torch.from_numpy(x), _long(pos), 1e6), want,
           LAYER)


def test_mlp_with_client_axis():
    cfg, _, params, tparams, _ = _setup()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, cfg.d_model), np.float32)
    jp = jax.tree.map(lambda t: t[0], params["periods"]["slot0"]["ffn"])
    tp = tree_map(lambda t: t[None, 0], tparams["periods"]["slot0"]["ffn"])
    want = jlayers.apply_mlp(jp, jnp.asarray(x))
    _close(tlayers.apply_mlp(tp, torch.from_numpy(x)[None])[0], want, LAYER)


@pytest.mark.parametrize("jax_impl", ["ref", "interpret"])
@pytest.mark.parametrize("variant", ["", "bias"])
def test_attention_forward(jax_impl, variant):
    """Against the JAX oracle and against JAX through the interpreted
    Pallas flash kernel; qk-norm, GQA, and (variant) a QKV bias."""
    cfg, tcfg, params, tparams, _ = _setup(variant)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, S, cfg.d_model), np.float32)
    jp = jax.tree.map(lambda t: t[0], params["periods"]["slot0"]["mixer"])
    tp = tree_map(lambda t: t[None, 0], tparams["periods"]["slot0"]["mixer"])
    want = jattn.attention_forward(jp, cfg, jnp.asarray(x), impl=jax_impl)
    got = tattn.attention_forward(tp, tcfg, torch.from_numpy(x)[None],
                                  impl="ref")[0]
    _close(got, want, LAYER)


# ---------------------------------------------------------------------------
# whole model

@pytest.mark.parametrize("variant", ["", "bias"])
def test_forward_logits(variant):
    cfg, tcfg, params, tparams, toks = _setup(variant)
    want, _ = jtfm.forward(params, cfg, jnp.asarray(toks), remat=False,
                           impl="ref")
    got = ttfm.forward(tparams, tcfg, _long(toks), impl="ref")
    _close(got, want, LOGITS)


@pytest.mark.parametrize("max_seq,window", [(160, None), (160, 40),
                                            (100, None)])
def test_prefill_logits_and_cache(max_seq, window):
    """Last-token logits and the ring cache, including a prompt longer than
    the ring (window 40, or max_seq < S) whose tail is rolled in."""
    cfg, tcfg, params, tparams, toks = _setup()
    with jops.use_impl("interpret"):        # JAX prefill through the kernel
        want, wcache = jtfm.prefill(params, cfg, jnp.asarray(toks),
                                    max_seq=max_seq, window=window)
    got, cache = ttfm.prefill(tparams, tcfg, _long(toks), max_seq=max_seq,
                              window=window, impl="ref")
    _close(got, want, LOGITS)
    for name in ("k", "v"):
        _close(cache["slot0"][name], wcache["slot0"][name], LAYER)
    assert np.array_equal(cache["slot0"]["pos"].numpy(),
                          np.asarray(wcache["slot0"]["pos"]))


@pytest.mark.parametrize("per_slot,window", [(False, None), (True, None),
                                             (True, 40)])
def test_decode_steps_match_jax(per_slot, window):
    """Five teacher-forced decode steps after a prefill, scalar position or
    per-slot (B,) positions; with a window the ring wraps as it decodes."""
    cfg, tcfg, params, tparams, toks = _setup()
    _, wcache = jtfm.prefill(params, cfg, jnp.asarray(toks[:, :S - 5]),
                             max_seq=S, window=window)
    _, cache = ttfm.prefill(tparams, tcfg, _long(toks[:, :S - 5]), max_seq=S,
                            window=window, impl="ref")
    for t in range(S - 5, S):
        pos = np.full((2,), t, np.int32) if per_slot else t
        want, wcache = jtfm.decode_step(params, cfg,
                                        jnp.asarray(toks[:, t:t + 1]),
                                        wcache, jnp.asarray(pos),
                                        window=window)
        got, cache = ttfm.decode_step(tparams, tcfg, _long(toks[:, t:t + 1]),
                                      cache, torch.as_tensor(pos),
                                      window=window)
        _close(got, want, LOGITS)


def test_decode_logits_match_forward():
    """Prefill + decode == the teacher-forced forward at the same
    positions, within the port itself."""
    _, tcfg, _, tparams, toks = _setup()
    full = ttfm.forward(tparams, tcfg, _long(toks), impl="ref")
    _, cache = ttfm.prefill(tparams, tcfg, _long(toks[:, :140]), max_seq=S,
                            impl="ref")
    for t in range(140, S):
        got, cache = ttfm.decode_step(tparams, tcfg, _long(toks[:, t:t + 1]),
                                      cache, t)
        torch.testing.assert_close(got, full[:, t], **LOGITS)


def test_stacked_clients_equal_each_client_alone():
    """The written-out client axis: K clients in one batched call give
    each client's own single-model result."""
    cfg, tcfg, _, _, toks = _setup()
    stacked = jax.vmap(lambda k: jtfm.init_model(k, cfg))(
        jax.random.split(jax.random.PRNGKey(1), 3))
    sp = interop.params_from_numpy(jax.tree.map(np.asarray, stacked),
                                   device="cpu")
    got, _ = ttfm.prefill_clients(sp, tcfg, _long(toks), max_seq=S,
                                  impl="ref")
    for c in range(3):
        one, _ = ttfm.prefill(tree_map(lambda t: t[c], sp), tcfg,
                              _long(toks), max_seq=S, impl="ref")
        torch.testing.assert_close(got[c], one, **LAYER)


# ---------------------------------------------------------------------------
# init, interop, checkpoint, unported configs

def test_init_model_shapes_and_distributions():
    cfg, tcfg, params, _, _ = _setup()
    tp = ttfm.init_model(0, tcfg, device="cpu")
    want = jax.tree.map(lambda t: (t.shape, str(t.dtype)), params)
    got = tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tp)
    assert got == want
    mixer = tp["periods"]["slot0"]["mixer"]
    std = mixer["w_qkv"].std().item() * cfg.d_model ** 0.5
    assert abs(std - 0.8796) < 0.02        # N(0,1) cut to [-2, 2]
    assert mixer["w_qkv"].abs().max() <= 2 * cfg.d_model ** -0.5 + 1e-6
    assert abs(tp["embed"].std().item() - 0.02) < 1e-3
    assert not tp["final_norm"].any() and not mixer["q_norm"].any()
    again = ttfm.init_model(0, tcfg, device="cpu")
    other = ttfm.init_model(1, tcfg, device="cpu")
    assert torch.equal(again["embed"], tp["embed"])
    assert not torch.equal(other["embed"], tp["embed"])
    stacked = ttfm.init_model(0, tcfg, n_clients=3, device="cpu")
    assert stacked["lm_head"].shape == (3, cfg.d_model, cfg.vocab_size)


def test_full_width_config_matches_jax():
    from repro.configs import get_config as jget_config
    j, t = jget_config("qwen3-4b"), get_config("qwen3-4b")
    assert {f: getattr(t, f) for f in t.__dataclass_fields__
            if f not in ("period", "moe", "ssm")} == \
        {f: getattr(j, f) for f in t.__dataclass_fields__
         if f not in ("period", "moe", "ssm")}
    assert t.pdtype() == t.cdtype() == torch.bfloat16


def test_interop_round_trip_flat_keys_and_bf16():
    cfg, _, params, _, _ = _setup()
    bf = jax.tree.map(lambda t: t.astype(jnp.bfloat16), params)
    flat = jckpt._flatten(bf)              # '/'-joined keys, ml_dtypes bf16
    tp = interop.params_from_numpy(flat, device="cpu")
    assert tp["lm_head"].dtype == torch.bfloat16
    back = interop.params_to_numpy(tp)
    for key, leaf in jckpt._flatten(back).items():
        assert leaf.dtype == flat[key].dtype
        assert np.array_equal(leaf.view(np.uint16), flat[key].view(np.uint16))


def test_checkpoint_schema_both_ways(tmp_path):
    """A port-written file restores in JAX and a JAX-written one in the
    port, bf16 leaves included."""
    _, _, params, tparams, _ = _setup()
    tree = {"client_params": tree_map(lambda t: t.to(torch.bfloat16),
                                      tparams), "step": torch.tensor(3)}
    checkpoint.save(str(tmp_path / "port"), tree, {"arch": "qwen3-4b"})
    jtree, meta = jckpt.restore(str(tmp_path / "port.npz"))
    assert meta == {"arch": "qwen3-4b"} and int(jtree["step"]) == 3
    want = np.asarray(jnp.asarray(params["embed"]).astype(jnp.bfloat16))
    assert np.array_equal(np.asarray(jtree["client_params"]["embed"]), want)
    jckpt.save(str(tmp_path / "jax"), jax.tree.map(
        lambda t: t.astype(jnp.bfloat16), params), {"x": 1})
    back, meta = checkpoint.restore(str(tmp_path / "jax"))
    assert meta == {"x": 1}
    for a, b in zip(tree_leaves(back), tree_leaves(tree["client_params"])):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_layer_groups_give_the_per_layer_gradient():
    """The forward takes a 10-layer stack's views in groups
    (``_layers``: 8 layers, then 2); the loss and every gradient equal
    those of one indexing view a layer (``_layer``), bit for bit."""
    tcfg = get_reduced("qwen3-4b").replace(n_layers=10)
    tp = ttfm.init_model(0, tcfg, n_clients=2, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (2, 12)))

    def grads():
        for t in tree_leaves(tp):
            t.requires_grad_(True)
        loss = ttfm.loss_fn_clients(tp, tcfg, toks, impl="ref")[0].sum()
        g = torch.autograd.grad(loss, tree_leaves(tp))
        for t in tree_leaves(tp):
            t.requires_grad_(False)
        return loss.detach(), g

    loss, got = grads()
    grouped = ttfm._layers
    try:
        ttfm._layers = lambda tree, n: (ttfm._layer(tree, i)
                                        for i in range(n))
        want_loss, want = grads()
    finally:
        ttfm._layers = grouped
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("change", [
    dict(prefix_tokens=4, prefix_dim=8),
])
def test_unported_layers_raise(change):
    """Named for the refusal it pinned before the prefix frontend was
    ported: a prefix config now initialises, with the JAX package's
    ``projector`` leaves (w (prefix_dim, d) and a zero b (d,), in the param
    dtype), behind the client axis when stacked."""
    for dtype in ("float32", "bfloat16"):
        cfg = jget_reduced("qwen3-4b").replace(param_dtype=dtype, **change)
        tcfg = get_reduced("qwen3-4b").replace(param_dtype=dtype, **change)
        want = jax.eval_shape(lambda k: jtfm.init_model(k, cfg),
                              jax.random.PRNGKey(0))
        got = ttfm.init_model(0, tcfg, device="cpu")
        assert sorted(flatten(got)) == sorted(jckpt._flatten(want))
        stacked = ttfm.init_model(0, tcfg, n_clients=2, device="cpu")
        for key in ("w", "b"):
            leaf, ref = got["projector"][key], want["projector"][key]
            assert tuple(leaf.shape) == ref.shape
            assert str(leaf.dtype)[6:] == str(ref.dtype)
            assert tuple(stacked["projector"][key].shape) == (2, *ref.shape)
        assert not got["projector"]["b"].any()
        assert got["projector"]["w"].float().std() > 0
