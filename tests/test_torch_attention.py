"""The port's attention (``repro_torch.kernels``) against the JAX package.

Inputs come from numpy with a seed and go through both packages.  The JAX
flash kernel runs in interpret mode, as its own suite runs it on the CPU.
Tolerance: fp32 atol/rtol 1e-5 -- both sides compute fp32 softmax
attention and differ only in summation order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import _flash_forward
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(B, S, T, Hq, Hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hq, hd), np.float32)
    k = rng.standard_normal((B, T, Hkv, hd), np.float32)
    v = rng.standard_normal((B, T, Hkv, hd), np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,window", [
    (1, 64, 2, 2, 16, None),      # MHA
    (2, 96, 4, 2, 32, None),      # GQA 2:1
    (1, 128, 8, 1, 8, None),      # MQA
    (2, 150, 4, 2, 32, None),     # ragged S, not a multiple of 128
    (2, 150, 4, 2, 32, 33),       # sliding window
    (1, 40, 4, 1, 16, 1),         # window of one: attends to itself
])
def test_plain_attention_matches_jax_ref(B, S, Hq, Hkv, hd, window):
    q, k, v = _inputs(B, S, S, Hq, Hkv, hd)
    want = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, window=window)
    got = ops.attention(*_t(q, k, v), causal=True, window=window, impl="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S,Hq,Hkv,window", [
    (150, 4, 2, None),            # two 128-blocks, the second ragged
    (150, 4, 1, 40),              # window skips the first block for late rows
    (256, 2, 2, None),            # exact multiple of the block
])
def test_plain_attention_and_lse_match_jax_flash_interpret(S, Hq, Hkv,
                                                           window):
    """Out and the per-row logsumexp against the Pallas kernel's forward
    (interpret mode, 128x128 blocks, the production block shape)."""
    q, k, v = _inputs(2, S, S, Hq, Hkv, 32, seed=1)
    qt, kt, vt = (jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v))
    want_out, want_lse = _flash_forward(qt, kt, vt, True, window, 128, 128,
                                        True)
    out, lse = ref.attention_lse(*_t(q, k, v), causal=True, window=window)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(want_out.transpose(0, 2, 1, 3)), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)
    public = jflash(qt, kt, vt, causal=True, window=window, interpret=True)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(public.transpose(0, 2, 1, 3)), **TOL)


@pytest.mark.parametrize("window", [None, 5])
def test_cache_positions_with_invalid_slots(window):
    """The decode path: explicit positions, -1 marking unwritten ring slots,
    per-sequence query positions."""
    B, T, Hq, Hkv, hd = 3, 12, 4, 2, 16
    q, k, v = _inputs(B, 1, T, Hq, Hkv, hd, seed=2)
    pos_k = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    pos_k[0, 7:] = -1                       # slot 0 holds 7 tokens
    pos_k[1, :] = (np.arange(T) + 12)       # slot 1 wrapped: positions 12..23
    pos_k[1, :3] = np.arange(24, 27)
    pos_q = np.asarray([[6], [26], [11]], np.int32)
    want = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, window=window,
                          positions_q=jnp.asarray(pos_q),
                          positions_k=jnp.asarray(pos_k))
    got = ops.attention(*_t(q, k, v), causal=True, window=window,
                        positions_q=torch.from_numpy(pos_q).long(),
                        positions_k=torch.from_numpy(pos_k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_wrapper_on_cpu_takes_the_plain_version():
    q, k, v = _t(*_inputs(1, 20, 20, 4, 2, 32, seed=3))
    before = fa.launches
    out, lse = fa.flash_attention(q, k, v, window=7)
    want, want_lse = ref.attention_lse(q, k, v, window=7)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    assert fa.launches == before           # no kernel was launched


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "stride", "grad",
                                 "window", "groups"])
def test_flash_wrapper_refuses_what_the_kernel_does_not_take(bad):
    """The checks run before any launch on a CUDA tensor; they are plain
    Python, so they are exercised here on CPU tensors."""
    q, k, v = _t(*_inputs(1, 8, 8, 4, 2, 32))
    window, dout = None, None
    if bad == "head_dim":
        q, k, v = _t(*_inputs(1, 8, 8, 4, 2, 48))
    elif bad == "dtype":
        k = k.to(torch.bfloat16)
    elif bad == "stride":
        v = torch.from_numpy(np.asarray(_inputs(1, 8, 8, 4, 2, 64)[2]))[
            ..., ::2]
    elif bad == "grad":                 # the backward's gradient of out
        dout = torch.zeros(1, 8, 4, 16)
    elif bad == "window":
        window = 0
    elif bad == "groups":
        q = torch.from_numpy(_inputs(1, 8, 8, 3, 2, 32)[0])
    with pytest.raises(ValueError):
        fa._check(q, k, v, window, dout)


@pytest.mark.parametrize("bad", [None, "q_offset", "k_offset", "v_offset",
                                 "v_strides"])
def test_flash_check_refuses_misaligned_bf16_views(bad):
    """The bf16 tensor-core kernels copy 16-byte rows (TMA, cp.async), so
    ``_check`` refuses a bf16 view whose base pointer or batch, sequence
    or head stride is not a whole 16 bytes, before any launch.  A view
    ``x[..., 1:1 + hd]`` of a wider tensor starts 2 bytes off; a head axis
    of hd + 4 elements gives strides of 8-byte multiples.  fp32 keeps the
    FMA kernels, which take any such view."""
    hd = 32
    q, k, v = (t.to(torch.bfloat16) for t in _t(*_inputs(1, 8, 8, 4, 2, hd)))
    if bad in ("q_offset", "k_offset", "v_offset"):
        name = bad[0]
        x = {"q": q, "k": k, "v": v}[name]
        wide = torch.zeros(*x.shape[:3], hd + 8, dtype=torch.bfloat16)
        view = wide[..., 1:1 + hd]
        view.copy_(x)
        assert view.data_ptr() % 16 == 2
        q, k, v = (view if n == name else t
                   for n, t in (("q", q), ("k", k), ("v", v)))
    elif bad == "v_strides":
        v = torch.zeros(1, 8, 2, hd + 4, dtype=torch.bfloat16)[..., :hd]
    if bad is None:
        fa._check(q, k, v, None)        # the aligned views pass
        return
    with pytest.raises(ValueError, match="16-byte"):
        fa._check(q, k, v, None)
    q32 = torch.zeros(1, 8, 4, hd + 8)[..., 1:1 + hd]   # 4 bytes off
    fa._check(q32, k.float(), v.float(), None)          # fp32 takes it


def test_impl_policy():
    q, k, v = _t(*_inputs(1, 8, 8, 2, 2, 16))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="unknown kernel impl"):
        ops.attention(q, k, v, impl="pallas")
    with pytest.raises(ValueError, match="explicit impl"):
        ops.attention(q, k, v)
    assert ops.resolve_impl(None, "cpu") == "ref"
    assert ops.resolve_impl("ref", "cpu") == "ref"
    with pytest.raises(ValueError):
        ops.resolve_impl("cuda", "cpu")
    with pytest.raises(ValueError):
        ops.resolve_impl("interpret", "cpu")
