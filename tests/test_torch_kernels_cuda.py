"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one: a CUDA kernel
has no CPU mode (on CPU tensors the wrappers run the plain versions, which
the other ``test_torch_*`` files hold against the JAX package).  The module
imports no JAX, so it also runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # a full-fp32 reference
    return torch.device("cuda")


def _qkv(device, dtype, B=2, S=300, Hq=8, Hkv=4, hd=64, seed=0):
    """q, k, v as strided slices of one fused (B, S, Hq + 2 Hkv, hd)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(B, S, Hq + 2 * Hkv, hd, generator=gen,
                      device=device).to(dtype)
    return qkv[:, :, :Hq], qkv[:, :, Hq:Hq + Hkv], qkv[:, :, Hq + Hkv:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,window,causal", [(128, None, True),
                                              (64, 37, True),
                                              (32, None, False)])
def test_flash_kernel_matches_plain(cuda, dtype, hd, window, causal):
    """fp32: atol 1e-4 (summation order only); bf16: atol/rtol 2e-2 against
    the plain version on the same bf16 inputs (one rounding of out); lse
    atol 1e-3 (fp32 in both)."""
    q, k, v = _qkv(cuda, dtype, hd=hd)
    before = fa.launches
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window)
    want, want_lse = ref.attention_lse(q, k, v, causal=causal, window=window)
    assert fa.launches == before + 1
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), atol=tol,
                               rtol=0 if dtype == torch.float32 else tol)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)


def test_ops_cuda_impl_reaches_the_kernel(cuda):
    q, k, v = _qkv(cuda, torch.bfloat16)
    before = fa.launches
    got = ops.attention(q, k, v, impl="cuda")
    assert fa.launches == before + 1
    torch.testing.assert_close(got.float(), ref.attention(q, k, v).float(),
                               atol=2e-2, rtol=2e-2)
    decode = ops.attention(q[:, -1:], k, v, impl="cuda",
                           positions_q=torch.full((2, 1), 299, device=cuda),
                           positions_k=torch.arange(300, device=cuda)
                           .expand(2, 300))
    assert fa.launches == before + 1          # explicit positions: plain
    torch.testing.assert_close(decode.float(), got[:, -1:].float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("bad", ["head_dim", "grad", "device"])
def test_flash_kernel_refuses_before_launch(cuda, bad):
    q, k, v = _qkv(cuda, torch.float32, hd=48 if bad == "head_dim" else 64)
    if bad == "device":
        k = k.cpu()
    before = fa.launches
    with pytest.raises(ValueError):
        if bad == "grad":               # a gradient of out of the wrong dtype
            fa._check(q, k, v, None, torch.zeros(q.shape, device=cuda,
                                                 dtype=torch.bfloat16))
        fa.flash_attention(q, k, v)
    assert fa.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,window", [(2, 300, 8, 4, 64, None),
                                                  (1, 130, 32, 8, 128, 37),
                                                  (3, 65, 4, 1, 32, None)])
def test_flash_backward_matches_autograd_of_plain(cuda, dtype, B, S, Hq, Hkv,
                                                  hd, window):
    """dq, dk, dv of the CUDA backward against autograd of
    ``ref.attention_lse`` on the same inputs (v a strided slice of the
    fused QKV): relative norm error 1e-5 in fp32 (summation order), 2e-2 in
    bf16 (the gradients are rounded to bf16 once, the plain version's
    softmax saw bf16-rounded out)."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(B, S, Hq + 2 * Hkv, hd, generator=gen,
                      device=cuda).to(dtype)
    dout = torch.randn(B, S, Hq, hd, generator=gen, device=cuda).to(dtype)
    grads = []
    for fn in (lambda *a: fa.flash_attention(*a, window=window)[0],
               lambda *a: ref.attention_lse(*a, window=window)[0]):
        x = qkv.clone().requires_grad_(True)
        before = fa.bwd_launches
        fn(x[:, :, :Hq], x[:, :, Hq:Hq + Hkv], x[:, :, Hq + Hkv:]) \
            .backward(dout)
        grads.append(x.grad.float())
    assert fa.bwd_launches == before           # the plain version: no launch
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    got, want = grads
    for sl in (slice(0, Hq), slice(Hq, Hq + Hkv), slice(Hq + Hkv, None)):
        err = (got[:, :, sl] - want[:, :, sl]).norm() / want[:, :, sl].norm()
        assert err.item() < tol


@pytest.mark.parametrize("B,S,T,Hq,Hkv,hd,window,causal", [
    (2, 1, 1, 8, 8, 64, None, True),          # one row, G = 1
    (2, 17, 17, 8, 2, 32, None, True),        # G = 4
    (1, 65, 65, 32, 4, 128, 37, True),        # G = 8, window 37
    (2, 130, 130, 8, 2, 64, None, False),     # non-causal
    (1, 1000, 1000, 8, 1, 128, 256, True),    # window 256 in 128-row tiles
    (1, 1000, 1000, 16, 4, 64, 37, True),
    (2, 130, 200, 4, 4, 32, None, False),     # T != S
    (1, 65, 300, 8, 2, 128, None, True),      # T > S, causal
    (3, 17, 130, 8, 8, 128, 256, False)])     # non-causal window
def test_flash_bf16_tensor_core_edges(cuda, B, S, T, Hq, Hkv, hd, window,
                                      causal):
    """The bf16 tensor-core kernels at ragged lengths (none a multiple of
    a tile), every head dim, G = 1, 4, 8, windows, non-causal and T != S,
    with v (and k) strided slices of a fused projection: the forward
    against ``ref.attention_lse`` (out atol/rtol 2e-2, one rounding of out
    and of P to bf16; lse atol 1e-3), dq, dk, dv against its autograd
    (relative norm 2e-2: P and ds are rounded to bf16 before their
    products, the gradients once more; the norm floored at 1, since at
    S = T = 1 dq is 0 up to rounding)."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(B, S, Hq, hd, generator=gen, device=cuda).bfloat16()
    kv = torch.randn(B, T, 2 * Hkv, hd, generator=gen, device=cuda)
    kv = kv.bfloat16()
    dout = torch.randn(B, S, Hq, hd, generator=gen, device=cuda).bfloat16()
    outs, grads = [], []
    before = fa.launches, fa.bwd_launches
    for fn in (fa.flash_attention, ref.attention_lse):
        qx = q.clone().requires_grad_(True)
        kvx = kv.clone().requires_grad_(True)
        out, lse = fn(qx, kvx[:, :, :Hkv], kvx[:, :, Hkv:], causal=causal,
                      window=window)
        out.backward(dout)
        outs.append((out.detach().float(), lse))
        grads.append((qx.grad.float(), kvx.grad[:, :, :Hkv].float(),
                      kvx.grad[:, :, Hkv:].float()))
    assert (fa.launches, fa.bwd_launches) == (before[0] + 1, before[1] + 1)
    (out, lse), (want, want_lse) = outs
    torch.testing.assert_close(out, want, atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
    for got, exp in zip(*grads):
        assert ((got - exp).norm() / max(exp.norm().item(), 1.0)) < 2e-2


@pytest.mark.parametrize("Hq,Hkv", [(16, 16), (48, 8), (24, 8), (64, 8)])
def test_flash_at_the_new_archs_head_layouts(cuda, Hq, Hkv):
    """The bf16 flash forward and backward at the head layouts of
    qwen2-moe-a2.7b (16/16), dbrx-132b (48/8, GQA 6:1), minitron-4b (24/8)
    and qwen1.5-110b (64/8), head_dim 128, q, k, v slices of a fused QKV:
    out atol/rtol 2e-2 and lse atol 1e-3 against ``ref.attention_lse``,
    dq, dk, dv within relative norm 2e-2 of its autograd (the tolerances
    of ``test_flash_bf16_tensor_core_edges``)."""
    B, S, hd = 2, 300, 128
    gen = torch.Generator(device=cuda).manual_seed(6)
    qkv = torch.randn(B, S, Hq + 2 * Hkv, hd, generator=gen,
                      device=cuda).bfloat16()
    dout = torch.randn(B, S, Hq, hd, generator=gen, device=cuda).bfloat16()
    outs, grads = [], []
    before = fa.launches, fa.bwd_launches
    for fn in (fa.flash_attention, ref.attention_lse):
        x = qkv.clone().requires_grad_(True)
        out, lse = fn(x[:, :, :Hq], x[:, :, Hq:Hq + Hkv], x[:, :, Hq + Hkv:])
        out.backward(dout)
        outs.append((out.detach().float(), lse))
        grads.append(x.grad.float())
    assert (fa.launches, fa.bwd_launches) == (before[0] + 1, before[1] + 1)
    (out, lse), (want, want_lse) = outs
    torch.testing.assert_close(out, want, atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
    got, exp = grads
    for sl in (slice(0, Hq), slice(Hq, Hq + Hkv), slice(Hq + Hkv, None)):
        err = (got[:, :, sl] - exp[:, :, sl]).norm() / exp[:, :, sl].norm()
        assert err.item() < 2e-2


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "dbrx-132b"])
def test_moe_on_the_card_matches_the_cpu(cuda, arch):
    """``models.moe.apply_moe`` on the card against the same module on the
    CPU from one state (reduced config, fp32, TF32 off, K = 3, two groups
    of 256): the same routes, y and the aux losses within 1e-5 of their
    largest magnitude, and every gradient (x, router, experts, shared
    experts) too.  The MoE FFN has no kernel of its own; this holds its
    index dispatch (``index_copy``, ``index_select``, ``bmm``) on CUDA."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import moe
    from repro_torch.tree import tree_leaves
    cfg = get_reduced(arch)
    gen = torch.Generator(device="cpu").manual_seed(0)
    params = moe.init_moe(gen, cfg, lead=(3,))
    x = torch.randn(3, 1, 512, cfg.d_model, generator=gen)
    gy = torch.randn(x.shape, generator=gen)
    runs = []
    for device in ("cpu", cuda):
        p = {k: (v.to(device) if torch.is_tensor(v)
                 else {n: t.to(device) for n, t in v.items()})
             for k, v in params.items()}
        leaves = [t.requires_grad_(True) for t in tree_leaves(p)]
        xd = x.to(device).requires_grad_(True)
        moe.route_log = []
        try:
            y, aux = moe.apply_moe(p, cfg, xd)
            routes = moe.route_log
        finally:
            moe.route_log = None
        total = (y * gy.to(device)).sum() + aux["load_balance"].sum() \
            + aux["router_z"].sum()
        grads = torch.autograd.grad(total, [xd] + leaves)
        runs.append(([y, aux["load_balance"], aux["router_z"], *grads],
                     routes))
    (cpu, cpu_routes), (card, card_routes) = runs
    for a, b in zip(cpu_routes[0], card_routes[0]):
        assert torch.equal(a, b.cpu())
    for a, b in zip(cpu, card):
        err = (b.cpu() - a).abs().max().item()
        assert err <= 1e-5 * max(a.abs().max().item(), 1.0)


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_flash_bf16_refuses_misaligned_view(cuda, which):
    """A bf16 view 2 bytes off a 16-byte boundary (``x[..., 1:1 + hd]`` of
    a wider tensor) raises before any launch: the kernels' TMA and cp.async
    copies move 16-byte rows."""
    q, k, v = _qkv(cuda, torch.bfloat16)
    x = {"q": q, "k": k, "v": v}[which]
    wide = torch.zeros(*x.shape[:3], x.shape[3] + 8, device=cuda,
                       dtype=torch.bfloat16)
    view = wide[..., 1:1 + x.shape[3]]
    view.copy_(x)
    args = [view if n == which else t for n, t in zip("qkv", (q, k, v))]
    before = fa.launches
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(*args)
    assert fa.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Kl,Kg,B,V,T,fixed_grad", [
    (3, 3, 64, 151_936, 1.0, False),   # the training shape's width
    (2, 5, 7, 1_000, 1.7, True),       # rectangular, ragged V, T != 1
    (8, 8, 3, 4_099, 0.5, True),       # one launch's largest client count
    (9, 9, 5, 3_001, 1.0, True),       # past it: client blocks of <= 8
    (16, 16, 4, 2_048, 1.2, True),
    (9, 16, 3, 1_500, 0.8, True),
    (16, 5, 6, 2_000, 1.0, False),
    (1, 2, 64, 151_936, 1.0, False),   # kl_to_received: 1 live, J = 2
    (1, 3, 64, 151_936, 1.0, False),   # DP-DML's fleet of four: J = 3
    (2, 4, 64, 151_936, 1.0, False)])  # the sharded step: K_loc against
#                                        K_pad, zero on self and pads
def test_kl_pair_kernels_match_plain(cuda, dtype, Kl, Kg, B, V, T,
                                     fixed_grad):
    """The pair-KL forward (atol 1e-4 + rtol 1e-4: fp32 streaming against
    a two-pass softmax) and backward (relative norm 1e-5 fp32, 2e-2 bf16)
    against ``ref.mutual_kl_pair`` and its autograd, with masked weights
    (one live row: the uniform 1/Kg of ``core.mutual.kl_to_received``;
    Kl = 2 against J = 4: ``make_sharded_dml_step``'s call for entry 0 of
    K = 3 over two entries, which holds clients 0 and 2 against the
    gathered fleet whose pad re-hosts client 0, the weights zero on each
    client's own column and on the pad)."""
    from repro_torch.core.mutual import _pair_mask
    from repro_torch.kernels import kl_mutual
    gen = torch.Generator(device=cuda).manual_seed(2)
    live = (2 * torch.randn(Kl, B, V, generator=gen, device=cuda)).to(dtype)
    fixed = (2 * torch.randn(Kg, B, V, generator=gen, device=cuda)).to(dtype)
    w = torch.full((1, Kg), 1.0 / Kg, device=cuda) if Kl == 1 else \
        _pair_mask(max(Kl, Kg), [1.0] * (max(Kl, Kg) - 1) + [0.0],
                   cuda)[:Kl, :Kg]
    if (Kl, Kg) == (2, 4):
        fixed[[0, 2, 3]] = live[[0, 1, 0]]
        w = _pair_mask(4, [1.0, 1.0, 1.0, 0.0], cuda)[[0, 2]]
        assert w[0, 0] == w[1, 2] == 0 and not w[:, 3].any()
    gbar = torch.randn(Kl, B, generator=gen, device=cuda)
    outs, grads, rises = [], [], []
    for fn in (kl_mutual.kl_mutual_pair, ref.mutual_kl_pair):
        a = live.detach().clone().requires_grad_(True)
        b = fixed.detach().clone().requires_grad_(fixed_grad)
        before = (kl_mutual.launches, kl_mutual.bwd_launches)
        by_kernel = _kl_counts()
        out = fn(a, b, w, temperature=T)
        out.backward(gbar)
        rises.append(tuple(n - m for n, m in zip(_kl_counts(), by_kernel)))
        outs.append(out.detach())
        grads.append([a.grad.float()] + ([b.grad.float()] if fixed_grad
                                         else []))
    assert (kl_mutual.launches, kl_mutual.bwd_launches) == before
    # distinct live and fixed: the pair kernels, each way, once a call
    assert rises == [(0, 1, 0, 1), (0, 0, 0, 0)]
    torch.testing.assert_close(outs[0], outs[1], atol=1e-4, rtol=1e-4)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for got, want in zip(*grads):
        assert ((got - want).norm() / want.norm()).item() < tol


def test_kl_pair_blocks_count_one_launch_a_call(cuda):
    """K = 16 runs as four block pairs, counted as one launch each way, and
    ``ops.mutual_kl`` at K = 9 through the blocked pair forward."""
    from repro_torch.kernels import kl_mutual
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(16, 5, 1_000, generator=gen, device=cuda)
    w = (1.0 - torch.eye(16, device=cuda)) / 15
    before = (kl_mutual.launches, kl_mutual.bwd_launches)
    a = x.clone().requires_grad_(True)
    kl_mutual.kl_mutual_pair(a, a.detach(), w).sum().backward()
    assert (kl_mutual.launches, kl_mutual.bwd_launches) == \
        (before[0] + 1, before[1] + 1)
    before = kl_mutual.mutual_kl_launches
    got = ops.mutual_kl(x[:9], temperature=1.3, impl="cuda")
    assert kl_mutual.mutual_kl_launches == before + 1
    torch.testing.assert_close(got, ref.mutual_kl(x[:9], 1.3), atol=1e-4,
                               rtol=1e-4)


def test_mutual_kl_through_the_pair_kernel(cuda):
    """``ops.mutual_kl`` runs the square kernel (the pair forward with
    fixed = live) and counts one call."""
    from repro_torch.kernels import kl_mutual
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(3, 33, 5_000, generator=gen, device=cuda)
    before = (kl_mutual.mutual_kl_launches, kl_mutual.square_launches,
              kl_mutual.pair_launches)
    got = ops.mutual_kl(x, temperature=1.3, impl="cuda")
    assert (kl_mutual.mutual_kl_launches, kl_mutual.square_launches,
            kl_mutual.pair_launches) == (before[0] + 1, before[1] + 1,
                                         before[2])
    torch.testing.assert_close(got, ref.mutual_kl(x, 1.3), atol=1e-4,
                               rtol=1e-4)


def _kl_counts():
    """The pair-KL counters by kernel: square and pair forward, square and
    pair backward."""
    from repro_torch.kernels import kl_mutual
    return (kl_mutual.square_launches, kl_mutual.pair_launches,
            kl_mutual.square_bwd_launches, kl_mutual.pair_bwd_launches)


def _square_check(x, w, T, fixed_grad=False):
    """The square kernel on ``x`` (fixed = ``x.detach()``, or ``x`` itself
    when ``fixed_grad``) against ``ref.mutual_kl_pair`` and its autograd:
    forward atol 1e-4 + rtol 1e-4, gradient relative norm 1e-5 in fp32 and
    2e-2 in bf16 (rounded to bf16 once).  Returns the rises of the
    counters by kernel (``_kl_counts``) over the kernel's call."""
    from repro_torch.kernels import kl_mutual
    gen = torch.Generator(device=x.device).manual_seed(7)
    gbar = torch.randn(x.shape[:2], generator=gen, device=x.device)
    outs, grads, rises = [], [], None
    for fn in (kl_mutual.kl_mutual_pair, ref.mutual_kl_pair):
        a = x.detach().clone().requires_grad_(True)
        before = _kl_counts()
        out = fn(a, a if fixed_grad else a.detach(), w, temperature=T)
        (g,) = torch.autograd.grad(out, a, gbar)
        if rises is None:
            rises = tuple(n - m for n, m in zip(_kl_counts(), before))
        outs.append(out.detach())
        grads.append(g.float())
    torch.testing.assert_close(outs[0], outs[1], atol=1e-4, rtol=1e-4)
    tol = 1e-5 if x.dtype == torch.float32 else 2e-2
    # K = 1, or every weight masked, gives a gradient of exact zeros
    assert (grads[0] - grads[1]).norm() <= tol * grads[1].norm()
    return rises


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weights", ["masked", "uniform"])
@pytest.mark.parametrize("K", [1, 2, 3, 4, 5, 6, 7, 8])
def test_kl_square_kernel_matches_plain(cuda, dtype, weights, K):
    """The square forward (fixed = live.detach(), as the DML round calls
    it) and the backward after it, at each client count one launch takes,
    with the participation mask or w = (1 - I) / (K - 1), at T = 0.5, 1.0
    and 1.7; the uniform case also against ``ref.mutual_kl``."""
    from repro_torch.core.mutual import _pair_mask
    gen = torch.Generator(device=cuda).manual_seed(K)
    x = (2 * torch.randn(K, 6, 1_000, generator=gen, device=cuda)).to(dtype)
    part = None if weights == "uniform" else [1.0] * max(K - 1, 1) + [0.0]
    w = _pair_mask(K, part[:K] if part else None, cuda)
    for T in (0.5, 1.0, 1.7):
        assert _square_check(x, w, T) == (1, 0, 1, 0)
        if weights == "uniform":
            from repro_torch.kernels import kl_mutual
            torch.testing.assert_close(kl_mutual.kl_mutual(x, temperature=T),
                                       ref.mutual_kl(x, T), atol=1e-4,
                                       rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["ragged", "offset_view", "odd_view",
                                    "live_is_fixed", "ragged_rows"])
def test_kl_square_kernel_layouts(cuda, dtype, layout):
    """Rows the vector loads do not tile: V = 4,099 (a partial tile and a
    scalar tail), a view x[..., 1:] whose rows start off the 16-byte grid
    at one phase for every client (a scalar head), a view whose clients'
    phases differ (one-element loads), fixed = live itself, so that the
    backward after the square forward also writes dfixed, and B = 8 rows
    of V = 4,099, whose client planes keep the 16-byte phase while the rows
    do not (the backward's vector loads and stores after a head that
    differs from row to row)."""
    from repro_torch.core.mutual import _pair_mask
    gen = torch.Generator(device=cuda).manual_seed(11)
    K, B, V = 3, 8 if layout == "ragged_rows" else 5, 4_099

    def randn(*shape):
        return (2 * torch.randn(*shape, generator=gen, device=cuda)).to(dtype)
    if layout == "offset_view":
        x = randn(K, 2, V + 1)[..., 1:]       # client stride keeps the phase
        assert x.data_ptr() % 16 and x.stride(0) * x.element_size() % 16 == 0
    elif layout == "odd_view":
        x = randn(K, B, V + 2)[..., 1:V + 1]
    else:
        x = randn(K, B, V)
    w = _pair_mask(K, [1.0, 1.0, 0.0], cuda)
    assert _square_check(x, w, 1.3, layout == "live_is_fixed") == \
        (1, 0, 1, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1, 2, 5, 8])
def test_kl_square_backward_writes_dfixed(cuda, dtype, K):
    """``kl_mutual_pair(x, x, w)`` with x requiring grad: the square
    backward writes both sides' gradients of the one tensor from the same
    registers (q = p), at client counts around one launch's 8."""
    from repro_torch.core.mutual import _pair_mask
    gen = torch.Generator(device=cuda).manual_seed(20 + K)
    x = (2 * torch.randn(K, 4, 3_001, generator=gen, device=cuda)).to(dtype)
    w = _pair_mask(K, None, cuda)
    assert _square_check(x, w, 0.8, fixed_grad=True) == (1, 0, 1, 0)


@pytest.mark.parametrize("K", [9, 16])
def test_kl_square_kernel_in_client_blocks(cuda, K):
    """Past MAX_CLIENTS the diagonal blocks of (x, x.detach()) run the
    square kernel and the others the pair kernel: one call counts one of
    each."""
    from repro_torch.core.mutual import _pair_mask
    gen = torch.Generator(device=cuda).manual_seed(K)
    x = 2 * torch.randn(K, 4, 2_000, generator=gen, device=cuda)
    w = _pair_mask(K, [1.0] * (K - 1) + [0.0], cuda)
    assert _square_check(x, w, 1.2) == (1, 1, 1, 1)


def test_kl_forward_kernel_follows_the_storage(cuda):
    """(x, x.detach()) runs the square kernel; (x, x.clone()) and
    (x, x[[0, 1, 2]]) (equal values in new storage) run the pair kernel,
    with the same values."""
    from repro_torch.kernels import kl_mutual
    gen = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn(3, 7, 3_000, generator=gen, device=cuda)
    w = (1.0 - torch.eye(3, device=cuda)) / 2
    outs = []
    for fixed in (x.detach(), x.clone(), x[[0, 1, 2]]):
        before = (kl_mutual.square_launches, kl_mutual.pair_launches)
        outs.append(kl_mutual.kl_mutual_pair(x, fixed, w))
        square = fixed.data_ptr() == x.data_ptr()
        assert (kl_mutual.square_launches - before[0],
                kl_mutual.pair_launches - before[1]) == \
            (int(square), int(not square))
    for got in outs[1:]:
        torch.testing.assert_close(got, outs[0], atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the SSD chunked scan

def _ssd_inputs(device, dtype, B=2, S=300, H=8, P=64, G=2, N=128, seed=0):
    """x, B, C in ``dtype``; dt, A fp32 at mamba2's scale (A = -(1..H))."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(B, S, H, P, generator=gen, device=device).to(dtype)
    dt = 0.1 * torch.rand(B, S, H, generator=gen, device=device) + 1e-3
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=device)
    Bm = torch.randn(B, S, G, N, generator=gen, device=device).to(dtype)
    Cm = torch.randn(B, S, G, N, generator=gen, device=device).to(dtype)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,P,G,N,chunk", [(300, 8, 64, 2, 128, 256),
                                             (100, 4, 32, 4, 16, 64),
                                             (1, 2, 16, 1, 8, 64),
                                             # two head runs a group
                                             (300, 20, 64, 2, 128, 256),
                                             (200, 12, 24, 1, 40, 128)])
def test_ssd_kernels_match_plain(cuda, dtype, S, H, P, G, N, chunk):
    """y and final state against ``ref.ssd`` (fp32: atol/rtol 1e-4, the
    summation order; bf16: y within 2e-2 relative norm, one rounding of y),
    and the five gradients under cotangents on both outputs against
    autograd of ``ref.ssd`` (relative norm 1e-4 in fp32, 2e-2 in bf16; the
    norm floored at 1, since dA is 0 up to rounding at S = 1)."""
    from repro_torch.kernels import ssd_scan
    ins = _ssd_inputs(cuda, dtype, S=S, H=H, P=P, G=G, N=N)
    gen = torch.Generator(device=cuda).manual_seed(1)
    dy = torch.randn(ins[0].shape, generator=gen, device=cuda).to(dtype)
    ds = torch.randn(ins[0].shape[0], H, P, N, generator=gen, device=cuda)
    outs, grads = [], []
    before = ssd_scan.launches, ssd_scan.bwd_launches
    for fn in (ssd_scan.ssd_scan, ref.ssd):
        leaves = [t.clone().requires_grad_(True) for t in ins]
        y, st = fn(*leaves, chunk=chunk)
        grads.append(torch.autograd.grad(
            (y.float() * dy.float()).sum() + (st * ds).sum(), leaves))
        outs.append((y.float(), st))
    # one launch each way for the kernel, none for the plain version
    assert (ssd_scan.launches, ssd_scan.bwd_launches) == \
        (before[0] + 1, before[1] + 1)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    (y, st), (wy, wst) = outs
    assert ((y - wy).norm() / wy.norm()).item() < tol
    torch.testing.assert_close(st, wst, atol=1e-3 if tol > 1e-4 else 1e-4,
                               rtol=tol)
    for got, want in zip(*grads):
        assert ((got.float() - want.float()).norm()
                / want.float().norm().clamp_min(1.0)).item() < tol


def test_ssd_entry_states(cuda):
    """The forward's chunk-entry states (B, H, nc, P, N) fp32: chunk c's is
    the plain scan's final state over the first c chunks."""
    from repro_torch.kernels import ssd_scan
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, torch.float32, S=200, H=4, P=32,
                                   G=1, N=16)
    y, final, states = ssd_scan._forward(x, dt, A, Bm, Cm, 64)
    assert states.shape == (2, 4, 4, 32, 16) and states.dtype == torch.float32
    assert not states[:, :, 0].any()
    for c in range(1, 4):
        _, want = ref.ssd(x[:, :64 * c], dt[:, :64 * c], A, Bm[:, :64 * c],
                          Cm[:, :64 * c], chunk=64)
        torch.testing.assert_close(states[:, :, c], want, atol=1e-4,
                                   rtol=1e-4)


def test_ops_ssd_cuda_impl_reaches_the_kernel(cuda):
    from repro_torch.kernels import ssd_scan
    ins = _ssd_inputs(cuda, torch.bfloat16, S=130, H=4, P=32, G=1, N=16)
    f = ssd_scan.launches
    y, st = ops.ssd(*ins, chunk=64, impl="cuda")
    assert ssd_scan.launches == f + 1
    wy, wst = ref.ssd(*ins, chunk=64)
    assert ((y.float() - wy.float()).norm() / wy.float().norm()) < 2e-2
    with pytest.raises(ValueError, match="zero state"):
        ops.ssd(*ins, chunk=64, initial_state=st, impl="cuda")
    assert ssd_scan.launches == f + 1       # refused before any launch


@pytest.mark.parametrize("bad", ["dtype", "dt_dtype", "contiguous",
                                 "groups", "state_dim"])
def test_ssd_kernel_refuses_before_launch(cuda, bad):
    from repro_torch.kernels import ssd_scan
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, torch.float32, S=64, H=4, P=32,
                                   G=2, N=16)
    if bad == "dtype":
        Bm = Bm.to(torch.bfloat16)
    elif bad == "dt_dtype":
        dt = dt.to(torch.bfloat16)
    elif bad == "contiguous":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "groups":
        Bm, Cm = (torch.cat([t, t[:, :, :1]], dim=2) for t in (Bm, Cm))
    else:
        Bm, Cm = (t.repeat(1, 1, 1, 9) for t in (Bm, Cm))     # N = 144
    f = ssd_scan.launches
    with pytest.raises(ValueError):
        ssd_scan.ssd_scan(x, dt, A, Bm, Cm, chunk=64)
    assert ssd_scan.launches == f


# ---------------------------------------------------------------------------
# the sparse (top-k) KL

def _sparse_inputs(device, dtype, Kl, J, B, V, k, T, overlap, seed=0):
    """Live logits in ``dtype``; each sender's top-k (idx int32, logp fp32)
    of its own logits, with ``overlap`` making the senders share half their
    entries and repeat one, as SparseDML's overlapping sets do."""
    from repro_torch.core.mutual import topk_predictions
    gen = torch.Generator(device=device).manual_seed(seed)
    live = (3 * torch.randn(Kl, B, V, generator=gen, device=device)) \
        .to(dtype)
    idx, lp = topk_predictions(
        3 * torch.randn(J, B, V, generator=gen, device=device), k, T)
    if overlap:
        idx[..., 1] = idx[..., 0]
        idx[1:, :, :k // 2] = idx[0, :, :k // 2]
    w = torch.rand(Kl, J, generator=gen, device=device)
    gbar = torch.randn(Kl, B, generator=gen, device=device)
    return live, idx, lp, w, gbar


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Kl,J,B,V,k,T,overlap", [
    (3, 3, 64, 151_936, 64, 1.0, True),  # the SparseDML path's width
    (1, 2, 7, 5_003, 16, 2.0, True),     # Kl = 1 (the per-client form)
    (2, 3, 5, 300, 300, 0.5, False),     # k = V: no uniform tail
    (4, 2, 9, 1_000, 33, 1.3, True),
    (3, 3, 6, 8_192, 2_048, 1.0, True),  # J * k past the table: blocks
    (2, 1, 5, 8_192, 5_000, 1.0, True)])  # one sender's k past it
def test_sparse_kl_kernels_match_plain(cuda, dtype, Kl, J, B, V, k, T,
                                       overlap):
    """The sparse-KL forward (atol 1e-4 + rtol 1e-4: an fp32 streaming sum
    against a two-pass softmax) and backward (relative norm 1e-5 in fp32,
    2e-2 in bf16, where dlive is rounded once) against
    ``ref.sparse_kl_pair`` and its autograd on the same idx and logp."""
    from repro_torch.kernels import sparse_kl
    live, idx, lp, w, gbar = _sparse_inputs(cuda, dtype, Kl, J, B, V, k, T,
                                            overlap)
    outs, grads = [], []
    before = (sparse_kl.launches, sparse_kl.bwd_launches)
    for fn in (sparse_kl.sparse_kl_topk, ref.sparse_kl_pair):
        a = live.detach().clone().requires_grad_(True)
        out = fn(a, idx, lp, w, temperature=T)
        out.backward(gbar)
        outs.append(out.detach())
        grads.append(a.grad.float())
    assert (sparse_kl.launches, sparse_kl.bwd_launches) == \
        (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(outs[0], outs[1], atol=1e-4, rtol=1e-4)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    got, want = grads
    assert ((got - want).norm() / want.norm()).item() < tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_kl_forward_on_views(cuda, dtype):
    """The sparse forward on rows that start off the 16-byte grid (an
    offset view, each row at its own phase) with V % 8 != 0: out and the
    statistics Z and -H against the plain version, and the backward fed
    them against autograd of ``ref.sparse_kl_pair``."""
    from repro_torch.kernels import sparse_kl
    Kl, J, B, V, k, T = 3, 3, 6, 5_003, 64, 1.3
    live, idx, lp, w, gbar = _sparse_inputs(cuda, dtype, Kl, J, B, V + 6, k,
                                            T, True)
    live = live[..., 3:V + 3]
    idx = idx.clamp(max=V - 1)
    assert live.data_ptr() % 16 and live.stride(1) * live.element_size() % 16
    out, stats = sparse_kl._forward(live, idx, lp, w, T)
    lpl = torch.log_softmax(live.float() / T, -1)
    torch.testing.assert_close(out, ref.sparse_kl_pair(live, idx, lp, w, T),
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(stats[0], torch.logsumexp(live.float() / T,
                                                         -1),
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(stats[1], (lpl.exp() * lpl).sum(-1),
                               atol=1e-4, rtol=1e-4)
    grads = []
    for fn in (sparse_kl.sparse_kl_topk, ref.sparse_kl_pair):
        a = live.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(a, idx, lp, w, temperature=T), a, gbar)
        grads.append(g.float())
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    got, want = grads
    assert ((got - want).norm() / want.norm()).item() < tol


def test_sparse_kl_tied_row_and_ops_dispatch(cuda):
    """A row whose logits all tie (every index tied with the received
    ones), through ``ops.sparse_mutual_kl(impl="cuda")``."""
    from repro_torch.kernels import sparse_kl
    live, idx, lp, w, _ = _sparse_inputs(cuda, torch.float32, 2, 2, 4, 2_000,
                                         8, 1.0, False)
    live[:, 0] = 0.25
    before = sparse_kl.launches
    got = ops.sparse_mutual_kl(live, idx, lp, w, impl="cuda")
    assert sparse_kl.launches == before + 1
    torch.testing.assert_close(got, ref.sparse_kl_pair(live, idx, lp, w),
                               atol=1e-4, rtol=1e-4)


def test_sparse_kl_past_one_launch(cuda):
    """J * k = 4800 (k = 2400 repeated entries), which one launch's table
    cannot hold, runs as sender blocks against ``ref.sparse_kl_pair``."""
    from repro_torch.kernels import sparse_kl
    live, idx, lp, w, gbar = _sparse_inputs(cuda, torch.float32, 2, 2, 3,
                                            9_000, 8, 1.0, False)
    idx, lp = idx.repeat(1, 1, 300), lp.repeat(1, 1, 300)
    outs, grads = [], []
    before = (sparse_kl.launches, sparse_kl.bwd_launches)
    for fn in (sparse_kl.sparse_kl_topk, ref.sparse_kl_pair):
        a = live.detach().clone().requires_grad_(True)
        out = fn(a, idx, lp, w)
        out.backward(gbar)
        outs.append(out.detach())
        grads.append(a.grad)
    assert (sparse_kl.launches, sparse_kl.bwd_launches) == \
        (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(outs[0], outs[1], atol=1e-4, rtol=1e-4)
    got, want = grads
    assert ((got - want).norm() / want.norm()).item() < 1e-5


@pytest.mark.parametrize("bad", ["idx_dtype", "k_over_V", "shape",
                                 "device"])
def test_sparse_kl_kernel_refuses_before_launch(cuda, bad):
    from repro_torch.kernels import sparse_kl
    live, idx, lp, w, _ = _sparse_inputs(cuda, torch.float32, 2, 2, 3, 9_000,
                                         8, 1.0, False)
    if bad == "idx_dtype":
        idx = idx.long()
    elif bad == "k_over_V":                     # what ref cannot take
        idx, lp = idx.repeat(1, 1, 1126), lp.repeat(1, 1, 1126)
    elif bad == "shape":
        w = w[:, :1]
    else:
        lp = lp.cpu()
    before = sparse_kl.launches
    with pytest.raises(ValueError):
        sparse_kl.sparse_kl_topk(live, idx, lp, w)
    assert sparse_kl.launches == before
