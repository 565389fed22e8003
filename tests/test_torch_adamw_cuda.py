"""The fused AdamW kernels on the card, against the plain version run on
the same CUDA tensors.

Every test here needs a CUDA device and skips without one: a CUDA kernel
has no CPU mode (CPU leaves take the plain version, which
``test_torch_adamw.py`` and ``test_torch_train.py`` hold to the eager
arithmetic and to the JAX package).  The module imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_adamw_cuda.py
"""
import pytest
import torch

from repro_torch import optim, trace
from repro_torch.kernels import adamw as fused
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_map

K = 3
BIG = (1 << 26) + 3          # elements a client of the long leaf
TRANSPOSED = ("tied", "tied_odd")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused AdamW has no CPU mode")
    return torch.device("cuda")


def _tree(dev, gen):
    """A client-stacked tree: every pair of bf16 and fp32 params and
    gradients, decayed and undecayed names, a leaf past ``optim.CHUNK``
    and ragged in ``fused.CHUNK``, a leaf whose 7 elements a client lie
    off the 8-element steps, one whose storage starts 2 bytes off a
    16-byte boundary, and two whose gradients come back transposed, as a
    tied head's does (``TRANSPOSED``: one in whole 8-element steps and
    ragged tiles, one in neither).  Returns (params, the gradients'
    dtypes)."""
    def leaf(*shape, dtype=torch.bfloat16):
        return (torch.randn((K,) + shape, generator=gen, device=dev)
                * 0.05).to(dtype)
    shifted = torch.empty(1 + K * 40 * 9, dtype=torch.bfloat16,
                          device=dev)[1:].view(K, 40, 9)
    shifted.copy_(leaf(40, 9))
    params = {"embed": leaf(BIG), "final_norm": leaf(256),
              "w_qkv": leaf(64, 48), "w32": leaf(33, 17, dtype=torch.float32),
              "A_log": leaf(7, dtype=torch.float32), "conv_b": leaf(7),
              "w_mixed": leaf(96, 40), "b32": leaf(40, dtype=torch.float32),
              "shifted": shifted, "tied": leaf(1000, 72),
              "tied_odd": leaf(37, 21, dtype=torch.float32)}
    gdtypes = {k: v.dtype for k, v in params.items()}
    gdtypes["w_mixed"] = torch.float32       # bf16 params, fp32 gradients
    gdtypes["b32"] = torch.bfloat16          # fp32 params, bf16 gradients
    return params, gdtypes


def _grads(params, gdtypes, gen, size):
    def grad(k, v):
        shape = v.shape[:-2] + v.shape[:-3:-1] if k in TRANSPOSED \
            else v.shape
        g = (torch.randn(shape, generator=gen, device=v.device)
             * size).to(gdtypes[k])
        return g.transpose(-1, -2) if k in TRANSPOSED else g
    return {k: grad(k, v) for k, v in params.items()}


def _plain(params, grads, state, cfg, client_scale):
    """The plain version on the same CUDA tensors: the eager norm, then
    ``optim._plain_update`` leaf by leaf."""
    gnorm, scale = None, client_scale
    if client_scale is None:
        gnorm = optim._plain_norm(tree_leaves(grads))
        if cfg.clip_norm is not None:
            scale = optim._clip_scale(gnorm, cfg.clip_norm)
    state["step"] += 1
    step = state["step"]
    lr = cfg.make_schedule()(step)
    bc1, bc2 = 1 - cfg.b1 ** step, 1 - cfg.b2 ** step
    for *leaf, decay in optim._update_leaves(params, grads, state, cfg):
        optim._plain_update(leaf, scale, lr, bc1, bc2, cfg, decay)
    return gnorm


def bf16_steps(got, want, old):
    """|got - want| in bf16 steps at the operands' scale of p - lr u: the
    step of bf16 numbers as large as the largest of |old|, |want| and
    |got| (where the two terms cancel, the result's own step is finer
    than the rounding of either term; across a power of two, the larger
    side's step)."""
    scale = torch.maximum(torch.maximum(old.float().abs(),
                                        want.float().abs()),
                          got.float().abs())
    step = torch.ldexp(torch.ones_like(scale), torch.frexp(scale)[1] - 8)
    return (got.float() - want.float()).abs() / step


@pytest.mark.parametrize("mode", ["clip", "noclip", "client"])
def test_fused_update_matches_plain(cuda, mode):
    """Three steps of ``adamw_update`` through the kernels against the
    plain version, each from a copy of the kernels' state: moments and
    fp32 params
    within 1e-6 relative (atol 1e-6 of the leaf's largest value, where a
    moment's two terms cancel), bf16 params equal or one bf16 step apart
    (``bf16_steps``) on at most 1e-4 of their elements (the norm's
    summation order moves the clip scale by an fp32 rounding),
    ``grad_norm`` within 1e-6; each
    step counts ``adamw_fused`` once and launches the kernels.  Clipped
    (scale < 1), unclipped, and with a (K,) client scale."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    params, gdtypes = _tree(cuda, gen)
    want_p = tree_map(torch.clone, params)
    got_o, want_o = adamw_init(params), adamw_init(want_p)
    want_o["step"] = 0
    cfg = AdamWConfig(lr=1e-2, warmup=2, total_steps=10,
                      clip_norm=None if mode == "noclip" else 1.0)
    scale = (torch.tensor([0.5, 1.0, 0.25], device=cuda)
             if mode == "client" else None)
    for step in range(3):
        for a, b in zip(tree_leaves((want_p, want_o["mu"], want_o["nu"])),
                        tree_leaves((params, got_o["mu"], got_o["nu"]))):
            a.copy_(b)                 # each step from the same state
        old = tree_map(torch.clone, want_p)
        grads = _grads(params, gdtypes, gen, 1e-5 if step == 1 else 1.0)
        fused_count = trace.counts.get("adamw_fused", 0)
        launches = fused.launches
        _, _, om = adamw_update(params, grads, got_o, cfg, client_scale=scale)
        gnorm = _plain(want_p, grads, want_o, cfg, scale)
        torch.cuda.synchronize()
        assert trace.counts["adamw_fused"] == fused_count + 1
        assert fused.launches == launches + (1 if mode == "client" else 3)
        if mode == "client":
            assert om["grad_norm"] is None
        else:
            torch.testing.assert_close(om["grad_norm"], gnorm, rtol=1e-6,
                                       atol=0)
            if mode == "clip":
                assert (gnorm > 1.0) == (step != 1)   # step 1 unclipped
        flips = total = 0
        for k in params:
            for got, want in ((got_o["mu"][k], want_o["mu"][k]),
                              (got_o["nu"][k], want_o["nu"][k])):
                torch.testing.assert_close(
                    got, want, rtol=1e-6,
                    atol=1e-6 * want.abs().max().item())
            got, want = params[k], want_p[k]
            if got.dtype == torch.float32:
                torch.testing.assert_close(
                    got, want, rtol=1e-6,
                    atol=1e-6 * want.abs().max().item())
            else:
                assert bf16_steps(got, want, old[k]).max().item() <= 1, k
                flips += int((got != want).sum())
                total += got.numel()
        assert flips <= 1e-4 * total, (flips, total)
    assert int(got_o["step"]) == 3


def test_fused_norm_repeats_bit_for_bit(cuda):
    """The norm pass uses no floating-point atomics: two passes over the
    same gradients give the same bits; the clip scale is
    min(1, clip / norm)."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    params, gdtypes = _tree(cuda, gen)
    grads = list(_grads(params, gdtypes, gen, 1.0).values())
    a, b = fused.sumsq(grads, clip=1.0), fused.sumsq(grads, clip=1.0)
    assert torch.equal(a, b)
    want = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads))
    torch.testing.assert_close(a[1].double(), want, rtol=1e-6, atol=0)
    torch.testing.assert_close(a[2], torch.clamp(1.0 / a[1], max=1.0),
                               rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["param", "grad", "scale_device"])
def test_fused_update_refuses_before_launch(cuda, bad):
    """A non-contiguous CUDA param, a gradient neither contiguous nor
    transposed, or a scale on another device raises before any kernel is
    launched."""
    p = torch.zeros(K, 8, 16, dtype=torch.bfloat16, device=cuda)
    g = torch.ones_like(p)
    if bad == "param":
        p = torch.zeros(K, 16, 8, dtype=torch.bfloat16,
                        device=cuda).transpose(1, 2)
    elif bad == "grad":                 # neither dense nor transposed
        g = torch.ones(K, 8, 32, dtype=torch.bfloat16, device=cuda)[..., ::2]
    params, grads = {"w": p}, {"w": g}
    opt = adamw_init({"w": torch.zeros_like(p)})
    scale = torch.ones(K) if bad == "scale_device" else None
    launches = fused.launches
    with pytest.raises(ValueError):
        adamw_update(params, grads, opt, AdamWConfig(), client_scale=scale)
    assert fused.launches == launches
