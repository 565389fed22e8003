"""The yardstick's work formulas against ``torch.utils.flop_counter`` on
the benchmark's plain reference at a reduced size.

The plain versions compute every (query, key) pair and every chunk pair
of the SSD's quadratic form, where the formulas count the causal half
that the work needs; each test adds that half back before it compares.
"""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import reference as R
from portbench import weights as W
from portbench.yard import work

from portbench_tiny import model

FP32 = R.Precision("fp32")


def counted(fn, *args):
    """(forward flops, backward flops) of fn(*args) and its gradient."""
    leaves = [a for a in args if isinstance(a, torch.Tensor)
              and a.requires_grad]
    with FlopCounterMode(display=False) as fwd:
        out = fn(*args)
    with FlopCounterMode(display=False) as bwd:
        torch.autograd.grad(out.float().square().sum(), leaves)
    return fwd.get_total_flops(), bwd.get_total_flops()


@pytest.mark.parametrize("B,S,H,Hkv,hd", [(2, 16, 4, 2, 8), (1, 33, 8, 8, 16)])
def test_attention(B, S, H, Hkv, hd):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, S, h, hd, generator=g, requires_grad=True)
               for h in (H, Hkv, Hkv))
    f, b = counted(R.causal_attention, q, k, v, FP32)
    pairs = work.causal_pairs(S)
    full = S * S / pairs                  # the plain version's extra half
    assert work.attention_fwd(B, S, H, Hkv, hd)[0] * full == pytest.approx(f)
    # the backward formula also recomputes the scores (2 hd a pair)
    bwd = work.attention_bwd(B, S, H, Hkv, hd)[0] - 2 * hd * B * H * pairs
    assert bwd * full == pytest.approx(b)


@pytest.mark.parametrize("S,chunk", [(32, 16), (40, 16)])
def test_ssd(S, chunk):
    B, H, P, N = 2, 3, 4, 5
    g = torch.Generator().manual_seed(1)
    x = torch.randn(B, S, H, P, generator=g, requires_grad=True)
    dt = torch.rand(B, S, H, generator=g) * 0.1
    A = -torch.rand(H, generator=g) - 0.5
    Bm = torch.randn(B, S, H, N, generator=g, requires_grad=True)
    Cm = torch.randn(B, S, H, N, generator=g, requires_grad=True)
    f, b = counted(R.ssd_scan, x, dt, A, Bm, Cm, chunk, FP32)
    # the plain version pads the last chunk and computes every pair of
    # every chunk: the formula's pairs, and the pad, added back
    nc = -(-S // chunk)
    extra_pairs = nc * chunk * chunk - sum(
        min(chunk, S - c) * (min(chunk, S - c) + 1) / 2
        for c in range(0, S, chunk))
    extra_len = nc * chunk - S
    G = H          # the plain version repeats B and C for each head
    fwd = work.ssd_ops(B, S, H, P, G, N, chunk, False) \
        + B * extra_pairs * (2 * N * G + 2 * P * H) \
        + B * extra_len * 4 * N * P * H
    assert fwd == pytest.approx(f)
    # the backward formula recomputes the scores (2 pairs N G); autograd
    # of the plain version keeps them
    bwd = work.ssd_ops(B, S, H, P, G, N, chunk, True) \
        - B * sum(min(chunk, S - c) * (min(chunk, S - c) + 1)
                  for c in range(0, S, chunk)) * N * G \
        + B * extra_pairs * (4 * N * G + 4 * P * H) \
        + B * extra_len * 8 * N * P * H
    assert bwd == pytest.approx(b)


@pytest.mark.parametrize("Kl,Kg,square", [(3, 3, True), (2, 8, False)])
def test_kl_cross_terms(Kl, Kg, square):
    """Eq. 2's cross terms written as the contraction over the vocabulary
    that the reference sums: 2 flops per (i, j, b, v).  The rest of the
    formula (four operations per element on each side) is elementwise,
    which the counter does not see."""
    B, V = 6, 50
    live = torch.randn(Kl, B, V)
    fixed = live if square else torch.randn(Kg, B, V)
    with FlopCounterMode(display=False) as fc:
        torch.einsum("ibv,jbv->ijb", torch.softmax(live, -1),
                     torch.log_softmax(fixed, -1))
    cross = work.kl_fwd_ops(Kl, Kg, B, V, square) - (
        4 * Kl * B * V if square else 4 * (Kl + Kg) * B * V)
    terms = Kl * (Kl - 1) if square else Kl * Kg
    assert cross == 2 * terms * B * V
    assert fc.get_total_flops() == 2 * Kl * Kg * B * V


def test_kl_bytes_are_the_planes():
    Kl, B, V = 3, 1024, 151936
    plane = B * V * 2
    b_sq = work.kl_bound_s(Kl, Kl, B, V, square=True)
    from portbench.yard import peaks
    want = (Kl * plane + Kl * B * 4 + 2 * Kl * plane + Kl * B * 4) \
        / peaks.HBM_BYTES
    assert b_sq == pytest.approx(want)        # bytes bound both calls


@pytest.mark.parametrize("mixer", ["attn", "mamba"])
def test_model_flops(mixer):
    cfg = model(mixer)
    if mixer == "mamba":
        cfg["ssm"]["n_groups"] = cfg["ssm"]["expand"] * cfg["d_model"] \
            // cfg["ssm"]["head_dim"]        # one group a head, see test_ssd
        cfg["ssm"]["d_state"] = 8
    n_seqs, S = 3, 32
    w = W.make_weights(cfg, 1, 0, "cpu")
    fleet = R.RefFleet(w, cfg, {"clients": 1, "lr": 1e-3, "warmup": 5,
                                "rounds": 100}, ["cpu"])
    params = fleet.params[0]
    leaves = [t for _, _, _, t in R._param_paths(params, cfg)]
    for t in leaves:
        t.requires_grad_(True)
    toks = torch.randint(0, cfg["vocab_size"], (n_seqs, S))
    with FlopCounterMode(display=False) as fc:
        lg = R.logits(params, cfg, toks, FP32, remat=False)
        torch.autograd.grad(lg.square().sum(), leaves)
    want = work.model_flops(cfg, n_seqs, S)
    L = cfg["n_layers"]
    if mixer == "attn":
        # the plain attention computes the masked half too
        pairs = work.causal_pairs(S)
        want += L * 12 * cfg["head_dim"] * cfg["n_heads"] \
            * (S * S - pairs) * n_seqs
    else:
        s = cfg["ssm"]
        nh = s["expand"] * cfg["d_model"] // s["head_dim"]
        chunk, G, N, P = s["chunk"], s["n_groups"], s["d_state"], \
            s["head_dim"]
        nc = S // chunk
        pairs = nc * chunk * (chunk + 1) / 2
        extra = nc * chunk * chunk - pairs
        # MFU counts 3 x the forward scan; the counter sees autograd's
        # backward (twice the forward's products) and the masked half
        want += L * n_seqs * 3 * extra * (2 * N * G + 2 * P * nh)
    assert fc.get_total_flops() == pytest.approx(want)
