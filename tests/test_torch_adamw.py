"""The fused AdamW's host side on the CPU: the leaf tables it hands the
kernels, and the dispatch that keeps CPU leaves on the plain version.
The kernels themselves run in ``test_torch_adamw_cuda.py`` on the card."""
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import optim, trace
from repro_torch.kernels import adamw as fused
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_map

SRC = Path(__file__).resolve().parents[1] / "src"
K = 3


def _tree(stacked: bool = True, gen=None):
    """Leaves under every ``_wd_mask`` rule, bf16 and fp32, with odd
    sizes; client-stacked (K, ...) or one model's."""
    gen = gen or torch.Generator().manual_seed(0)
    lead = (K,) if stacked else ()

    def leaf(*shape, dtype=torch.bfloat16):
        return torch.randn(lead + shape, generator=gen).to(dtype)
    return {"embed": leaf(40, 16), "final_norm": leaf(16),
            "periods": {"slot0": {
                "mixer": {"w_qkv": leaf(2, 16, 24), "A_log":
                          leaf(2, 3, dtype=torch.float32),
                          "D": leaf(2, 3, dtype=torch.float32),
                          "dt_bias": leaf(2, 3, dtype=torch.float32),
                          "conv_b": leaf(2, 7), "b": leaf(5)},
                "norm1": leaf(2, 16), "ffn": {"w_up": leaf(2, 16, 33)}}}}


def _grads(params, gen):
    return tree_map(lambda t: torch.randn(t.shape, generator=gen)
                    .to(t.dtype), params)


def test_tables_stay_under_the_argument_limit():
    """150 leaves (empty ones, ragged ones, one of several chunks) go in
    tables of at most MAX_LEAVES, whose arguments fit the kernel's
    limit; each leaf's chunks are numbered on from the table's previous
    leaf; empty leaves are left out."""
    assert ctypes.sizeof(fused.Table) + ctypes.sizeof(fused.Hyper) \
        <= fused.ARG_LIMIT
    sizes = [0 if i % 17 == 0 else 1 + (i * 997) % 5000 for i in range(149)]
    sizes.append(2 * fused.CHUNK + 3)
    gs = [torch.zeros(n) for n in sizes]
    tabs = fused.plan_sumsq(gs)
    kept = [n for n in sizes if n]
    assert len(tabs) == -(-len(kept) // fused.MAX_LEAVES)
    got = []
    for t in tabs:
        assert 1 <= t.n_leaves <= fused.MAX_LEAVES
        chunk = 0
        for leaf in t.leaf[:t.n_leaves]:
            assert leaf.chunk0 == chunk
            chunk += -(-leaf.n // fused.CHUNK)
            got.append(leaf.n)
        assert t.n_chunks == chunk
    assert got == kept
    assert tabs[-1].leaf[tabs[-1].n_leaves - 1].n == 2 * fused.CHUNK + 3


@pytest.mark.parametrize("scale", ["none", "one", "client"])
@pytest.mark.parametrize("stacked", [True, False])
def test_plan_flags_follow_the_wd_mask_and_clients(scale, stacked):
    """Each leaf's flags: decay as ``_wd_mask`` (and only with a weight
    decay), its params' and gradients' dtypes; with a (K,) scale, a
    client-stacked leaf's elements per client; a leaf without the client
    axis refuses a (K,) scale."""
    gen = torch.Generator().manual_seed(1)
    params = _tree(stacked, gen)
    state = adamw_init(params)
    grads = _grads(params, gen)
    s = {"none": None, "one": torch.tensor(0.5),
         "client": torch.rand(K, generator=gen)}[scale]
    for wd in (0.1, 0.0):
        cfg = AdamWConfig(weight_decay=wd)
        leaves = list(optim._update_leaves(params, grads, state, cfg))
        if scale == "client" and not stacked:
            with pytest.raises(ValueError, match="client scale"):
                fused.plan_update(leaves, s)
            return
        (tab,), mode = fused.plan_update(leaves, s)
        assert mode == {"none": fused.SCALE_NONE, "one": fused.SCALE_ONE,
                        "client": fused.SCALE_CLIENT}[scale]
        paths = [p for p, _ in optim._leaves_with_path(params)]
        assert tab.n_leaves == len(paths)
        for leaf, path, (p, g, *_) in zip(tab.leaf, paths, leaves):
            assert bool(leaf.flags & fused.DECAY) == bool(
                wd and optim._wd_mask(path)), path
            assert bool(leaf.flags & fused.P_BF16) == (
                p.dtype == torch.bfloat16)
            assert bool(leaf.flags & fused.G_BF16) == (
                g.dtype == torch.bfloat16)
            assert leaf.n == p.numel()
            assert leaf.per_client == (p.numel() // K if scale == "client"
                                       else 0)
            if leaf.per_client % fused.VEC:
                assert not leaf.flags & fused.VEC_ALL
        decayed = {"/".join(map(str, p)) for leaf, p in zip(tab.leaf, paths)
                   if leaf.flags & fused.DECAY}
        assert decayed == ({"embed", "periods/slot0/mixer/w_qkv",
                            "periods/slot0/ffn/w_up"} if wd else set())


@pytest.mark.parametrize("rows,cols,vec", [(1000, 72, True),
                                            (37, 21, False)])
def test_transposed_gradients_go_by_tiles(rows, cols, vec):
    """A gradient stored as the transpose of a dense (cols, rows) matrix a
    client, as a tied head's comes back, is a TRANS leaf of TILE x TILE
    tiles of (rows, cols) in the update (8 elements a step where rows and
    cols are multiples of 8) and a dense run in the norm pass; the
    params and moments stay contiguous."""
    p = torch.zeros(K, rows, cols, dtype=torch.bfloat16)
    g = torch.zeros(K, cols, rows, dtype=torch.bfloat16).transpose(1, 2)
    m = torch.zeros(K, rows, cols)
    assert fused.transposed(g) == (rows, cols)
    assert fused.transposed(p) is None
    (tab,), _ = fused.plan_update([(p, g, m, m.clone(), True)],
                                  torch.ones(K))
    leaf = tab.leaf[0]
    assert leaf.flags & fused.TRANS
    assert (leaf.rows, leaf.cols, leaf.per_client) == (rows, cols,
                                                       rows * cols)
    assert tab.n_chunks == K * -(-rows // fused.TILE) * -(-cols // fused.TILE)
    assert bool(leaf.flags & fused.VEC_ALL) == vec
    (norm,) = fused.plan_sumsq([g])
    assert not norm.leaf[0].flags & fused.TRANS
    assert norm.n_chunks == -(-g.numel() // fused.CHUNK)


def test_plan_refuses_what_the_kernel_does_not_take():
    p = torch.zeros(K, 8, dtype=torch.bfloat16)
    m = torch.zeros(K, 8)
    ok = (p, p.clone(), m, m.clone(), True)
    cases = [((p.t().contiguous().t(), p, m, m, True), None),   # strided
             ((p.half(), p, m, m, True), None),                 # fp16
             ((p, p, m.bfloat16(), m, True), None),             # moments
             ((p, p[:2], m, m, True), None),                    # shapes
             (ok, torch.ones(K, dtype=torch.float64)),          # scale dtype
             (ok, torch.ones(K, 2))]                            # scale rank
    strided = torch.zeros(K, 16, dtype=torch.bfloat16)[:, ::2]
    cases.append(((p, strided, m, m, True), None))              # gradient
    for leaf, s in cases:
        with pytest.raises(ValueError):
            fused.plan_update([leaf], s)
    with pytest.raises(ValueError, match="neither contiguous nor"):
        fused.plan_sumsq([strided])
    before = fused.launches
    with pytest.raises(ValueError, match="CUDA"):
        fused.update([ok], None, lr=1e-3, b1=0.9, b2=0.95, eps=1e-8,
                     weight_decay=0.1, bc1=0.1, bc2=0.05)
    with pytest.raises(ValueError, match="CUDA"):
        fused.sumsq([p])
    assert fused.launches == before


def _eager(params, grads, state, cfg, client_scale, step):
    """The eager update as the port ran it before the fused kernels, on
    whole leaves (each well under ``optim.CHUNK``): the plain version's
    arithmetic, pass by pass."""
    leaves = list(optim._leaves_with_path(params))
    gnorm, scale = None, client_scale
    if client_scale is None:
        gnorm = torch.sqrt(torch.sum(torch.stack(
            [torch.sum(torch.square(optim._at(grads, path).float()))
             for path, _ in leaves])))
        if cfg.clip_norm is not None:
            scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
    lr = cfg.make_schedule()(step)
    bc1, bc2 = 1 - cfg.b1 ** step, 1 - cfg.b2 ** step
    for path, p in leaves:
        g = optim._at(grads, path).float()
        mu, nu = optim._at(state["mu"], path), optim._at(state["nu"], path)
        if scale is not None:
            g = g * (scale if scale.dim() == 0 else scale.reshape(
                (-1,) + (1,) * (g.dim() - 1)))
        mu.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        nu.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        u = torch.div(mu, bc1).div_(torch.sqrt(nu / bc2).add_(cfg.eps))
        if cfg.weight_decay and optim._wd_mask(path):
            u.add_(p.float(), alpha=cfg.weight_decay)
        p.copy_(u.mul_(-lr).add_(p.float()))
    return gnorm


@pytest.mark.parametrize("mode", ["clip", "noclip", "client"])
def test_cpu_leaves_take_the_plain_path(mode):
    """CPU leaves never reach the kernels (no launch, no ``adamw_fused``
    count) and update bit for bit as the eager code always did, over
    three steps: clipped by the global norm, unclipped, and with a (K,)
    client scale."""
    gen = torch.Generator().manual_seed(2)
    params = _tree(True, gen)
    want_p = tree_map(torch.clone, params)
    got_o, want_o = adamw_init(params), adamw_init(want_p)
    cfg = AdamWConfig(lr=1e-2, warmup=2, total_steps=10,
                      clip_norm=None if mode == "noclip" else 0.5)
    scale = torch.rand(K, generator=gen) if mode == "client" else None
    fused_count = trace.counts.get("adamw_fused", 0)
    launches = fused.launches
    for step in (1, 2, 3):
        grads = _grads(params, gen)
        _, _, om = adamw_update(params, grads, got_o, cfg,
                                client_scale=scale)
        gnorm = _eager(want_p, grads, want_o, cfg, scale, step)
        if mode == "client":
            assert om["grad_norm"] is None
        else:
            assert torch.equal(om["grad_norm"], gnorm)
        for x, y in zip(tree_leaves((params, got_o["mu"], got_o["nu"])),
                        tree_leaves((want_p, want_o["mu"], want_o["nu"]))):
            assert torch.equal(x, y)
    assert int(got_o["step"]) == 3
    assert trace.counts.get("adamw_fused", 0) == fused_count
    assert fused.launches == launches


def test_importing_builds_nothing():
    """Importing the wrapper and the optimizer compiles and loads no
    library (the CPU tests import every module, with no ``nvcc``)."""
    code = ("import sys\n"
            "from repro_torch.kernels import _build\n"
            "def refuse(name):\n"
            "    sys.exit('built ' + name)\n"
            "_build.build = _build.load = refuse\n"
            "import repro_torch.kernels.adamw, repro_torch.optim\n"
            "print('nothing built')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ,
                                         "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "nothing built"
