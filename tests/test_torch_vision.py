"""The port's VisionNet modules (``repro_torch``: list-bearing trees, the
image data and fold plumbing, ``models.visionnet``'s stacked forward and
its dropout, the Bernoulli half of ``core.mutual``, per-client SGD) against
the JAX package on the CPU.

Inputs come from numpy with a seed; JAX params cross through
``interop.params_from_numpy``.  Tolerances, all fp32: data, folds and
plans byte for byte; the forward's probabilities rtol 1e-5 and every BCE
gradient rtol 1e-4 (the convolutions sum in another order); the Bernoulli
KL and its gradient rtol 1e-5; the SGD step atol 1e-7 (the same
arithmetic).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import visionnet as jvcfg
from repro.core import mutual as jmutual
from repro.core import stacking as jstacking
from repro.data import federated as jfed
from repro.data import synthetic as jsyn
from repro.kernels import ref as jref
from repro.models import visionnet as jvn
from repro.optim import SGDConfig as JSGDConfig
from repro.optim import sgd_update as jsgd_update
from repro_torch import checkpoint, interop
from repro_torch.configs import visionnet as vcfg
from repro_torch.core import mutual, stacking
from repro_torch.data import federated as fed
from repro_torch.data import synthetic as syn
from repro_torch.kernels import ref
from repro_torch.models import visionnet as vn
from repro_torch.optim import SGDConfig, client_norms, sgd_init, sgd_update
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)
TOL_PROBS = dict(rtol=1e-5, atol=1e-7)
TOL_GRAD = dict(rtol=1e-4, atol=1e-7)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _trees_close(got, want, **tol):
    got = {k: _np(v) for k, v in checkpoint.flatten(got).items()}
    want = {k: _np(v) for k, v in checkpoint.flatten(want).items()}
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **tol)


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in checkpoint.flatten(tree).items()}


def _jax_stack(cfg, K, seed=0):
    """K JAX-initialised clients, stacked, as numpy."""
    params = jstacking.stacked_init(
        jax.random.PRNGKey(seed), lambda k: jvn.init_visionnet(k, cfg), K)
    return jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# trees with lists

def test_tree_helpers_recurse_into_lists_and_tuples(tmp_path):
    tree = {"conv": [{"w": torch.ones(2), "b": torch.zeros(1)},
                     {"w": torch.full((3,), 2.0), "b": torch.ones(1)}],
            "pair": (torch.ones(1), torch.zeros(2)), "x": torch.ones(4)}
    assert len(tree_leaves(tree)) == 7
    out = tree_map(lambda a, b: a + b, tree, tree)
    assert isinstance(out["conv"], list) and isinstance(out["pair"], tuple)
    assert torch.equal(out["conv"][1]["w"], torch.full((3,), 4.0))
    # VisionNet params: interop and the checkpoint keep the list
    jparams = jax.tree.map(np.asarray, jvn.init_visionnet(
        jax.random.PRNGKey(0), jvcfg.reduced()))
    params = interop.params_from_numpy(jparams, device="cpu")
    assert isinstance(params["conv"], list) and len(params["conv"]) == 3
    _trees_close(params, jparams, rtol=0, atol=0)
    _trees_close(interop.params_to_numpy(params), jparams, rtol=0, atol=0)
    step = torch.tensor(7, dtype=torch.int32)
    checkpoint.save(str(tmp_path / "vn"), {"p": params, "step": step},
                    {"a": 1})
    back, meta = checkpoint.restore(str(tmp_path / "vn"))
    assert meta == {"a": 1} and isinstance(back["p"]["conv"], list)
    assert back["step"].shape == () and torch.equal(back["step"], step)
    _trees_close(back["p"], jparams, rtol=0, atol=0)
    flat = checkpoint.flatten(jparams)
    _trees_close(interop.params_from_numpy(flat, device="cpu"), jparams,
                 rtol=0, atol=0)


# ---------------------------------------------------------------------------
# data copies, byte for byte

def test_image_datasets_match_jax_bytes():
    for kw in (dict(n=37, image_size=20, seed=3),
               dict(n=10, image_size=9, seed=1, brightness=0.1,
                    noise=0.3, signal=0.5)):
        for a, b in zip(syn.make_image_dataset(**kw),
                        jsyn.make_image_dataset(**kw)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    got = syn.make_paper_datasets(image_size=16, seed=2, n_train=40,
                                  n_test=30)
    want = jsyn.make_paper_datasets(image_size=16, seed=2, n_train=40,
                                    n_test=30)
    for (ga, gb), (wa, wb) in zip(got, want):
        assert ga.tobytes() == wa.tobytes() and gb.tobytes() == wb.tobytes()
    arrays = (np.arange(23), np.arange(23) * 2.0)
    for drop in (True, False):
        g = list(syn.batched(arrays, 5, seed=4, drop_last=drop))
        w = list(jsyn.batched(arrays, 5, seed=4, drop_last=drop))
        assert len(g) == len(w)
        for gb, wb in zip(g, w):
            assert all(np.array_equal(x, y) for x, y in zip(gb, wb))


def test_folds_shards_and_plans_match_jax():
    labels = jsyn.make_image_dataset(211, 4, seed=5)[1]
    for a, b in zip(fed.stratified_k_folds(labels, 13, seed=2),
                    jfed.stratified_k_folds(labels, 13, seed=2)):
        assert np.array_equal(a, b)
    for a, b in zip(fed.dirichlet_shards(labels, 4, 0.3, seed=1),
                    jfed.dirichlet_shards(labels, 4, 0.3, seed=1)):
        assert np.array_equal(a, b)
    for a, b in zip(fed.iid_shards(211, 3, seed=6),
                    jfed.iid_shards(211, 3, seed=6)):
        assert np.array_equal(a, b)
    for a, b in zip(fed.public_round_sets(labels, 4, 9, seed=3),
                    jfed.public_round_sets(labels, 4, 9, seed=3)):
        assert np.array_equal(a, b)
    folds = [np.arange(40), np.arange(50, 63), np.array([], np.int64),
             np.arange(70, 75)]
    for bs in (4, 16, 100):
        got = fed.round_batch_indices(folds, 3, bs, seed=7)
        want = jfed.round_batch_indices(folds, 3, bs, seed=7)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for K in (0, 1, 3, 5):
        assert fed.sample_participants(5, K, 3, 2) == \
            jfed.sample_participants(5, K, 3, 2)


@pytest.mark.parametrize("kind", ["iid", "non_iid"])
def test_fold_schedulers_match_jax(kind):
    """Both schedulers pop the same folds and round plans, and resume from
    ``state`` as the JAX ones do, in either direction."""
    labels = jsyn.make_image_dataset(301, 4, seed=1)[1]
    make = {"iid": lambda m: m.FoldScheduler(labels, 3, 4, seed=2),
            "non_iid": lambda m: m.NonIIDScheduler(labels, 3, 4, alpha=0.4,
                                                   seed=2)}[kind]
    got, want = make(fed), make(jfed)
    assert got.n_folds == want.n_folds == 17
    assert np.array_equal(got.pop(), want.pop())
    for r in range(2):
        g = got.pop_round(3, 2, 8, seed=r)
        w = want.pop_round(3, 2, 8, seed=r)
        assert all(np.array_equal(a, b) for a, b in zip(g[0], w[0]))
        assert np.array_equal(g[1], w[1]) and np.array_equal(g[2], w[2])
        assert np.array_equal(got.pop(), want.pop())
    assert got.state() == want.state()
    assert got.remaining() == want.remaining()
    fresh_t, fresh_j = make(fed), make(jfed)
    fresh_t.load_state(want.state())
    fresh_j.load_state(got.state())
    for _ in range(want.remaining()):
        f = want.pop()
        assert np.array_equal(fresh_t.pop(), f)
        assert np.array_equal(fresh_j.pop(), f)


# ---------------------------------------------------------------------------
# models.visionnet

def test_init_shapes_fans_and_split():
    for cfg, jcfg in ((vcfg.CONFIG, jvcfg.CONFIG),
                      (vcfg.reduced(), jvcfg.reduced())):
        assert cfg == vcfg.VisionNetConfig(**vars(jcfg))
        want = jax.eval_shape(lambda: jvn.init_visionnet(
            jax.random.PRNGKey(0), jcfg))
        got = vn.init_visionnet(3, cfg, device="cpu")
        assert _shapes(got) == _shapes(want)
        assert all(t.dtype == torch.float32 for t in tree_leaves(got))
        split = vn.shallow_deep_split(got)
        assert checkpoint.flatten(split) == checkpoint.flatten(
            jvn.shallow_deep_split(want))
    assert sum(t.numel() for t in tree_leaves(got)) == 71_633
    full = vn.init_visionnet(torch.Generator().manual_seed(0), vcfg.CONFIG,
                             device="cpu")
    assert sum(t.numel() for t in tree_leaves(full)) == 5_213_377
    # truncated at 2 standard deviations of each fan's scale, zero biases
    w = full["dense"]["w"]
    assert float(w.abs().max()) <= 2 * (2.0 / 80_000) ** 0.5
    assert abs(float(w.std()) / (2.0 / 80_000) ** 0.5 - 0.8796) < 0.01
    assert float(full["conv"][0]["b"].abs().sum()) == 0.0
    again = vn.init_visionnet(0, vcfg.CONFIG, device="cpu")
    assert torch.equal(again["dense"]["w"], w)


@pytest.mark.parametrize("K,shared", [(1, True), (1, False), (3, True),
                                      (3, False)])
def test_forward_and_bce_gradients_match_jax(K, shared):
    """The stacked forward on a shared batch and on per-client batches,
    without dropout, and every gradient of the summed BCE, against JAX's
    per-client forward under ``vmap``."""
    jcfg, cfg = jvcfg.reduced(), vcfg.reduced()
    jparams = _jax_stack(jcfg, K, seed=K)
    params = interop.params_from_numpy(jparams, device="cpu")
    rng = np.random.default_rng(K)
    B = 6
    shape = (B,) if shared else (K, B)
    images = rng.uniform(0, 1, shape + (32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 2, (K, B)).astype(np.int32)

    def jloss(p):
        if shared:
            probs = jax.vmap(lambda q: jvn.visionnet_forward(
                q, jcfg, jnp.asarray(images)))(p)
        else:
            probs = jax.vmap(lambda q, im: jvn.visionnet_forward(
                q, jcfg, im))(p, jnp.asarray(images))
        bce = jax.vmap(jvn.bce_loss)(probs, jnp.asarray(labels))
        return jnp.sum(bce), (probs, bce)

    (_, (jprobs, jbce)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jax.tree.map(jnp.asarray, jparams))
    q = tree_map(lambda t: t.requires_grad_(True), params)
    probs = vn.visionnet_forward(q, cfg, torch.from_numpy(images))
    bce = vn.bce_loss(probs, torch.from_numpy(labels))
    grads = torch.autograd.grad(bce.sum(), tree_leaves(q))
    np.testing.assert_allclose(_np(probs), np.asarray(jprobs), **TOL_PROBS)
    np.testing.assert_allclose(_np(bce), np.asarray(jbce), **TOL_PROBS)
    it = iter(grads)
    _trees_close(tree_map(lambda _: next(it), q), jgrads, **TOL_GRAD)


def test_dropout_keep_share_scale_and_determinism():
    """The port's dropout (its own draws): the keep share within 4
    standard errors of 1 - rate, kept values scaled by 1 / keep, the same
    generator state gives the same mask, and it runs only in training."""
    x = torch.ones(4, 50_000)
    for rate in (0.5, 0.2):
        y = vn.dropout(x, rate, torch.Generator().manual_seed(1))
        kept = y != 0
        share = float(kept.float().mean())
        assert abs(share - (1 - rate)) < 4 * (rate * (1 - rate)
                                              / x.numel()) ** 0.5
        assert torch.equal(y[kept], torch.full_like(y[kept], 1 / (1 - rate)))
        again = vn.dropout(x, rate, torch.Generator().manual_seed(1))
        assert torch.equal(y, again)
        other = vn.dropout(x, rate, torch.Generator().manual_seed(2))
        assert not torch.equal(y, other)
    cfg = vcfg.reduced()
    params = stacking.stack_params([vn.init_visionnet(s, cfg, device="cpu")
                                    for s in range(2)])
    images = torch.rand(5, 32, 32, 3, generator=torch.Generator()
                        .manual_seed(0))
    plain = vn.visionnet_forward(params, cfg, images)
    assert torch.equal(plain, vn.visionnet_forward(
        params, cfg, images, train=False,
        generator=torch.Generator().manual_seed(3)))
    live = [vn.visionnet_forward(params, cfg, images, train=True,
                                 generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    assert torch.equal(live[0], live[1]) and not torch.equal(live[0], plain)
    # rate 0 is the identity, as in the JAX forward (keep = 1)
    cfg0 = cfg.replace(dropout_rate=0.0)
    assert torch.equal(plain, vn.visionnet_forward(
        params, cfg0, images, train=True,
        generator=torch.Generator().manual_seed(3)))


def test_strict_fp32_restores_the_flags():
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    with vn.strict_fp32():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before


# ---------------------------------------------------------------------------
# the Bernoulli half of core.mutual

def _probs(shape, seed, edge=False):
    p = np.random.default_rng(seed).uniform(0.02, 0.98, shape)
    if edge:                       # inside the clips' reach
        p[0, :2] = (1e-9, 1 - 1e-9)
    return p.astype(np.float32)


@pytest.mark.parametrize("part", [None, [1, 0, 1, 1]])
def test_bernoulli_mutual_functions_match_jax(part):
    live, fixed = _probs((4, 7), 0, edge=True), _probs((4, 7), 1)
    pm = None if part is None else np.asarray(part, np.float32)
    w = jmutual._pair_mask(4, pm)
    # terms_vs and terms, with the gradient of a weighted sum (live side)
    gbar = np.random.default_rng(2).standard_normal((4, 7)).astype(
        np.float32)
    jout, jvjp = jax.vjp(lambda x: jmutual.bernoulli_mutual_terms_vs(
        x, jnp.asarray(fixed), w), jnp.asarray(live))
    x = torch.from_numpy(live).requires_grad_(True)
    out = mutual.bernoulli_mutual_terms_vs(
        x, torch.from_numpy(fixed), mutual._pair_mask(4, pm))
    (g,) = torch.autograd.grad(out, x, torch.from_numpy(gbar))
    np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(_np(g), np.asarray(jvjp(gbar)[0]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        _np(mutual.bernoulli_mutual_terms(torch.from_numpy(live),
                                          torch.from_numpy(fixed), pm)),
        np.asarray(jmutual.bernoulli_mutual_terms(live, fixed, pm)),
        rtol=1e-5, atol=1e-7)
    # the loss (fixed = live, detached) and its gradient
    jl, jg = jax.value_and_grad(lambda x: jnp.sum(
        jmutual.bernoulli_mutual_loss(x, part_mask=pm)))(jnp.asarray(live))
    x = torch.from_numpy(live).requires_grad_(True)
    loss = mutual.bernoulli_mutual_loss(x, part_mask=pm)
    (g,) = torch.autograd.grad(loss.sum(), x)
    np.testing.assert_allclose(float(loss.sum().detach()), float(jl),
                               rtol=1e-5)
    np.testing.assert_allclose(_np(g), np.asarray(jg), rtol=1e-5, atol=1e-6)
    loss = mutual.bernoulli_mutual_loss(torch.from_numpy(live),
                                        fixed_probs=torch.from_numpy(fixed),
                                        part_mask=pm)
    np.testing.assert_allclose(
        _np(loss), np.asarray(jmutual.bernoulli_mutual_loss(
            live, fixed_probs=fixed, part_mask=pm)), rtol=1e-5, atol=1e-7)


def test_bernoulli_eval_and_kl_to_target_match_jax():
    p, t = _probs((3, 9), 3, edge=True), _probs((3, 9), 4)
    np.testing.assert_allclose(
        _np(mutual.bernoulli_mutual_eval(torch.from_numpy(p))),
        np.asarray(jmutual.bernoulli_mutual_eval(p)), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_np(ref.bernoulli_mutual_kl(
        torch.from_numpy(p))), np.asarray(jref.bernoulli_mutual_kl(p)),
        rtol=1e-5, atol=1e-7)
    jv, jg = jax.value_and_grad(lambda x: jnp.sum(
        jmutual.bernoulli_kl_to_target(x, jnp.asarray(t))))(jnp.asarray(p))
    x = torch.from_numpy(p).requires_grad_(True)
    tt = torch.from_numpy(t).requires_grad_(True)
    out = mutual.bernoulli_kl_to_target(x, tt)
    gx, gt = torch.autograd.grad(out.sum(), (x, tt), allow_unused=True)
    np.testing.assert_allclose(float(out.sum().detach()), float(jv),
                               rtol=1e-5)
    np.testing.assert_allclose(_np(gx), np.asarray(jg), rtol=1e-5, atol=1e-6)
    assert gt is None                   # the target is held fixed


# ---------------------------------------------------------------------------
# optim: SGD with a per-client clip

def test_sgd_update_clips_each_client_by_its_own_norm():
    """A K=2 stack where client 0's gradient is clipped and client 1's is
    not, against JAX's ``sgd_update`` under ``vmap``; one norm over the
    whole stack would clip both."""
    jcfg = jvcfg.reduced()
    jparams = _jax_stack(jcfg, 2, seed=5)
    rng = np.random.default_rng(5)
    jgrads = jax.tree.map(
        lambda p: (rng.standard_normal(p.shape) * 1e-3).astype(np.float32),
        jparams)
    jgrads = jax.tree.map(lambda g: g * np.array([100.0, 1.0], np.float32)
                          .reshape((2,) + (1,) * (g.ndim - 1)), jgrads)
    jvel = jax.tree.map(
        lambda p: (rng.standard_normal(p.shape) * 0.1).astype(np.float32),
        jparams)
    params, grads, vel = (interop.params_from_numpy(t, device="cpu")
                          for t in (jparams, jgrads, jvel))
    norms = client_norms(grads)
    assert float(norms[0]) > 1.0 > float(norms[1])
    for clip in (1.0, None):
        jc = JSGDConfig(lr=0.05, momentum=0.9, clip_norm=clip)
        jstate = {"vel": jvel, "step": np.zeros((2,), np.int32)}
        want_p, want_o, want_m = jax.jit(jax.vmap(
            lambda p, g, o: jsgd_update(p, g, o, jc)))(jparams, jgrads,
                                                        jstate)
        state = {"vel": vel, "step": torch.zeros((2,), dtype=torch.int32)}
        got_p, got_o, got_m = sgd_update(
            params, grads, state, SGDConfig(lr=0.05, momentum=0.9,
                                            clip_norm=clip))
        _trees_close(got_p, want_p, rtol=0, atol=1e-7)
        _trees_close(got_o["vel"], want_o["vel"], rtol=1e-6, atol=1e-7)
        assert got_o["step"].tolist() == [1, 1]
        np.testing.assert_allclose(_np(got_m["grad_norm"]),
                                   np.asarray(want_m["grad_norm"]),
                                   rtol=1e-6)


def test_sgd_and_stacked_inits_match_jax_layout():
    cfg = vcfg.reduced()
    one = vn.init_visionnet(0, cfg, device="cpu")
    st = sgd_init(one)
    jst = jax.eval_shape(lambda: jax.tree.map(
        lambda x: x, {"vel": jax.tree.map(jnp.zeros_like, jvn.init_visionnet(
            jax.random.PRNGKey(0), jvcfg.reduced())),
            "step": jnp.zeros((), jnp.int32)}))
    assert st["step"].shape == () and st["step"].dtype == torch.int32
    assert _shapes(st["vel"]) == _shapes(jst["vel"])
    stack = stacking.stacked_init(torch.Generator().manual_seed(0),
                                  lambda g: vn.init_visionnet(g, cfg,
                                                              device="cpu"),
                                  3)
    assert all(t.shape[0] == 3 for t in tree_leaves(stack))
    assert not torch.equal(stack["dense"]["w"][0], stack["dense"]["w"][1])
    opt = stacking.stacked_sgd_init(stack)
    assert opt["step"].shape == (3,) and opt["step"].dtype == torch.int32
    assert all(float(t.abs().sum()) == 0.0 for t in tree_leaves(opt["vel"]))
