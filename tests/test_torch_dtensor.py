"""The data x model mesh against the JAX package on the CPU: the port's
steps as DTensor programs on 4 gloo ranks (``tests/_torch_ranks.py``)
against the JAX package's unsharded steps.

Reduced qwen3-4b (heads 4, kv 2, ff 256, vocab 512, fp32) starts from
JAX-initialised params (``interop``).  On a (data 2, model 2) mesh the
port runs one ``make_train_step`` step, one fused DML round and one
SparseDML round (k = 8, its top-k through the vocab-sharded two-stage
``_distributed_topk``) at impl "ref"; the train step also on a (data 1,
model 4) mesh, where each rank's single query head takes its key/value
group's head; and a reduced mamba2-780m step (the SSD scan sharded over
heads), also from JAX-initialised params.  The JAX references run jitted
and unsharded (JAX's ``constrain`` is a no-op without a mesh).  Tolerances, those of
``tests/test_torch_steps.py`` (the mesh moves no number but the order of
its sums): metrics atol 2e-5, params atol 1e-4, first moments atol 1e-5.
The vocab-sharded top-k equals ``lax.top_k`` exactly, ties across shards
included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_reduced as jget_reduced
from repro.core import distributed as jD
from repro.launch import steps as jsteps
from repro.models import transformer as jtfm
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch.checkpoint import flatten
from repro_torch.data.synthetic import make_token_stream

from _torch_ranks import Ranks

OPT = dict(lr=1e-3, warmup=2, total_steps=3)
K, B, S, PUB, SPARSE_K = 2, 4, 16, 2, 8
V = 512


def _flat(tree):
    return {k: np.asarray(v, dtype=np.float32)
            for k, v in flatten(jax.tree.map(np.asarray, tree)).items()}


def _topk_cases():
    """Rows of 32 whose ties straddle the shard edges at 8, 16 and 24,
    with k cutting through them; and a row of all ties."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((K, 3, 32)).astype(np.float32)
    x[:, 1] = -5.0
    x[:, 1, [7, 8, 15, 16, 17, 24]] = 1.5
    x[:, 2] = 0.25
    return [(x, 3), (x, 5), (x[:, :, :], 8)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg = jget_reduced("qwen3-4b")
    jp = jtfm.init_model(jax.random.PRNGKey(0), jcfg)
    jsp = jD.stacked_init(jax.random.PRNGKey(1), jcfg, K)
    jmcfg = jget_reduced("mamba2-780m")
    jmp = jtfm.init_model(jax.random.PRNGKey(2), jmcfg)
    toks = make_token_stream(B, S, V, seed=3)
    ktoks = make_token_stream(K * B, S, V, seed=4).reshape(K, B, S)
    pub = make_token_stream(PUB, S, V, seed=5)
    cases = _topk_cases()
    ranks = Ranks("mesh_steps", 4, tmp_path_factory.mktemp("ranks"),
                  params=_flat(jp), sparams=_flat(jsp), mparams=_flat(jmp),
                  train_tokens=toks,
                  tokens=ktoks, public=pub, opt=OPT, sparse_k=SPARSE_K,
                  topk_cases=cases)
    want = {}                      # the JAX steps while the ranks run
    jstep = jax.jit(jsteps.make_train_step(jcfg, JAdamWConfig(**OPT)))
    p, o, m = jstep(jp, jadamw_init(jp), jnp.asarray(toks))
    want["train"] = (m, p, o)
    jstep = jax.jit(jsteps.make_train_step(jmcfg, JAdamWConfig(**OPT)))
    p, o, m = jstep(jmp, jadamw_init(jmp), jnp.asarray(toks))
    want["mamba2"] = (m, p, o)
    for name, k in (("dml", 0), ("sparse", SPARSE_K)):
        step = jax.jit(jD.make_dml_train_step(jcfg, JAdamWConfig(**OPT),
                                              sparse_k=k, impl="ref"))
        p, o, m = step(jsp, jadamw_init(jsp), jnp.asarray(ktoks),
                       jnp.asarray(pub))
        want[name] = (m, p, o)
    want["topk"] = [tuple(np.asarray(a) for a in jax.lax.top_k(x, k))
                    for x, k in cases]
    return ranks.result(), want


def _check(got, want):
    m, p, o = want
    assert sorted(got["metrics"]) == sorted(k for k in m if k != "lr")
    for k, v in got["metrics"].items():
        np.testing.assert_allclose(v, np.asarray(m[k]), atol=2e-5, rtol=0,
                                   err_msg=k)
    for key, tree, atol in (("params", p, 1e-4), ("mu", o["mu"], 1e-5)):
        ref = _flat(tree)
        assert sorted(got[key]) == sorted(ref)
        for k in ref:
            np.testing.assert_allclose(got[key][k], ref[k], atol=atol,
                                       rtol=0, err_msg=f"{key} {k}")


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_train_step_on_mesh_matches_jax(runs, mesh):
    got, want = runs
    _check(got[f"train_{mesh}"], want["train"])


@pytest.mark.parametrize("name", ["dml", "sparse"])
def test_dml_rounds_on_mesh_match_jax(runs, name):
    """The fused DML round (Eq. 2 through the square pair-KL dispatch on
    each rank's vocab-gathered logits) and the SparseDML round."""
    got, want = runs
    _check(got[name], want[name])


def test_mamba2_step_on_mesh_matches_unsharded(runs):
    """Reduced mamba2-780m (8 heads, 1 group): the SSD scan on each rank's
    (batch, heads) shard (``ops.ssd_clients``, whose A, B and C gradients
    are partial sums over the batch and head splits); the step against the
    JAX package's unsharded step, at the same tolerances."""
    got, want = runs
    _check(got["mamba2"], want["mamba2"])


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_vocab_sharded_topk_equals_lax_top_k(runs, mesh):
    """Values and indices exactly, ties across shards included; the
    logits were sharded on the vocab (the branch ran)."""
    got, want = runs
    for (vals, idx, placements), (wv, wi) in zip(got[f"topk_{mesh}"],
                                                 want["topk"]):
        assert "Shard(dim=2)" in placements
        np.testing.assert_array_equal(vals, wv)
        np.testing.assert_array_equal(idx, wi)
