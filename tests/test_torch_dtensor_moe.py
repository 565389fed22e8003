"""The MoE FFN and the client-on-pod DML round on the data x model mesh
against the JAX package on the CPU: the port's steps as DTensor programs
on 4 gloo ranks (``tests/_torch_ranks.py::moe_steps``) against the JAX
package's unsharded steps.

Reduced qwen2-moe-a2.7b (4 experts top-2, 1 shared, fp32) starts from
JAX-initialised params (``interop``): on a (data 2, model 2) mesh, where
the experts are split over ``model``, one ``make_train_step`` step and
one fused DML round (K = 2); with 6 experts on a (data 1, model 4) mesh,
where the experts do not divide and ``ff`` is split (the expert
projections column- and row-parallel), the same train step.  Every MoE
case also runs unsharded in the port from the same params, and the
routes of every ``apply_moe`` call (``moe.route_log``) are identical.
Reduced qwen3-4b runs one fused DML round on a (pod 2, data 1, model 2)
mesh with the clients on ``pod`` (``spmd_client_axis="pod"``), each rank
holding one live client against both clients' gathered public logits
(``ops._pair_local``'s rectangular branch, at impl "ref").  Tolerances,
those of ``tests/test_torch_dtensor.py``: metrics atol 2e-5, params atol
1e-4, first moments atol 1e-5; and the global norm also rtol 1e-5, as
``tests/test_torch_steps.py`` holds it (the MoE steps' norm is ~17: the
packages' fp32 sums differ by ~10 ulps there, unsharded as sharded).
"""
import dataclasses

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
from repro_torch.data.synthetic import make_token_stream

from _torch_ranks import Ranks
from test_torch_dtensor import _flat

OPT = dict(lr=1e-3, warmup=2, total_steps=3)
K, B, S, PUB = 2, 4, 16, 2
V = 512


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg = jget_reduced("qwen2-moe-a2.7b")
    jcfg6 = jcfg.replace(moe=dataclasses.replace(jcfg.moe, n_experts=6))
    jq = jget_reduced("qwen3-4b")
    jp = jtfm.init_model(jax.random.PRNGKey(0), jcfg)
    jp6 = jtfm.init_model(jax.random.PRNGKey(6), jcfg6)
    jsp = jD.stacked_init(jax.random.PRNGKey(1), jcfg, K)
    # the draw of test_torch_dtensor.py's (data 2, model 2) DML round: the
    # two meshes' rounds share one JAX reference
    jqp = jD.stacked_init(jax.random.PRNGKey(1), jq, K)
    toks = make_token_stream(B, S, V, seed=3)
    ktoks = make_token_stream(K * B, S, V, seed=4).reshape(K, B, S)
    pub = make_token_stream(PUB, S, V, seed=5)
    ranks = Ranks("moe_steps", 4, tmp_path_factory.mktemp("ranks"),
                  params=_flat(jp), params6=_flat(jp6), sparams=_flat(jsp),
                  qparams=_flat(jqp), train_tokens=toks, tokens=ktoks,
                  public=pub, opt=OPT)
    want = {}                      # the JAX steps while the ranks run
    for name, c, p in (("moe_train", jcfg, jp), ("moe_train_ff", jcfg6, jp6)):
        step = jax.jit(jsteps.make_train_step(c, JAdamWConfig(**OPT)))
        want[name] = step(p, jadamw_init(p), jnp.asarray(toks))
    for name, c, p in (("moe_dml", jcfg, jsp), ("pod_dml", jq, jqp)):
        step = jax.jit(jD.make_dml_train_step(c, JAdamWConfig(**OPT),
                                              impl="ref"))
        want[name] = step(p, jadamw_init(p), jnp.asarray(ktoks),
                          jnp.asarray(pub))
    want = {k: (m, p, o) for k, (p, o, m) in want.items()}
    return ranks.result(), want


def _check(got, want):
    m, p, o = want
    assert sorted(got["metrics"]) == sorted(k for k in m if k != "lr")
    for k, v in got["metrics"].items():
        np.testing.assert_allclose(v, np.asarray(m[k]), atol=2e-5,
                                   rtol=1e-5 if k == "grad_norm" else 0,
                                   err_msg=k)
    for key, tree, atol in (("params", p, 1e-4), ("mu", o["mu"], 1e-5)):
        ref = _flat(tree)
        assert sorted(got[key]) == sorted(ref)
        for k in ref:
            np.testing.assert_allclose(got[key][k], ref[k], atol=atol,
                                       rtol=0, err_msg=f"{key} {k}")


@pytest.mark.parametrize("name,split", [
    ("moe_train", "expert"), ("moe_dml", "expert"), ("moe_train_ff", "ff")])
def test_moe_on_mesh_matches_jax(runs, name, split):
    """The step against JAX's unsharded one; the expert leaves were split
    as the case says (experts: ``Shard`` of the expert dim on ``model``;
    ``ff``: ``w_gate``'s last dim and ``w_down``'s ``ff`` dim)."""
    got, want = runs
    _check(got[name], want[name])
    place = {k.rsplit("/", 1)[-1]: v for k, v in got[name]["placements"]
             .items() if "/ffn/w_" in k}
    lead = 1 if name == "moe_dml" else 0      # the client dim
    # dims of the (layers, E, d, de) / (layers, E, de, d) leaves
    dims = ({"w_gate": 1, "w_up": 1, "w_down": 1} if split == "expert"
            else {"w_gate": 3, "w_up": 3, "w_down": 2})
    for leaf, d in dims.items():               # model, the last mesh dim
        assert place[leaf].endswith(f"Shard(dim={d + lead}))"), place


@pytest.mark.parametrize("name", ["moe_train", "moe_dml", "moe_train_ff"])
def test_moe_routes_on_mesh_equal_unsharded(runs, name):
    """Every ``apply_moe`` call (forward and remat recompute) routes the
    same tokens to the same experts and drops the same choices sharded as
    unsharded; the sharded step also equals the port's unsharded step."""
    got, _ = runs
    sharded, whole = got[name]["routes"], got[name + "_unsharded"]["routes"]
    assert len(sharded) == len(whole) > 0
    for (i, k), (wi, wk) in zip(sharded, whole):
        np.testing.assert_array_equal(i, wi)
        np.testing.assert_array_equal(k, wk)
    ref = got[name + "_unsharded"]
    _check(got[name], (ref["metrics"], ref["params"], {"mu": ref["mu"]}))


def test_client_on_pod_dml_round_matches_jax(runs):
    """Each rank's Eq.-2 call was rectangular (one live client against
    both gathered), and the round equals JAX's unsharded round."""
    got, want = runs
    shapes = got["pod_dml"]["pair_shapes"]
    assert shapes and all(lv[0] == 1 and fx[0] == K for lv, fx in shapes)
    _check(got["pod_dml"], want["pod_dml"])
