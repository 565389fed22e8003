"""The logical-axis rules of the data x model mesh against the JAX package
(``repro/sharding/__init__.py``), in one process, on mesh doubles.

``logical_to_spec`` of the port gives JAX's ``PartitionSpec`` entries as a
tuple: every case of ``tests/test_sharding.py`` and a sweep over logical
tuples, dim sizes, the (data 16, model 16) and (pod 2, data 16, model 16)
meshes and the dry-run's rule sets (client methods, ``attn_dp``,
``no_fsdp``, ``seqpar``) are held equal.  The ``*_logical_axes`` trees
equal JAX's for all 10 archs and have the structure of the port's own
param, optimizer and cache trees.  Then the DTensor half on a mesh double:
placements, ``constrain`` without a mesh, ``use_mesh``, ``axis_rules``.
"""
import itertools

import jax
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro import sharding as jshd
from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.core import distributed as jD
from repro.launch import specs as jS
from repro.models import transformer as jtfm
from repro_torch import sharding as shd
from repro_torch.checkpoint import flatten
from repro_torch.configs import ARCH_IDS, SHAPES, get_reduced
from repro_torch.core import distributed as D
from repro_torch.launch import dryrun as DR
from repro_torch.launch import specs as S
from repro_torch.models import transformer as tfm


class FakeMesh:
    """JAX's test double: axis names and sizes."""

    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.axis_sizes = tuple(sizes)


class FakeDeviceMesh:
    """A DeviceMesh's names and shape, without a process group."""

    def __init__(self, names, sizes):
        self.mesh_dim_names = tuple(names)
        self.shape = tuple(sizes)


MESH = FakeMesh(("data", "model"), (16, 16))
MESH3 = FakeMesh(("pod", "data", "model"), (2, 16, 16))


def _both(logical, mesh, shape, rules=None):
    """(port, JAX) specs under the same rule overrides."""
    with shd.axis_rules(rules or {}), jshd.axis_rules(rules or {}):
        return (shd.logical_to_spec(tuple(logical), mesh, shape),
                tuple(jshd.logical_to_spec(tuple(logical), mesh, shape)))


@pytest.mark.parametrize("logical,mesh,shape,rules", [
    (("batch", "seq", "heads"), MESH, (256, 4096, 32), None),
    (("batch", None), MESH3, (256, 10), None),
    (("batch",), MESH3, (2,), None),
    (("batch", "heads"), MESH, (32, 24), None),
    (("batch", "kv_seq", "kv_heads", None), MESH, (128, 32768, 16, 128),
     None),
    (("client", "batch"), MESH3, (2, 128), {"batch": ("data",),
                                            "client": "pod"}),
    (("nonsense", "batch"), MESH, (4, 32), None),
])
def test_every_case_of_the_jax_suite(logical, mesh, shape, rules):
    got, want = _both(logical, mesh, shape, rules)
    assert got == want


def test_default_rules_are_jax_s():
    assert shd.DEFAULT_RULES == jshd.DEFAULT_RULES
    assert shd.get_rules() == jshd.get_rules()


LOGICAL = [("batch", "seq", "heads", None), ("attn_batch", "seq", "kv_heads",
                                            None),
           ("client", "batch", "seq", "vocab"), ("vocab", "embed"),
           ("embed", "ff"), ("expert", "embed", "ff"),
           ("batch", "kv_seq", "kv_heads", "head_dim"),
           ("batch", "res_seq", "embed_act"), ("client", None, "vocab"),
           ("layers", "heads", "head_dim", "embed"), ("ff", "embed"),
           ("batch", "heads", None, "state"), (None, "embed"),
           ("client", "layers", "embed", "heads", "head_dim")]
SHAPES_ = [(2, 32, 48, 128), (256, 4096, 8, 128), (3, 16, 24, 7),
           (512, 64, 16, 2560), (32, 40, 72, 151936)]
RULES = {
    "baseline": {},
    "client": {"batch": ("data",), "attn_batch": ("data",)},
    "attn_dp": {"attn_batch": ("pod", "data", "model")},
    "client+attn_dp": {"batch": ("data",),
                       "attn_batch": ("data", "model")},
    "no_fsdp": {"embed": None},
    "seqpar": {"res_seq": "model"},
    "spmd_pod": {"batch": ("data",), "attn_batch": ("data",),
                 "client": "pod"},
}


@pytest.mark.parametrize("rules", list(RULES))
@pytest.mark.parametrize("mesh", ["pod", "multi"])
def test_logical_to_spec_sweep(rules, mesh):
    m = MESH if mesh == "pod" else MESH3
    for logical, shape in itertools.product(LOGICAL, SHAPES_):
        shape = (shape * 2)[:len(logical)]
        got, want = _both(logical, m, shape, RULES[rules])
        assert got == want, (logical, shape)
        got, want = _both(logical, m, None, RULES[rules])
        assert got == want, (logical, "no shape")


@pytest.mark.parametrize("method,variant", [
    ("standard", "baseline"), ("dml", "baseline"), ("standard", "attn_dp"),
    ("mutual", "attn_dp"), ("fedavg_sync", "no_fsdp"),
    ("standard", "seqpar"), ("dml", "chunked_ce+seqpar+no_fsdp")])
def test_dry_run_rules_are_jax_run_case_s(method, variant):
    """``dryrun.mesh_rules`` is ``repro/launch/dryrun.py:375-385``."""
    want = ({"batch": ("data",), "attn_batch": ("data",)}
            if method in ("dml", "mutual", "fedavg_sync") else {})
    if "attn_dp" in variant:
        want["attn_batch"] = want.get("attn_batch", ("pod", "data")) + \
            ("model",)
    if "no_fsdp" in variant:
        want["embed"] = None
    if "seqpar" in variant:
        want["res_seq"] = "model"
    assert DR.mesh_rules(method, variant) == want


def _axes_flat(tree, prefix=""):
    """A logical-axes tree as {path + "/": tuple}, tuples as leaves."""
    if shd.is_axes(tree):
        return {prefix + "/": tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_axes_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _jax_flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple) and all(
            isinstance(e, (str, type(None))) for e in x))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path) + "/": tuple(v) for path, v in leaves}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_axes_trees_equal_jax_and_fit_the_trees(arch):
    assert ARCH_IDS == JARCH_IDS
    jcfg = jget_config(arch)
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    pairs = [(tfm.logical_axes(cfg), jtfm.logical_axes(jcfg)),
             (tfm.cache_logical_axes(cfg), jtfm.cache_logical_axes(jcfg)),
             (D.stacked_logical_axes(cfg), jD.stacked_logical_axes(jcfg)),
             (S.opt_logical_axes(tfm.logical_axes(cfg)),
              jS.opt_logical_axes(jtfm.logical_axes(jcfg)))]
    for got, want in pairs:
        assert _axes_flat(got) == _jax_flat(want)
    # the port's own trees (reduced, on meta) have the axes' structure and
    # one name a dim
    rcfg = get_reduced(arch)
    params = S.model_state_specs(rcfg)
    opt = S.opt_state_specs(params)
    cache = S.cache_specs(rcfg, SHAPES["decode_32k"])
    stacked = S.model_state_specs(rcfg, 2)
    for tree, axes in ((params, tfm.logical_axes(rcfg)),
                       (opt, S.opt_logical_axes(tfm.logical_axes(rcfg))),
                       (cache, tfm.cache_logical_axes(rcfg)),
                       (stacked, D.stacked_logical_axes(rcfg))):
        leaves, ax = flatten(tree), _axes_flat(axes)
        assert sorted(leaves) == sorted(k[:-1] for k in ax)
        for k, t in leaves.items():
            assert t.dim() == len(ax[k + "/"]), k


@pytest.mark.parametrize("arch", ["qwen3-4b", "llava-next-mistral-7b"])
def test_spec_axes_equal_jax_s(arch):
    from repro_torch.configs import get_config
    cfg, jcfg = get_config(arch), jget_config(arch)
    shape, jshape = SHAPES["train_4k"], JSHAPES["train_4k"]
    for n in (0, 2):
        assert S.batch_axes(cfg, n) == jS.batch_inputs(jcfg, jshape, n)[1]
    assert S.public_axes(cfg) == jS.public_inputs(jcfg, jshape, 4)[1]
    assert _axes_flat(S.cache_axes(cfg)) == _jax_flat(
        jS.cache_specs(jcfg, jshape)[1])
    assert _axes_flat(S.model_state_axes(cfg)) == _jax_flat(
        jtfm.logical_axes(jcfg))
    specs = S.batch_inputs(cfg, shape)
    assert sorted(specs) == sorted(S.batch_axes(cfg))


def test_placements_on_a_mesh_double():
    mesh = FakeDeviceMesh(("pod", "data", "model"), (2, 16, 16))
    # a dim over two axes is Shard on both; the others Replicate
    assert shd.logical_to_placements(("batch", "seq", "heads"), mesh,
                                     (64, 128, 32)) == \
        (Shard(0), Shard(0), Shard(2))
    assert shd.logical_to_placements(("batch", "heads"), mesh, (2, 24)) == \
        (Shard(0), Replicate(), Replicate())
    with shd.axis_rules({"batch": ("data",), "client": "pod"}):
        assert shd.named_sharding(mesh, "client", "batch", None,
                                  shape=(2, 32, 5)) == \
            (mesh, (Shard(0), Shard(1), Replicate()))
    # batch 4: the prefix of ("pod", "data") that divides it is pod alone
    tree = {"a": torch.empty(4, 32), "b": [torch.empty(3)]}
    axes = {"a": ("batch", "ff"), "b": [("vocab",)]}
    got = shd.spec_tree_like(axes, mesh, tree)
    assert got["a"][1] == (Shard(0), Replicate(), Shard(1))
    assert got["b"][0][1] == (Replicate(),) * 3


def test_constrain_use_mesh_and_rules_restore():
    x = torch.arange(6.0).reshape(2, 3)
    assert shd.current_mesh() is None
    assert shd.constrain(x, "batch", "ff") is x
    mesh = FakeDeviceMesh(("data", "model"), (2, 2))
    with shd.use_mesh(mesh):
        assert shd.current_mesh() is mesh
        # a plain tensor on a mesh: returned as it is, as JAX's constant
        assert shd.constrain(x, "batch", "ff") is x
        fwd, recompute = shd.checkpoint_context()
    assert shd.current_mesh() is None
    with recompute:
        assert shd.current_mesh() is mesh
    assert shd.current_mesh() is None
    with shd.axis_rules({"ff": None}):
        with shd.axis_rules({"vocab": "data"}):
            assert shd.get_rules()["ff"] is None
            assert shd.get_rules()["vocab"] == "data"
        assert shd.get_rules()["vocab"] == "model"
    assert shd.get_rules() is shd.DEFAULT_RULES
