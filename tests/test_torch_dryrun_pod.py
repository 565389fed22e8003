"""The dry-run on the data x model meshes (``launch/dryrun.py``'s ``pod``
and ``multi``), at reduced size: ``tests/_torch_dryrun_pod.py`` runs in
subprocesses on PyTorch's fake process group of 8 ranks as a (pod 2, data
2, model 2) DeviceMesh, the ``multi`` mesh's machinery without its 512
ranks, and counts one card (``dryrun.count`` with a mesh).

  - a matmul-only program: its per-card FLOPs are the hand count of the
    rank's shard, and it moves nothing;
  - ``standard`` (batch over pod and data): the pods exchange no
    activation, only the data-parallel all-reduce of the gradients of the
    params that the pods replicate;
  - ``dml`` (the clients on the pod axis): over the pod axis move exactly
    the exchanged public logits, all-gathered once (K x B_pub*S x V in
    fp32 at the reduced config), the (K,) Eq.-2 term, and one 4-byte
    scalar all-reduce (the global norm's);
  - reduced qwen2-moe-a2.7b (the MoE FFN on each rank's shards) runs both
    methods, its ``dml`` case moves over pod what qwen3-4b's does, and its
    FFN alone costs a card its shard's FLOPs: the router on its batch
    shard, its E/model experts on their capacity rows of that shard, the
    shared experts' ff/model columns.
"""
import json
import math
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
K = 2


@pytest.fixture(scope="module")
def records():
    env = dict(os.environ, PYTHONPATH=SRC, PYTHONWARNINGS="ignore")
    groups = [["matmul", "qwen3-4b:standard:train"], ["qwen3-4b:dml:train"],
              ["moe", "qwen2-moe-a2.7b:standard:train",
               "qwen2-moe-a2.7b:dml:train"]]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_dryrun_pod.py"), *g],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for g in groups]
    out = {}
    for p in procs:
        stdout, stderr = p.communicate(timeout=400)
        assert p.returncode == 0, stderr[-3000:]
        for line in stdout.splitlines():
            if line.startswith("{"):
                rec = json.loads(line)
                out[rec["case"]] = rec
    return out


def test_matmul_flops_are_the_hand_count(records):
    """x (8, 64) over batch -> (pod, data), w (64, 32) over ff -> model:
    a rank multiplies (2, 64) by (64, 16)."""
    rec = records["matmul"]
    assert rec["flops"] == 2 * (8 // 4) * 64 * (32 // 2)
    assert rec["collectives"]["count"] == 0


def test_standard_moves_no_activation_over_pod(records):
    rec = records["qwen3-4b:standard:train"]
    c = rec["collectives"]
    pod = c["by_axis"]["pod"]
    assert set(pod) == {"count", "all-reduce"}
    assert c["pod_axis"] == pod["all-reduce"] > 0
    assert rec["flops"] > 0


def test_dml_moves_the_exchanged_logits_over_pod(records):
    rec = records["qwen3-4b:dml:train"]
    c = rec["collectives"]
    pod = c["by_axis"]["pod"]
    logits = K * rec["public"] * rec["seq"] * rec["vocab"] * 4
    assert pod["all-gather"] == logits + 4 * K
    assert pod.get("all-reduce", 0) == 4
    assert set(pod) <= {"count", "all-gather", "all-reduce"}
    assert c["pod_axis"] == logits + 4 * K + 4


def test_moe_runs_both_methods_on_the_pod_mesh(records):
    for method in ("standard", "dml"):
        rec = records[f"qwen2-moe-a2.7b:{method}:train"]
        assert rec["flops"] > 0 and rec["collectives"]["count"] > 0


def test_moe_dml_moves_the_exchanged_logits_over_pod(records):
    """The same bytes over pod as qwen3-4b's round: the public logits, the
    (K,) Eq.-2 term and one scalar."""
    rec = records["qwen2-moe-a2.7b:dml:train"]
    c = rec["collectives"]
    pod = c["by_axis"]["pod"]
    logits = K * rec["public"] * rec["seq"] * rec["vocab"] * 4
    assert pod["all-gather"] == logits + 4 * K
    assert pod.get("all-reduce", 0) == 4
    assert set(pod) <= {"count", "all-gather", "all-reduce"}
    assert c["pod_axis"] == logits + 4 * K + 4


def test_moe_ffn_flops_are_the_shard_hand_count(records):
    """8 x 32 tokens over (pod 2, data 2): a card routes 2 sequences (one
    group of G = 32 each) and, with the 4 experts over model 2, fills and
    multiplies 2 experts x 2 groups x C capacity rows, C = ceil(k G cf /
    E); the shared experts' ff is split over model.  Its combine is
    reduced over model once, in fp32."""
    rec = records["moe"]
    d, E, k, de = rec["d"], rec["experts"], rec["top_k"], rec["d_expert"]
    tokens, G = 8 * 32 // 4, 32
    C = math.ceil(k * G * rec["capacity_factor"] / E)
    rows = (E // 2) * (tokens // G) * C
    experts = 3 * 2 * rows * d * de
    router = 2 * tokens * d * E
    shared = 3 * 2 * tokens * d * (rec["shared"] * de // 2)
    assert rec["flops"] == experts + router + shared
    model = rec["collectives"]["by_axis"]["model"]
    assert model == {"count": 1, "all-reduce": tokens * d * 4}
