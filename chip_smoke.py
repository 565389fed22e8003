"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py
    python3 chip_smoke.py --cards 4     # phases 22, 23 and 25 over 4 cards

Phases, each fatal on failure:
  1. environment and kernel build: the card's name and power limit, torch
     and CUDA versions, and the seconds the CUDA kernels took to build from
     the sources in this checkout (one ``nvcc`` per source, all at once);
     for the flash and SSD libraries, each bf16 tensor-core kernel's
     registers and spill stores and the count of HGMMA and HMMA
     instructions in the SASS;
  2. every kernel against its plain PyTorch version on the card, at the
     serving and training paths' shapes and around them, with the kernel's
     time beside its bound, the plain version's time and a library
     yardstick (and for the flash kernels the achieved TFLOP/s of each; the
     forward also at the training path's shapes; both at the prefix
     archs' shapes: llava's windowed ones, window 4096 at 4416 and 4160
     positions, timed against a bound over the unmasked pairs only and
     SDPA with an explicit boolean mask, and musicgen's 24/24 heads of
     64): the flash-attention
     forward and backward, the Eq.-2 KL's square forward and backward
     (fixed is live: the DML round's term and ``mutual_kl``) and pair
     forward and backward (distinct live and fixed) (at qwen3-4b's and
     mamba2-780m's vocabularies, checked also at llava's and musicgen's
     (32,000 and 2,048), and past one launch's 8 clients a side:
     K = 9 and 16 in client blocks), the SSD chunked scan's forward and
     backward, and the
     sparse (top-k) KL's
     forward and backward (at both vocabularies, and past one launch's
     entries: k = 2048 in sender blocks, k = 5000 read in place); and the
     Eq.-2 pair and sparse kernels at phase 17's call, one live row
     (1, 1024, 151,936) against J = 2 received, the pair kernels at
     phase 21's, against J = 3, and at phase 22's, Kl = 2 against the
     gathered J = 4 with zero self weights (K = 3 adds a pad column of
     zero weight; K = 4 weights every column, and there the pair kernels'
     rows are timed); and the fused AdamW (norm pass and multi-tensor
     update) at phase 4's tree, one step against the plain version, timed
     beside its bound, the plain version and ``torch._fused_adamw_``;
  3. the serving path at the full width and depth of qwen3-4b: a K=2
     client ensemble from seeded random weights serves ``generate``, continuous batching
     and route mode, and the flash kernel's launch count shows that it ran
     through it; the first token's and a decode step's device busy time
     against their wall time;
  4. the training path at the full width of qwen3-4b cut to 4 of its 36
     layers: ``Federation(LMClients(..., n_clients=3), DML())`` trains 3
     fused DML rounds through the kernels (launch counts checked: each
     round's Eq.-2 term through the square forward and backward),
     reads out Eq. 2 of the final public logits through ``mutual_kl``, and
     round 1 and each client's gradient are held against the same round at
     ``impl="ref"``;
  5. phase 3 for K=2 full-width mamba2-780m clients at 6 of its 48
     layers (for time) on 1024-token prompts, through the SSD forward
     kernel;
  6. phase 4 for K=3 full-width mamba2-780m clients at 3 of its 48
     layers (for time), seq 1024 (18,432 trained tokens a round), through
     the SSD
     forward and backward kernels and the square pair-KL kernels;
  7. phase 4 with ``SparseDML(k=64)``: each client shares the top-64
     (index, log-prob) sets of its public logits, and the Eq.-2 term runs
     through the sparse-KL forward and backward kernels (no pair-KL
     launch); round 1 and each client's gradient are held against
     ``impl="ref"`` as in phase 4;
  8. the weight-sharing baselines on phase 4's population: 2 rounds of
     ``FedAvg()`` (every leaf identical across clients after each) and 3 of
     ``AsyncWeights(delta=2, min_round=1)`` (shallow, deep, shallow: the
     scheduled group synced, the other not), comm bytes against the
     analytic value, through the flash kernels' local steps;
  9. the paper's VisionNet case study at full width (100x100x3, convs
     32/64/128, dense 64; K = 5 clients on ``make_paper_datasets`` at the
     paper's sizes, 3,833 train and 5,988 unseen test images): DML round 1
     without dropout on the card (deterministic cuDNN) against the same
     round on the CPU (params within relative norm error 1e-3, losses
     1e-4), then 12 rounds each of
     ``DML()``, ``FedAvg()`` and ``AsyncWeights(delta=3, min_round=5)``
     with dropout and ``evaluate`` on the unseen set: comm bytes analytic,
     FedAvg and async syncs as scheduled, round wall, trained images/s,
     one profiled DML round's device idle share, peak memory and the
     Table-II analogue.  No kernel of this repo lies on this path (cuDNN
     convolutions and cuBLAS matmuls in fp32, TF32 off): every launch
     count must stay 0.
  10. phase 3 for K=2 clients of qwen2-moe-a2.7b at full width (d 2048,
     16 heads of 128 with QKV bias, 60 experts top-4 of width 1408 and 4
     shared, vocab 151,936), 6 of its 24 layers (for time; at
     24 layers 14.32 B params a client, 57.3 GB for two in bf16), through
     the flash forward; its MoE FFNs route in
     groups of min(256, S) tokens that must tile a prompt, so every prompt
     is at most 256 tokens or a multiple of 256, as the JAX engine's
     prefill at the request's own length requires; a decode step runs all
     60 experts of every layer (capacity buffers of one slot); the prefill
     parity on a copy of the first 4 layers of both clients (an fp32 copy
     of the whole would be 114 GB), with the tokens per layer whose kept
     experts differ between the two impls;
  11. phase 4 for K=3 qwen2-moe-a2.7b clients at full width, cut to 1 of
     24 layers (3.58 B params a client with the embedding and head; 2
     layers would need ~90 GB), through the flash pair and the square
     Eq.-2 pair, with each client's load_balance and router_z;
  12. phase 3 for K=2 dbrx-132b clients at full width (d 6144, 48/8 heads,
     16 experts top-4 of width 10,752, vocab 100,352) cut to 4 of 40
     layers (57 GB in bf16): the flash forward at GQA 6:1, the expert
     products at their widest; the prefill parity on a copy of the first
     layer of both clients;
  13. phase 3 for K=2 llava-next-mistral-7b clients at full width (d 4096,
     32/8 heads of 128, d_ff 14,336, vocab 32,000), 4 of its 32 layers
     (for time; at 32 layers 7.24 B params a client, 29 GB for
     two): each prompt of 1536 tokens
     stands behind its own 2880-position image prefix of dim 1024 (seeded
     N(0, 1), through the projector), so P + S = 4416 is past the 4096
     window: the flash forward runs windowed and decode wraps the 4096-key
     ring; 6 mixed requests each with its own prefix, and route mode; the
     prefill parity on a copy of the first 4 layers of both clients (an
     fp32 copy of the whole would be 58 GB, and the plain attention holds
     ~10 GB of fp32 scores a layer), with qwen3-4b's bf16 limit;
  14. phase 4 for K=3 llava-next-mistral-7b clients at full width cut to 4
     of 32 layers (1.14 B params a client; 8 would need ~72 GB before
     activations), batch 4, public 2, seq 1280 behind the prefixes
     ``LMClients`` draws: P + S = 4160 > 4096, so the window bites in the
     flash backward too; 23,040 trained text tokens a round in 74,880
     positions; round 1 is held against ``impl="ref"`` on a copy from the
     same seed cut to 1 layer, K = 2, batch 1 (public 1), the window
     still biting: the plain attention's fp32 scores for the population's
     18 sequences would be ~40 GB a layer;
  15. phase 3 for K=2 musicgen-medium clients at full width (d 1536, 24/24
     heads of 64, vocab 2048), 3 of its 48 layers (for time),
     behind a 64-position conditioning prefix of dim 768; the prefill
     parity on the whole population;
  16. phase 4 for K=3 musicgen-medium clients at full width, 3 of its 48
     layers (for time), batch 4, public 2,
     seq 512, round 1
     and the gradients held on the whole population;
  17. a mixed-architecture federation at full width,
     ``Federation(HeteroClients(...), strategy)`` of qwen3-4b (2 of 36
     layers, for time), qwen2-moe-a2.7b (1 of 24) and qwen3-8b
     (2 of 36), one vocabulary (151,936), ~40 GB of params and AdamW
     moments with a 4-layer qwen3-4b (less at 2): folds of 8 sequences of 512 (2
     local steps of batch 4 a client), public 2; 3
     rounds of ``DML()`` (each client's Eq. 2 against the 2 received
     logits through the pair kernels: M launches each way a round, no
     square kernel), one at participation 2 (the absent client's params
     and moments bitwise untouched) and 2 of ``SparseDML(k=64)`` (the
     sparse kernels at Kl = 1, no pair-KL kernel); comm bytes analytic;
     round 1 of DML and of SparseDML from fresh fleets against impl
     "ref", and each client's gradient by the parity rule;
  18. the training CLI's default fleet (qwen3-4b, mamba2-780m, dbrx-132b)
     at its reduced configs in fp32, 2 DML rounds through the flash, SSD
     and pair kernels against impl "ref", FedAvg refused on it; then 2
     FedAvg and 3 AsyncWeights(delta=2, min_round=1) rounds of a
     one-arch fleet of three 4-layer full-width qwen3-4b clients;
  19. single-model training of full-width, full-depth qwen3-4b (4.41 B
     params) through ``launch.steps.make_train_step``, 3 steps of 4 x
     512, step 1's loss and gradient first against impl "ref" by the
     parity rule; then ``make_multistep_decode``'s greedy tokens against
     ``greedy_generate``'s over 32 new tokens;
  20. privacy and robustness on phase 9's VisionNet protocol: round 1 of
     ``DPDML(1)`` card against CPU (the same noise on both sides) within
     1e-3; 12 rounds of DP-DML with the payload tap (epsilon after each
     round against the accountant's closed form); 12 rounds each of DML,
     DML with client 4 colluding, ``TrimmedDML(trim=1)`` and
     ``MedianDML()`` with the colluder (round wall, the honest clients'
     unseen-set accuracy); the JAX suite's robust and leakage experiments
     at its sizes through the port (directions asserted, its margins
     printed); no kernel launch;
  21. a mixed fleet of four at full width (phase 17's three and a second
     qwen3-4b, ~52 GB with 4-layer qwen3-4b clients), client 3
     sign-flipping: 3 rounds of
     ``DPDML(1)`` (the pair kernels against the noised stack, J = 3: 4
     launches each way a round; the third profiled), 2 of
     ``TrimmedDML(trim=1)`` and 1 of ``MedianDML()`` (no Eq.-2 kernel);
     comm bytes DML's, epsilon the closed form; round 1 of DP-DML and of
     TrimmedDML and each client's gradient against impl "ref";
  21b. the reduced fleet of four (qwen3-4b, mamba2-780m, qwen3-4b,
     dbrx-132b), fp32, 2 rounds each of DP-DML and MedianDML through the
     flash, SSD and pair kernels against impl "ref";
  22. the client mesh: ``Federation(LMClients(..., mesh=ClientMesh((cuda:0,
     cuda:0))), DML())`` of full-width qwen3-4b at 2 of 36 layers, K = 4
     and K = 3 (a dummy slot), 3 rounds each through the flash and pair
     kernels (2 pair launches each way a round, no square kernel); an
     update with a client absent keeps its slot and the dummy's bits;
     round 1 against the sharded step at impl "ref" and, through the
     whole update at clip_norm=None, against the unsharded
     ``make_dml_train_step``;
  23. phase 9's VisionNet protocol over two entries of the card: 2 rounds
     each of DML, FedAvg and async against the unsharded engine from the
     same state, and each weight sync alone bit for bit;
  24. the dry-run against the card: phase 4's round counted on the meta
     device (``launch.dryrun.count``) and run on the card at impl "ref"
     under ``FlopCounterMode`` (the FLOP counts agree to 1e-6; the
     dry-run's peak bytes within 0.8-1.25x of the card's
     ``max_memory_allocated``); then ``launch.quickstart`` and
     ``launch.serve_lm`` on the card (the flash, square Eq.-2 and SSD
     kernels launched).
  25. the data x model mesh (``sharding.use_mesh``, DTensor programs):
     four ranks as a (data 2, model 2) and a (pod 2, data 1, model 2)
     DeviceMesh, sharing the card over gloo (which collectives gloo takes
     on CUDA tensors is checked and printed; the functional ones DTensor
     calls run card to card through CUDA IPC,
     ``_shared_card_collectives``), or a card each over NCCL with
     ``--cards 4``; params drawn from seed 0 and
     kept as shards by their logical axes; full-width qwen3-4b at 2
     layers: 2 ``make_train_step`` steps, one fused DML round (K = 2) and
     one SparseDML round (k = 64, the vocab-sharded top-k); M1 full-width
     qwen2-moe-a2.7b at 1 layer in fp32 (TF32 off), a train step (the MoE
     FFN on each rank's shards, the experts split over model); M2 the same
     in bf16, a DML round; M3 full-width mamba2-780m at 2 layers, a train
     step (the SSD scan on each rank's (batch, heads) shard); M4 the
     qwen3-4b DML round with the clients on the pod axis (the rectangular
     pair kernels, one live client against both); all at impl "cuda",
     each held against the same program run unsharded on the card by
     rank 0: metrics within relative 2e-2, and (but M2) leaf by leaf each
     update (after - before) and first moment within ``DM_UPDATE_LIMIT``
     and ``DM_MU_LIMIT``, limits that the same program on half of every
     batch (the control) must exceed on every leaf; the shards reach rank
     0 through CUDA IPC; per-rank peak memory, the walls,
     ``CommDebugMode``'s collective counts, the bytes by mesh dim, M1's
     and M2's route flips printed; the pair kernels and the SSD scan
     timed at the local shapes M4 and M3 gave them; then the
     ``pod``-mesh dry-run (data 16 x model 16, the fake process group) of
     phase 4's round and phase 19's step in a subprocess, their per-card
     counts printed;
  26. the legacy facades and the top-level surface, as a user calls them
     (``repro_torch.Federation``, ``repro_torch.VisionClients`` ...,
     ``device=None``, impl "cuda"): ``core.federated.FederatedTrainer`` at
     phase 9's sizes, 2 rounds each of dml, fedavg and async, bit for bit
     against ``Federation(VisionClients(...), cfg.strategy())`` (also on
     ``ClientMesh((cuda:0, cuda:0))``, and across a checkpoint restored
     into a fresh ``Federation``), ``evaluate`` on the unseen set;
     ``core.hetero.HeteroTrainer`` over phase 17's full-width fleet (2 DML
     rounds against phase 17's first two: comm bytes exact, losses within
     relative 1e-5; M pair launches each way a round) and with
     ``sparse_k=64`` (the sparse kernels only), then over
     ``HeteroConfig``'s default archs, reduced (2 DML rounds through the
     flash, SSD and pair kernels against phase 18's); ``resolve_impl``
     with ``REPRO_KERNEL_IMPL`` set (explicit > the variable > the
     device).  The script refuses to start with ``REPRO_KERNEL_IMPL`` set
     to anything but "cuda".
With ``--cards N`` only phases 22 (K = 4), 23 and 25 run, over N distinct
cards.
jamba-1.5-large-398b does not run on the card: one full-width period (8
layers, 4 MoE FFNs of 16 experts of width 24,576) holds ~44 B params, 88
GB a client in bf16, and no depth cut goes below a period; the CPU tests
hold it against the JAX package at its reduced config.
Phases 3-7, 10-17, 19 and 21 hold the prefill logits and the per-client
gradients to the plain path by one parity rule (``_parity``): in fp32 on
the same weights, and in bf16 against the bf16 plain path's own distance
from fp32.
Each path's launch counts are set to 0 just before it and read just after.
The line before the last is one JSON object with the per-kernel numbers;
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device
it exits non-zero and prints no result.  It imports nothing of JAX.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# fails here, before anything runs, without the port beside this file
from repro_torch.kernels import _build  # noqa: E402

from repro_torch.launch.mesh import H100  # noqa: E402

# the H100 SXM's published dense peaks, from their one source: bf16 tensor
# cores, fp32 without them, and HBM3 bandwidth; TFLOP/s and TB/s for the
# printed rates
PEAK_FLOPS = {torch.bfloat16: H100.peak_flops_bf16,
              torch.float32: H100.peak_flops_fp32}
PEAK_BYTES = H100.hbm_bandwidth
BF16_TFLOPS = H100.peak_flops_bf16 / 1e12
HBM_TBS = H100.hbm_bandwidth / 1e12
KERNEL_SOURCES = ("flash_attention_fwd", "flash_attention_bwd",
                  "kl_mutual_pair", "ssd_scan_fwd", "ssd_scan_bwd",
                  "sparse_kl", "adamw_fused")
BF16 = torch.bfloat16
# what phases 17 and 18 ran, kept for the phases that check it later
MEASURED: dict = {}
# the SSD sweep of phase 2: (H, P, N, G), sequence lengths, chunks
SSD_SWEEP = dict(heads=((48, 64, 128, 1), (8, 32, 16, 2), (4, 16, 8, 4)),
                 lengths=(1, 100, 256, 1000, 1024), chunks=(256, 64))


def check_cuda() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        raise SystemExit(1)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back runs."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 1

def ptxas_report(log: str) -> list:
    """(entry, registers, spill-store bytes) of each kernel in a library's
    ptxas report: each entry's spill line precedes its register line."""
    kernels, entry, spill = [], None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split()[-1])
        elif "Used " in line and "registers" in line:
            kernels.append((entry, int(line.split("Used ")[1].split()[0]),
                            spill))
            spill = 0
    return kernels


def print_tensor_core_sass(name: str) -> None:
    """The count of warpgroup (HGMMA) and warp (HMMA) tensor-core
    instructions in a library's SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    counts = {op: sum(f" {op}." in ln or f" {op} " in ln
                      for ln in sass.splitlines())
              for op in ("HGMMA", "HMMA")}
    print(f"  SASS of {name}: {counts['HGMMA']} HGMMA and {counts['HMMA']} "
          f"HMMA instructions")


def phase_env() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as ex:
        list(ex.map(_build.build, KERNEL_SOURCES))   # raises if one fails
    for name in KERNEL_SOURCES:
        _build.load(name)
        kernels = ptxas_report(
            _build.library_path(name).with_suffix(".log").read_text())
        regs = [r for _, r, _ in kernels]
        print(f"build {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
              f"registers, {sum(sp for _, _, sp in kernels)} bytes of spill "
              f"stores")
        if name.startswith("flash_attention"):
            # the bf16 tensor-core kernels, one line each
            for entry, r, sp in kernels:
                tc = re.search(r"(attn_\w+?_tc)ILi(\d+)E", entry)
                if tc:
                    print(f"  {tc[1]}<{tc[2]}>: {r} registers, {sp} bytes "
                          f"of spill stores")
            print_tensor_core_sass(name)
        if name.startswith("ssd_scan"):
            # the bf16 three-step kernels (namespace ssd_tc), one line each
            for entry, r, sp in kernels:
                tc = re.search(r"_ZN6ssd_tc(\d+)", entry)
                if tc:
                    start = tc.end()
                    kname = entry[start:start + int(tc[1])]
                    if "ILb1E" in entry[start:]:
                        kname += "<fwd>"
                    elif "ILb0E" in entry[start:]:
                        kname += "<bwd>"
                    print(f"  ssd_tc::{kname}: {r} registers, {sp} bytes "
                          f"of spill stores")
            print_tensor_core_sass(name)
    print(f"built {len(KERNEL_SOURCES)} libraries in parallel: "
          f"{time.perf_counter() - t0:.1f} s")
    return {"card": card}


# ---------------------------------------------------------------------------
# phase 2

def _qkv(B, S, Hq, Hkv, hd, dtype, gen):
    """q, k, v the way the serving path makes them: q and k fresh (qk-norm
    and RoPE write new tensors), v a strided slice of the fused QKV."""
    qkv = torch.randn(B, S, Hq + 2 * Hkv, hd, device="cuda", generator=gen,
                      dtype=torch.float32).to(dtype)
    q = qkv[:, :, :Hq].contiguous()
    k = qkv[:, :, Hq:Hq + Hkv].contiguous()
    v = qkv[:, :, Hq + Hkv:]
    return q, k, v


def causal_pairs(S: int, window=None) -> float:
    """Unmasked (query, key) pairs of causal self-attention over S
    positions: S(S+1)/2, and with a window w each query sees at most w
    keys (itself and the w - 1 before it)."""
    if window is None or window >= S:
        return S * (S + 1) / 2
    return window * (window + 1) / 2 + (S - window) * window


def attention_bound_ms(B, S, Hq, Hkv, hd, dtype, window=None) -> tuple:
    """The two lower bounds on causal self-attention over these inputs, in
    ms: 4*hd flops per unmasked (query, key) pair (``causal_pairs``) per
    sequence and head, at the peak rate for the dtype; and q, k, v read once
    and out, lse written once at HBM bandwidth."""
    flops = 4.0 * hd * B * Hq * causal_pairs(S, window)
    elt = torch.finfo(dtype).bits // 8
    nbytes = (2 * B * S * Hq * hd + 2 * B * S * Hkv * hd) * elt \
        + B * Hq * S * 4
    return flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3


# fp32 scores the plain attention may hold at once (it keeps about three
# tensors of them, five under autograd); longer inputs run it in batch
# slices, which give the same result: sequences are independent
REF_SCORES = 4e9


def _ref_rows(B, S, Hq) -> int:
    """Sequences per slice of the plain attention over (B, S, Hq)."""
    return max(1, min(B, int(REF_SCORES // (Hq * S * S * 4))))


def _ref_lse(ref, q, k, v, causal, window):
    """``ref.attention_lse`` over batch slices of ``_ref_rows``."""
    n = _ref_rows(*q.shape[:3])
    outs = [ref.attention_lse(q[i:i + n], k[i:i + n], v[i:i + n],
                              causal=causal, window=window)
            for i in range(0, q.shape[0], n)]
    return (torch.cat([o for o, _ in outs]), torch.cat([lse for _, lse in
                                                         outs]))


def _check(flash_attention, ref, q, k, v, causal, window, tol, what):
    """Kernel vs ``ref.attention_lse`` on the same inputs; raises outside
    the tolerance, else returns (max |out err|, max |lse err|)."""
    out, lse = flash_attention(q, k, v, causal=causal, window=window)
    want, want_lse = _ref_lse(ref, q, k, v, causal, window)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    err_lse = (lse - want_lse).abs().max().item()
    ok = torch.allclose(out.float(), want.float(), atol=tol["out"],
                        rtol=tol["rtol"]) and err_lse <= tol["lse"]
    if not ok:
        raise AssertionError(
            f"flash_attention disagrees with ref at {what}: max |out err| "
            f"{err:.3g}, max |lse err| {err_lse:.3g}")
    return err, err_lse


def phase_flash_fwd(main_shape, admit_batch, admit_lens,
                    train_shapes, more=(), timed=()) -> dict:
    """Flash forward against ``ref.attention_lse`` on the card: a sweep of
    heads, lengths, windows and dtypes, and every shape the serving run of
    phase 3 gives the kernel -- K*B sequences of the generate and route
    prompts (``main_shape``) and ``admit_batch`` = K sequences of each
    admitted request length (``admit_lens``), bf16, causal -- and the
    training run's (``train_shapes``: (batch, S) pairs); ``more`` the other
    paths' shapes as (batch, (Hq, Hkv, hd), S, window), bf16, causal.
    ``timed`` (batch, (Hq, Hkv, hd), S, window) are timed beside the
    serving shape: against a bound over the unmasked pairs only and SDPA
    with an explicit boolean mask where there is a window."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    tol = {torch.float32: dict(out=1e-4, rtol=0.0, lse=1e-4),
           torch.bfloat16: dict(out=2e-2, rtol=2e-2, lse=1e-3)}
    B, S0, Hq, Hkv, hd = main_shape
    bf16 = torch.bfloat16
    cases = [(2, heads, S, window, dtype, True)
             for heads in ((Hq, Hkv, hd), (8, 2, 64), (8, 2, 32))
             for S in (1, 17, 128, 1000, 2048)
             for window in (None, 256)
             for dtype in (torch.float32, bf16)]
    cases += [(2, (Hq, Hkv, hd), 1000, None, dtype, False)
              for dtype in (torch.float32, bf16)]
    path = [(B, (Hq, Hkv, hd), S0, None, bf16, True)]
    path += [(admit_batch, (Hq, Hkv, hd), S, None, bf16, True)
             for S in admit_lens]
    path += [(b, (Hq, Hkv, hd), S, None, bf16, True)
             for b, S in train_shapes]
    path += [(b, heads, S, w, bf16, True) for b, heads, S, w in more]
    worst = {}
    for b, (hq, hkv, d), S, window, dtype, causal in cases + path:
        q, k, v = _qkv(b, S, hq, hkv, d, dtype, gen)
        errs = _check(fa.flash_attention, ref, q, k, v, causal, window,
                      tol[dtype], f"B={b} Hq={hq} Hkv={hkv} hd={d} S={S} "
                      f"window={window} {dtype} causal={causal}")
        n, e, el = worst.get(dtype, (0, 0.0, 0.0))
        worst[dtype] = (n + 1, max(e, errs[0]), max(el, errs[1]))
        if (b, S, hq, hkv) == (B, S0, Hq, Hkv):
            max_err = errs[0]
    for dtype, (n, e, el) in worst.items():
        t = tol[dtype]
        print(f"flash_attention vs ref, {n} cases {str(dtype)[6:]}: max |out "
              f"err| {e:.3g} (atol {t['out']}, rtol {t['rtol']}), max |lse "
              f"err| {el:.3g} (limit {t['lse']})")
    print(f"  of them at the serving path's shapes: B={B} S={S0}, and "
          f"B={admit_batch} S in {list(admit_lens)}; at the training "
          f"path's: (B, S) in {list(train_shapes)}; at the other paths' "
          f"(B, (Hq, Hkv, hd), S, window): "
          f"{sorted(set(more), key=str)}")

    # time at the serving path's generate/route prefill shape, then at the
    # training path's shapes (16 launches a DML round there)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    G = Hq // Hkv
    for i, (b, S) in enumerate([(B, S0)] + list(train_shapes)):
        q, k, v = _qkv(b, S, Hq, Hkv, hd, bf16, gen)
        # through the paths' entry flash_attention() (the span of the
        # kernels line), and apart the launch function alone (allocation,
        # three TMA maps, the kernel) without the autograd wrapper's host
        # work
        t_ms = time_ms(lambda: fa.flash_attention(q, k, v))
        launch_ms = time_ms(lambda: fa._forward(q, k, v, True, None))
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(G, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(G, dim=2).transpose(1, 2)
        lib_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
        ops_ms, bytes_ms = attention_bound_ms(b, S, Hq, Hkv, hd, bf16)
        tflops = ops_ms * BF16_TFLOPS / t_ms      # causal flops / time, TFLOP/s
        line = (f"flash_attention at (B={b}, S={S}, Hq={Hq}, Hkv={Hkv}, "
                f"hd={hd}) bf16: {t_ms:.4f} ms ({tflops:.1f} TFLOP/s), "
                f"launch function _forward alone {launch_ms:.4f} ms "
                f"({ops_ms * BF16_TFLOPS / launch_ms:.1f} TFLOP/s), sdpa (library) "
                f"{lib_ms:.4f} ms ({ops_ms * BF16_TFLOPS / lib_ms:.1f} TFLOP/s)")
        if i == 0:
            ms, library_ms = t_ms, lib_ms
            plain_ms = time_ms(lambda: ref.attention_lse(q, k, v), iters=5)
            bound_ms, bound_by = max((ops_ms, "operations"),
                                     (bytes_ms, "bytes"))
            line += (f", plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms "
                     f"by {bound_by} (causal flops / {BF16_TFLOPS:.0f} "
                     f"TFLOP/s {ops_ms:.4f} ms, bytes / {HBM_TBS} TB/s "
                     f"{bytes_ms:.4f} "
                     f"ms); max |err| {max_err:.3g}")
        else:
            line += f"; bound {max(ops_ms, bytes_ms):.4f} ms"
        print(line)
    for b, heads, S, window in timed:
        _time_other_fwd(fa, b, heads, S, window, gen)
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:34",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def _sdpa_inputs(q, k, v, window):
    """q, k, v in SDPA's (B, H, S, hd) layout with the kv heads repeated,
    and the boolean mask of causal attention within ``window`` (None
    without a window: SDPA's own causal flag then)."""
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2)
    mask = None
    if window is not None:
        i = torch.arange(q.shape[1], device=q.device)
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
    return qt, kt, vt, mask


def _sdpa(qt, kt, vt, mask):
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if mask is None:
        return sdpa(qt, kt, vt, is_causal=True)
    return sdpa(qt, kt, vt, attn_mask=mask)


def sdpa_backend(fn) -> str:
    """The name of SDPA's kernel that ``fn()`` launches, from the profiler
    (``flash``, ``efficient``/``mem_eff``, ``cudnn`` or the math path)."""
    names = [n.lower() for n in device_busy(fn)]
    for key, name in (("cudnn", "CUDNN_ATTENTION"),
                      ("flash", "FLASH_ATTENTION"),
                      ("fmha", "EFFICIENT_ATTENTION"),
                      ("mem_eff", "EFFICIENT_ATTENTION"),
                      ("efficient", "EFFICIENT_ATTENTION")):
        if any(key in n for n in names):
            return name
    return "MATH"


def _time_other_fwd(fa, b, heads, S, window, gen) -> None:
    """The flash forward at another path's shape: its time through
    ``flash_attention()`` against the bound over the unmasked pairs, and
    SDPA's (with an explicit boolean mask where there is a window), its
    backend named."""
    Hq, Hkv, hd = heads
    q, k, v = _qkv(b, S, Hq, Hkv, hd, BF16, gen)
    t_ms = time_ms(lambda: fa.flash_attention(q, k, v, window=window))
    ins = _sdpa_inputs(q, k, v, window)
    lib_ms = time_ms(lambda: _sdpa(*ins), iters=5)
    backend = sdpa_backend(lambda: _sdpa(*ins))
    ops_ms, bytes_ms = attention_bound_ms(b, S, Hq, Hkv, hd, BF16, window)
    bound_ms, bound_by = max((ops_ms, "operations"), (bytes_ms, "bytes"))
    print(f"flash_attention at (B={b}, S={S}, Hq={Hq}, Hkv={Hkv}, hd={hd}, "
          f"window={window}) bf16: {t_ms:.4f} ms ({ops_ms * BF16_TFLOPS / t_ms:.1f} "
          f"TFLOP/s over the unmasked pairs); bound {bound_ms:.4f} ms by "
          f"{bound_by} ({causal_pairs(S, window):.0f} unmasked pairs a "
          f"head); sdpa {backend}"
          f"{' with a boolean mask' if window else ', is_causal'} "
          f"{lib_ms:.4f} ms")
    del q, k, v, ins
    torch.cuda.empty_cache()


def _bound(flops: float, nbytes: float, dtype) -> tuple:
    """(bound ms, "operations" or "bytes"): the larger of the operations at
    the card's peak rate for ``dtype`` and the bytes at its HBM rate."""
    return max((flops / PEAK_FLOPS[dtype] * 1e3, "operations"),
               (nbytes / PEAK_BYTES * 1e3, "bytes"))


def _grad_err(got, want, tol):
    """max |got - want| and whether it is within tol * max(max |want|, 1):
    the scale floor keeps gradients that are 0 up to rounding (S = 1, a
    window of one) from making the test one of rounding noise."""
    err = (got - want).abs().max().item()
    return err, err <= tol * max(want.abs().max().item(), 1.0)


def _flash_grads(fn, qkv, dout, Hq, Hkv, window, rows=None):
    """Gradient of sum(out * dout) with respect to a fused (B, S,
    Hq + 2 Hkv, hd) QKV, through ``fn(q, k, v)`` on its strided slices:
    the layout the training path hands the kernels; with ``rows``, over
    batch slices of that many sequences (the same gradient: sequences are
    independent)."""
    n = rows or qkv.shape[0]
    grads = []
    for i in range(0, qkv.shape[0], n):
        x = qkv[i:i + n].clone().requires_grad_(True)
        out = fn(x[:, :, :Hq], x[:, :, Hq:Hq + Hkv], x[:, :, Hq + Hkv:],
                 window=window)[0]
        grads.append(torch.autograd.grad(out, x, dout[i:i + n])[0].float())
    return torch.cat(grads)


def phase_flash_bwd(train_shape, train_shapes, more=(), timed=()) -> dict:
    """Flash backward (dq, dk, dv) against autograd of ``ref.attention_lse``
    on the card: a sweep of heads, lengths, windows and dtypes, and every
    shape the training run of phase 4 gives it (``train_shapes``: (batch,
    S) pairs at the full width, bf16, causal), and ``more`` (batch, (Hq,
    Hkv, hd), S, window) of the other training paths; ``timed`` of these
    are timed beside the row's shape.  Tolerance: max |err| <=
    tol * max(max |grad|, 1) for each of dq, dk, dv, tol 1e-4 in fp32
    (summation order) and 2e-2 in bf16 (the gradients are rounded to bf16
    once, and the plain version differentiates its fp32 softmax while the
    kernel's delta uses the bf16 out)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(1)
    tol = {torch.float32: 1e-4, BF16: 2e-2}
    B0, S0, Hq, Hkv, hd = train_shape
    cases = [(2, heads, S, window, dtype)
             for heads in ((Hq, Hkv, hd), (8, 2, 64), (8, 2, 32))
             for S in (1, 17, 128, 1000)
             for window in (None, 256)
             for dtype in (torch.float32, BF16)]
    cases += [(b, (Hq, Hkv, hd), S, None, BF16) for b, S in train_shapes]
    cases += [(b, heads, S, w, BF16) for b, heads, S, w in more]
    worst, max_err = {}, None
    for b, (hq, hkv, d), S, window, dtype in cases:
        qkv = torch.randn(b, S, hq + 2 * hkv, d, device="cuda",
                          generator=gen).to(dtype)
        dout = torch.randn(b, S, hq, d, device="cuda",
                           generator=gen).to(dtype)
        got = _flash_grads(fa.flash_attention, qkv, dout, hq, hkv, window)
        want = _flash_grads(ref.attention_lse, qkv, dout, hq, hkv, window,
                            _ref_rows(b, S, hq) // 2 or 1)
        errs = []
        for sl in (slice(0, hq), slice(hq, hq + hkv), slice(hq + hkv, None)):
            err, ok = _grad_err(got[:, :, sl], want[:, :, sl], tol[dtype])
            if not ok:
                raise AssertionError(
                    f"flash backward disagrees with autograd of ref at B={b} "
                    f"Hq={hq} Hkv={hkv} hd={d} S={S} window={window} {dtype}:"
                    f" max |err| {err:.3g} in the grad of qkv[..., {sl}]")
            errs.append(err)
        n, e = worst.get(dtype, (0, 0.0))
        worst[dtype] = (n + 1, max(e, *errs))
        if (b, S, hq, hkv) == (B0, S0, Hq, Hkv):
            max_err = max(errs)
    for dtype, (n, e) in worst.items():
        print(f"flash backward vs autograd of ref, {n} cases "
              f"{str(dtype)[6:]}: max |dq, dk, dv err| {e:.3g} (limit "
              f"{tol[dtype]} x max(max |grad|, 1))")

    # time at the training path's private-batch shape
    q, k, v = _qkv(B0, S0, Hq, Hkv, hd, BF16, gen)
    out, lse = fa._forward(q, k, v, True, None)
    dout = torch.randn(out.shape, device="cuda", generator=gen).to(BF16)
    ms = time_ms(lambda: fa._backward(q, k, v, out, lse, dout, True, None))
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]

    def plain_fb():
        torch.autograd.grad(ref.attention_lse(*leaves)[0], leaves, dout)

    def plain_f():
        with torch.no_grad():
            ref.attention_lse(*leaves)
    plain_ms = time_ms(plain_fb, iters=5) - time_ms(plain_f, iters=5)
    G = Hq // Hkv
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = [q.transpose(1, 2), k.repeat_interleave(G, dim=2).transpose(1, 2),
           v.repeat_interleave(G, dim=2).transpose(1, 2)]
    lib = [t.detach().requires_grad_(True) for t in lib]
    dout_t = dout.transpose(1, 2)

    def lib_fb():
        torch.autograd.grad(sdpa(*lib, is_causal=True), lib, dout_t)

    def lib_f():
        with torch.no_grad():
            sdpa(*lib, is_causal=True)
    library_ms = time_ms(lib_fb) - time_ms(lib_f)
    bound_ms, bound_by = _bwd_bound(B0, S0, Hq, Hkv, hd, None)
    tflops = 10.0 * hd * B0 * Hq * causal_pairs(S0) / ms / 1e9  # TFLOP/s
    print(f"flash backward at (B={B0}, S={S0}, Hq={Hq}, Hkv={Hkv}, hd={hd}) "
          f"bf16: {ms:.4f} ms ({tflops:.1f} TFLOP/s), plain (autograd of "
          f"ref, fwd+bwd - fwd) {plain_ms:.4f} ms, sdpa (library, fwd+bwd "
          f"- fwd) {library_ms:.4f} ms ({tflops * ms / library_ms:.1f} "
          f"TFLOP/s); bound {bound_ms:.4f} ms by {bound_by} "
          f"(10 hd flops per unmasked pair / {BF16_TFLOPS:.0f} TFLOP/s; q, "
          f"k, v, out, dout, lse read and dq, dk, dv written / {HBM_TBS} "
          f"TB/s); max |err| "
          f"{max_err:.3g}")
    del q, k, v, out, lse, dout, leaves, lib
    for b, heads, S, window in timed:
        _time_other_bwd(fa, b, heads, S, window, gen)
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:145",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def _bwd_bound(B, S, Hq, Hkv, hd, window) -> tuple:
    """The flash backward's bound: 10 hd flops per unmasked pair at the
    bf16 peak; q, k, v, out, dout, lse read and dq, dk, dv written."""
    nbytes = (4 * B * S * Hq * hd + 4 * B * S * Hkv * hd) * 2 \
        + B * Hq * S * 4
    return _bound(10.0 * hd * B * Hq * causal_pairs(S, window), nbytes, BF16)


def _time_other_bwd(fa, b, heads, S, window, gen) -> None:
    """The flash backward's launch function at another path's shape
    against ``_bwd_bound`` over the unmasked pairs, and SDPA's backward
    (fwd+bwd - fwd, with an explicit boolean mask where there is a
    window), its backend named."""
    Hq, Hkv, hd = heads
    q, k, v = _qkv(b, S, Hq, Hkv, hd, BF16, gen)
    out, lse = fa._forward(q, k, v, True, window)
    dout = torch.randn(out.shape, device="cuda", generator=gen).to(BF16)
    ms = time_ms(lambda: fa._backward(q, k, v, out, lse, dout, True, window),
                 iters=5)
    *lib, mask = _sdpa_inputs(q, k, v, window)
    lib = [t.detach().requires_grad_(True) for t in lib]
    dout_t = dout.transpose(1, 2)

    def lib_fb():
        torch.autograd.grad(_sdpa(*lib, mask), lib, dout_t)

    def lib_f():
        with torch.no_grad():
            _sdpa(*lib, mask)
    lib_ms = time_ms(lib_fb, iters=5) - time_ms(lib_f, iters=5)
    backend = sdpa_backend(lib_fb)
    bound_ms, bound_by = _bwd_bound(b, S, Hq, Hkv, hd, window)
    flops = 10.0 * hd * b * Hq * causal_pairs(S, window)
    print(f"flash backward at (B={b}, S={S}, Hq={Hq}, Hkv={Hkv}, hd={hd}, "
          f"window={window}) bf16: {ms:.4f} ms ({flops / ms / 1e9:.1f} "
          f"TFLOP/s over the unmasked pairs); bound {bound_ms:.4f} ms by "
          f"{bound_by}; sdpa {backend} backward"
          f"{' with a boolean mask' if window else ', is_causal'} "
          f"(fwd+bwd - fwd) {lib_ms:.4f} ms")
    del q, k, v, out, lse, dout, lib, mask
    torch.cuda.empty_cache()


def _kl_ops(Kl, Kg, B, V, square: bool = False) -> float:
    """fp32 operations of the pair-KL forward: per (b, v) two per (i, j)
    cross term and about four (max, exp, sum) per client on each side; the
    square case has K (K - 1) cross terms and one side."""
    if square:
        return float(B) * V * (2 * Kl * (Kl - 1) + 4 * Kl)
    return float(B) * V * (2 * Kl * Kg + 4 * (Kl + Kg))


def _kl_bwd_ops(Kl, Kg, B, V, square: bool = False) -> float:
    """fp32 operations of the pair-KL backward (dlive only): per (b, v) and
    live client two for the exponential (FMA, EX2), two per weighted term
    (one FMA: K (K - 1) in the square case, Kl Kg in the pair) and the
    x term, and two multiplies."""
    terms = Kl * (Kl - 1) if square else Kl * Kg
    return float(B) * V * (2 * terms + 6 * Kl)


def _kl_counts(kl_mutual) -> tuple:
    """The pair-KL launch counters by kernel: square and pair forward,
    square and pair backward."""
    return (kl_mutual.square_launches, kl_mutual.pair_launches,
            kl_mutual.square_bwd_launches, kl_mutual.pair_bwd_launches)


def _pair_kernel_on_one(x, w, T: float):
    """The pair forward's C entry with live = fixed = ``x`` (the wrapper
    sends that call to the square kernel); uncounted.  Returns out."""
    from repro_torch.kernels import kl_mutual
    K, B, V = x.shape
    out = torch.empty((K, B), dtype=torch.float32, device=x.device)
    lse = torch.empty((2, K, B), dtype=torch.float32, device=x.device)
    rc = kl_mutual._lib().kl_mutual_pair_fwd(
        x.data_ptr(), x.data_ptr(), w.data_ptr(), out.data_ptr(),
        lse[0].data_ptr(), lse[1].data_ptr(), x.stride(0), x.stride(1),
        x.stride(0), x.stride(1), K, K, B, V, 1.0 / T, int(x.dtype == BF16),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kl_mutual_pair_fwd failed with CUDA error {rc}")
    return out


def phase_kl(K: int, B: int, V: int) -> list:
    """The Eq.-2 kernels at the DML round's shape (K clients, B = the
    public batch's positions, the full vocabulary V), bf16 and fp32, with
    participation-masked weights (M = K - 1 < K), temperature 1.5 and V not
    a multiple of the kernels' tile.  Each forward against
    ``ref.mutual_kl_pair`` (max |err| <= 1e-3 + 1e-4 |out|: a one-pass
    streaming sum against a two-pass softmax over 151,936 terms), and the
    backward after it against autograd of it (relative norm error 1e-4 in
    fp32, 2e-2 in bf16, where the gradient is rounded to bf16 once): the
    square kernels as the DML round calls them (fixed = live.detach(), the
    live side's gradient), and the pair kernels on distinct live and fixed
    (fixed = the clients rolled, materialised; both sides' gradients in
    fp32); each call must launch its own forward and backward kernel and
    no other.  Then ``ops.mutual_kl`` (the square kernel with w = (1 - I) /
    (K - 1)) against ``ref.mutual_kl``, and the bf16 times beside the
    bound of what each call reads and writes: the square forward as
    training and as the readout call it (one (K, B, V) plane read), the
    pair forward (two), the pair forward's C entry on one tensor passed as
    both (one: the call the square kernel takes over; its result held
    against ``ref`` too), the square backward as training calls it (one
    plane read, one written) and the pair backward on distinct tensors
    (two read, one written), each over 20 calls after 3 warm-ups (the
    rows' window) and 50 after 10, beside one read of the plane
    (``torch.amax``) and one read and one write (``torch.mul``): the
    library's floors.  Returns the five kernels' rows."""
    from repro_torch.core.mutual import _pair_mask
    from repro_torch.kernels import kl_mutual, ops, ref
    gen = torch.Generator(device="cuda").manual_seed(2)
    w = _pair_mask(K, [1.0] * (K - 1) + [0.0], "cuda")
    T = 1.5
    errs = {}
    for dtype in (torch.float32, BF16):
        logits = (2 * torch.randn(K, B, V, device="cuda", generator=gen)) \
            .to(dtype)
        gbar = torch.randn(K, B, device="cuda", generator=gen)
        for kernel in ("square", "pair"):
            fixed = logits.roll(1, dims=0) if kernel == "pair" else None
            both = kernel == "pair" and dtype == torch.float32
            res = []
            for fn in (kl_mutual.kl_mutual_pair, ref.mutual_kl_pair):
                a = logits.detach().requires_grad_(True)
                b = a.detach() if fixed is None else \
                    fixed.detach().requires_grad_(both)
                before = _kl_counts(kl_mutual)
                out = fn(a, b, w, temperature=T)
                grads = torch.autograd.grad(out, (a, b) if both else (a,),
                                            gbar)
                ran = tuple(n - m for n, m in zip(_kl_counts(kl_mutual),
                                                  before))
                res.append((out.detach(), [g.float() for g in grads], ran))
                del a, b, out, grads
            (out, gs, ran), (want, wgs, _) = res
            f_err = (out - want).abs().max().item()
            b_rel = max(((g - x).norm() / x.norm()).item()
                        for g, x in zip(gs, wgs))
            b_err = max((g - x).abs().max().item() for g, x in zip(gs, wgs))
            lim = 1e-4 if dtype == torch.float32 else 2e-2
            if not (torch.allclose(out, want, atol=1e-3, rtol=1e-4)
                    and b_rel <= lim
                    and ran == ((1, 0, 1, 0) if kernel == "square"
                                else (0, 1, 0, 1))):
                raise AssertionError(
                    f"{kernel} KL disagrees with ref at {dtype}: forward max "
                    f"|err| {f_err:.3g}, backward relative error "
                    f"{b_rel:.3g}; (square, pair) forward and (square, "
                    f"pair) backward kernels launched {ran}")
            print(f"{kernel} KL vs ref at (K={K}, B={B}, V={V}) "
                  f"{str(dtype)[6:]}, M={K - 1} of {K}, T={T}: forward max "
                  f"|err| {f_err:.3g} (limit 1e-3 + 1e-4 |out|), backward "
                  f"({'dlive, dfixed' if both else 'dlive'}) max |err| "
                  f"{b_err:.3g}, relative {b_rel:.3g} (limit {lim})")
            errs[dtype, kernel] = (f_err, b_err)
            del res, out, gs, want, wgs, fixed
            torch.cuda.empty_cache()
        del logits
        torch.cuda.empty_cache()

    # the readout, and the times, at the DML round's shape in bf16
    x = (2 * torch.randn(K, B, V, device="cuda", generator=gen)).to(BF16)
    got = ops.mutual_kl(x, temperature=T, impl="cuda")
    want = ref.mutual_kl(x, T)
    mk_err = (got - want).abs().max().item()
    if not torch.allclose(got, want, atol=1e-3, rtol=1e-4):
        raise AssertionError(f"mutual_kl disagrees with ref: {mk_err:.3g}")
    print(f"mutual_kl (the square kernel) vs ref at (K={K}, B={B}, V={V}) "
          f"bf16: max |err| {mk_err:.3g}")
    y = x.roll(1, dims=0)                 # distinct storage for the pair
    gbar = torch.randn(K, B, device="cuda", generator=gen)
    out, zl, _, _ = kl_mutual._forward(x, x.detach(), w, T)
    out_p, zl_p, zf_p, _ = kl_mutual._forward(x, y, w, T)
    # the pair kernel on x passed as live and fixed: what the square
    # kernel saves the DML round's call
    want = ref.mutual_kl_pair(x, x.detach(), w, T)
    one_err = max((got - want).abs().max().item()
                  for got in (out, _pair_kernel_on_one(x, w, T)))
    if one_err > 1e-3 + 1e-4 * want.abs().max().item():
        raise AssertionError(f"square or pair kernel on (x, x) disagrees "
                             f"with ref: {one_err:.3g}")
    del want
    timed = {
        "sq": lambda: kl_mutual._forward(x, x.detach(), w, T),
        "mk": lambda: kl_mutual.kl_mutual(x, temperature=T),
        "pr": lambda: kl_mutual._forward(x, y, w, T),
        "pr1": lambda: _pair_kernel_on_one(x, w, T),
        "bwd": lambda: kl_mutual._backward(x, x, w, out, zl, zl, gbar, T,
                                           False),
        "bwd2": lambda: kl_mutual._backward(x, y, w, out_p, zl_p, zf_p, gbar,
                                            T, False),
        # what one read of the logits costs a library kernel (the
        # forwards' attainable floor on this card), and one read and one
        # write of the plane (the square backward's)
        "read": lambda: torch.amax(x, dim=-1),
        "rw": lambda: torch.mul(x, 2.0, out=scratch)}
    scratch = torch.empty_like(x)
    for key, name in (("bwd", kl_mutual.SQUARE_BWD),
                      ("bwd2", kl_mutual.PAIR_BWD)):
        if timed[key]()[2] != name:
            raise AssertionError(f"the {key} call left {name}")
    # every row on the window of the other kernels' rows (20 calls after
    # 3), and beside it 50 after 10
    ms = {k: time_ms(fn) for k, fn in timed.items()}
    ms50 = {k: time_ms(fn, iters=50, warmup=10) for k, fn in timed.items()}
    sq_ms, mk_ms, pr_ms, bwd_ms = ms["sq"], ms["mk"], ms["pr"], ms["bwd"]
    live = x.detach().requires_grad_(True)

    def plain_fb():
        torch.autograd.grad(ref.mutual_kl_pair(live, live.detach(), w, T),
                            live, gbar)

    def plain_f(fixed):
        with torch.no_grad():
            ref.mutual_kl_pair(live, fixed, w, T)
    def plain_fb2():
        torch.autograd.grad(ref.mutual_kl_pair(live, y, w, T), live, gbar)
    plain_sq = time_ms(lambda: plain_f(live.detach()), iters=5)
    plain_pr = time_ms(lambda: plain_f(y), iters=5)
    plain_bwd = time_ms(plain_fb, iters=5) - plain_sq
    plain_bwd2 = time_ms(plain_fb2, iters=5) - plain_pr
    plain_mk = time_ms(lambda: ref.mutual_kl(x, T), iters=5)
    plane = K * B * V * 2                       # one (K, B, V) bf16 tensor
    ops_sq = _kl_ops(K, K, B, V, square=True)
    sq_bound = _bound(ops_sq, plane, torch.float32)
    pr_bound = _bound(_kl_ops(K, K, B, V), 2 * plane, torch.float32)
    bwd_bound = _bound(_kl_bwd_ops(K, K, B, V, square=True), 2 * plane,
                       torch.float32)
    bwd2_bound = _bound(_kl_bwd_ops(K, K, B, V), 3 * plane, torch.float32)
    for name, key, plain, (bound, by) in (
            ("square forward (x, x.detach())", "sq", plain_sq, sq_bound),
            ("square forward (mutual_kl)", "mk", plain_mk, sq_bound),
            ("pair forward (x, x rolled)", "pr", plain_pr, pr_bound),
            ("pair forward on one tensor (x, x)", "pr1", plain_sq, sq_bound),
            ("square backward (x, x.detach())", "bwd", plain_bwd, bwd_bound),
            ("pair backward (x, x rolled)", "bwd2", plain_bwd2, bwd2_bound)):
        print(f"KL {name} at (K={K}, B={B}, V={V}) bf16: {ms[key]:.4f} ms "
              f"(50 calls after 10: {ms50[key]:.4f}), plain {plain:.4f} ms, "
              f"no single library call; bound {bound:.4f} ms by {by} "
              f"({bound / ms[key]:.0%} of it)")
    print(f"library floors at (K={K}, B={B}, V={V}) bf16: one read by "
          f"torch.amax {ms['read']:.4f} ms (50 calls after 10: "
          f"{ms50['read']:.4f}; {sq_bound[0] / ms['read']:.0%} of the square "
          f"forward's byte bound), one read and one write by torch.mul "
          f"{ms['rw']:.4f} ms (50 calls after 10: {ms50['rw']:.4f}; "
          f"{bwd_bound[0] / ms['rw']:.0%} of the square backward's byte "
          f"bound)")
    del x, y, live, out, out_p, scratch
    torch.cuda.empty_cache()
    src = "src/repro_torch/kernels/csrc/kl_mutual_pair.cu"
    row = dict(route="cuda", source=src, launches=None, library_ms=None)
    return [
        {"name": "kl_mutual_pair_fwd", **row,
         "replaces": "src/repro/kernels/kl_mutual.py:68",
         "max_abs_err": errs[BF16, "pair"][0], "ms": pr_ms,
         "plain_ms": plain_pr, "bound_ms": pr_bound[0],
         "bound_by": pr_bound[1]},
        {"name": "kl_mutual_square_fwd", **row,
         "replaces": "src/repro/kernels/kl_mutual.py:32",
         "max_abs_err": errs[BF16, "square"][0], "ms": sq_ms,
         "plain_ms": plain_sq, "bound_ms": sq_bound[0],
         "bound_by": sq_bound[1]},
        {"name": "kl_mutual_square_bwd", **row,
         "replaces": "src/repro/kernels/kl_mutual.py:178",
         "max_abs_err": errs[BF16, "square"][1], "ms": bwd_ms,
         "plain_ms": plain_bwd, "bound_ms": bwd_bound[0],
         "bound_by": bwd_bound[1]},
        {"name": "kl_mutual_pair_bwd", **row,
         "replaces": "src/repro/kernels/kl_mutual.py:178",
         "max_abs_err": errs[BF16, "pair"][1], "ms": ms["bwd2"],
         "plain_ms": plain_bwd2, "bound_ms": bwd2_bound[0],
         "bound_by": bwd2_bound[1]},
        {"name": "mutual_kl", **row,
         "replaces": "src/repro/kernels/kl_mutual.py:32",
         "max_abs_err": mk_err, "ms": mk_ms, "plain_ms": plain_mk,
         "bound_ms": sq_bound[0], "bound_by": sq_bound[1]},
    ]


def phase_kl_received(B: int, V: int, J: int, k: int,
                      sparse: bool = True) -> list:
    """The Eq.-2 kernels as the hetero population's mutual step calls them
    (``core.mutual.kl_to_received`` and ``sparse_kl_to_received``): ONE
    client's live public logits (1, B, V) against the J received stacks,
    weights 1/J (``sparse`` False: the dense call only, the DP-DML fleet's,
    which no sparse payload reaches).  fp32 and bf16, each through the entry point at impl
    "cuda" against impl "ref", the value and the live side's gradient
    (tolerances as ``phase_kl``'s and ``phase_sparse_kl``'s); the dense
    call must launch the pair forward and backward once each and no square
    kernel, the sparse call (the received top-k sets) the sparse forward
    and backward once each and no pair-KL kernel.  Then the bf16 times
    beside their bounds: the pair forward reads three (B, V) planes, the
    pair backward four (dlive written); the pair kernel runs its
    Kl = Kg = 2 instance here with the live row read again in the padded
    row, so beside it the same call with two distinct live rows (four
    planes): a re-read that reached HBM would put the Kl = 1 call at that
    time.  Returns the two pair kernels' rows at this shape."""
    from repro_torch.core import mutual
    from repro_torch.core.mutual import topk_predictions
    from repro_torch.kernels import kl_mutual, ref, sparse_kl
    gen = torch.Generator(device="cuda").manual_seed(7)
    errs = {}
    for dtype in (torch.float32, BF16):
        live = (2 * torch.randn(B, V, device="cuda", generator=gen)) \
            .to(dtype)
        rec = (2 * torch.randn(J, B, V, device="cuda", generator=gen)) \
            .to(dtype)
        gbar = torch.randn(B, device="cuda", generator=gen)
        sets = topk_predictions(rec, k) if sparse else None
        calls = [("dense", lambda a, impl: mutual.kl_to_received(
                      a, rec, impl=impl)),
                 ("sparse", lambda a, impl: mutual.sparse_kl_to_received(
                     a, *sets, impl=impl))]
        for name, fn in calls[:2 if sparse else 1]:
            res = []
            for impl in ("cuda", "ref"):
                a = live.detach().requires_grad_(True)
                before = _kernel_counts()
                out = fn(a, impl)
                (g,) = torch.autograd.grad(out, a, gbar)
                after = _kernel_counts()
                ran = {n: after[n] - before[n] for n in after
                       if after[n] != before[n]}
                res.append((out.detach(), g.float(), ran))
                del a, out, g
            (out, dl, ran), (want, want_dl, ran_ref) = res
            f_err = (out - want).abs().max().item()
            f_rel = ((out - want).norm() / want.norm()).item()
            b_rel = ((dl - want_dl).norm() / want_dl.norm()).item()
            lim = 1e-4 if dtype == torch.float32 else 2e-2
            need = ({"kl_mutual_pair_fwd": 1, "kl_mutual_pair_bwd": 1}
                    if name == "dense" else
                    {"sparse_kl_fwd": 1, "sparse_kl_bwd": 1})
            ok_f = (torch.allclose(out, want, atol=1e-3, rtol=1e-4)
                    if name == "dense" else f_rel <= lim)
            if not (ok_f and b_rel <= lim and ran == need and not ran_ref):
                raise AssertionError(
                    f"{name} Eq. 2 to {J} received at {dtype}: forward max "
                    f"|err| {f_err:.3g}, relative {f_rel:.3g}; dlive "
                    f"relative {b_rel:.3g}; launched {ran} (ref {ran_ref})")
            print(f"{name} Eq. 2 of one live row to J={J} received "
                  f"(B={B}, V={V}{f', k={k}' if name == 'sparse' else ''})"
                  f" {str(dtype)[6:]}, impl=cuda vs impl=ref: forward max "
                  f"|err| {f_err:.3g} (relative {f_rel:.3g}), dlive "
                  f"relative {b_rel:.3g} (limit {lim}); launched {ran}")
            errs[dtype, name] = (f_err, (dl - want_dl).abs().max().item())
            del res, out, dl, want, want_dl
        del live, rec, gbar, sets
        torch.cuda.empty_cache()

    x = (2 * torch.randn(2, B, V, device="cuda", generator=gen)).to(BF16)
    y = (2 * torch.randn(J, B, V, device="cuda", generator=gen)).to(BF16)
    live = x[:1]
    w = torch.full((1, J), 1.0 / J, device="cuda")
    w2 = torch.full((2, J), 1.0 / J, device="cuda")
    gbar = torch.randn(1, B, device="cuda", generator=gen)
    gbar2 = torch.randn(2, B, device="cuda", generator=gen)
    out, zl, zf, name = kl_mutual._forward(live, y, w, 1.0)
    out2, zl2, zf2, _ = kl_mutual._forward(x, y, w2, 1.0)
    if name != kl_mutual.PAIR:
        raise AssertionError(f"the received call left the pair kernel: "
                             f"{name}")
    timed = {
        "fwd": lambda: kl_mutual._forward(live, y, w, 1.0),
        "fwd2": lambda: kl_mutual._forward(x, y, w2, 1.0),
        "bwd": lambda: kl_mutual._backward(live, y, w, out, zl, zf, gbar,
                                           1.0, False),
        "bwd2": lambda: kl_mutual._backward(x, y, w2, out2, zl2, zf2, gbar2,
                                            1.0, False)}
    if sparse:
        sets = topk_predictions(y, k)
        _, stats = sparse_kl._forward(live, *sets, w, 1.0)
        timed["sfwd"] = lambda: sparse_kl._forward(live, *sets, w, 1.0)
        timed["sbwd"] = lambda: sparse_kl._backward(live, *sets, w, stats,
                                                    gbar, 1.0)
    ms = {key: time_ms(fn) for key, fn in timed.items()}
    a = live.detach().requires_grad_(True)

    def plain_f():
        with torch.no_grad():
            ref.mutual_kl_pair(a, y, w)

    def plain_fb():
        torch.autograd.grad(ref.mutual_kl_pair(a, y, w), a, gbar)

    def splain_f():
        with torch.no_grad():
            ref.sparse_kl_pair(a, *sets, w)

    def splain_fb():
        torch.autograd.grad(ref.sparse_kl_pair(a, *sets, w), a, gbar)
    plain_fwd = time_ms(plain_f, iters=5)
    plain_bwd = time_ms(plain_fb, iters=5) - plain_fwd
    if sparse:
        splain_fwd = time_ms(splain_f, iters=5)
        splain_bwd = time_ms(splain_fb, iters=5) - splain_fwd
    plane = B * V * 2
    fb = _bound(_kl_ops(1, J, B, V), (1 + J) * plane, torch.float32)
    bb = _bound(_kl_bwd_ops(1, J, B, V), (2 + J) * plane, torch.float32)
    fb2 = _bound(_kl_ops(2, J, B, V), (2 + J) * plane, torch.float32)
    bb2 = _bound(_kl_bwd_ops(2, J, B, V), (4 + J) * plane, torch.float32)
    rows = [("pair forward, Kl=1", "fwd", plain_fwd, fb),
            ("pair forward, Kl=2 (two distinct live rows)", "fwd2", None,
             fb2),
            ("pair backward, Kl=1", "bwd", plain_bwd, bb),
            ("pair backward, Kl=2", "bwd2", None, bb2)]
    if sparse:
        rows += [("sparse forward, Kl=1", "sfwd", splain_fwd,
                  _sparse_bound(1, J, B, V, k, BF16, False)),
                 ("sparse backward, Kl=1", "sbwd", splain_bwd,
                  _sparse_bound(1, J, B, V, k, BF16, True))]
    for what, key, plain, (bound, by) in rows:
        print(f"KL {what} against J={J} received at (B={B}, V={V}) bf16: "
              f"{ms[key]:.4f} ms"
              + (f", plain {plain:.4f} ms" if plain is not None else "")
              + f"; bound {bound:.4f} ms by {by} ({bound / ms[key]:.0%} of "
              f"it)")
    print(f"  the Kl=1 pair forward at J={J} takes "
          f"{ms['fwd'] / ms['fwd2']:.2f} of the Kl=2 call's time ({1 + J} "
          f"of {2 + J} planes read: {(1 + J) / (2 + J):.2f}; the padded "
          f"rows' re-read of the live row reaching HBM: 1.00)")
    del x, y, live, a, out, out2
    torch.cuda.empty_cache()
    src = "src/repro_torch/kernels/csrc/kl_mutual_pair.cu"
    row = dict(route="cuda", source=src, launches=None, library_ms=None,
               replaces="src/repro/kernels/kl_mutual.py:68")
    return [
        {"name": "kl_mutual_pair_fwd", **row,
         "max_abs_err": errs[BF16, "dense"][0], "ms": ms["fwd"],
         "plain_ms": plain_fwd, "bound_ms": fb[0], "bound_by": fb[1]},
        {"name": "kl_mutual_pair_bwd", **row,
         "replaces": "src/repro/kernels/kl_mutual.py:178",
         "max_abs_err": errs[BF16, "dense"][1], "ms": ms["bwd"],
         "plain_ms": plain_bwd, "bound_ms": bb[0], "bound_by": bb[1]},
    ]


def phase_kl_blocks(B: int, V: int) -> None:
    """The pair KL past one launch's MAX_CLIENTS = 8 a side, in client
    blocks: K = 9 and 16 with Kl = Kg and Kl != Kg, fp32 and bf16,
    participation-masked weights, T = 1.5, against ``ref.mutual_kl_pair``
    and its autograd on the live side, and in fp32 on both sides
    (tolerances as ``phase_kl``'s); each call counts one launch each way.
    Then ``ops.mutual_kl`` at K = 9 against ``ref.mutual_kl``: the square
    kernel on the diagonal blocks, the pair kernel off them."""
    from repro_torch.core.mutual import _pair_mask
    from repro_torch.kernels import kl_mutual, ops, ref
    gen = torch.Generator(device="cuda").manual_seed(5)
    T = 1.5
    worst = {}
    for Kl, Kg in ((9, 9), (16, 16), (9, 16), (16, 5)):
        K = max(Kl, Kg)
        w = _pair_mask(K, [1.0] * (K - 1) + [0.0], "cuda")[:Kl, :Kg]
        for dtype in (torch.float32, BF16):
            live = (2 * torch.randn(Kl, B, V, device="cuda",
                                    generator=gen)).to(dtype)
            fixed = (2 * torch.randn(Kg, B, V, device="cuda",
                                     generator=gen)).to(dtype)
            gbar = torch.randn(Kl, B, device="cuda", generator=gen)
            both = dtype == torch.float32
            res = []
            for fn in (kl_mutual.kl_mutual_pair, ref.mutual_kl_pair):
                a = live.detach().requires_grad_(True)
                b = fixed.detach().requires_grad_(both)
                before = (kl_mutual.launches, kl_mutual.bwd_launches)
                out = fn(a, b, w, temperature=T)
                grads = torch.autograd.grad(out, (a, b) if both else (a,),
                                            gbar)
                res.append((out.detach(), [g.float() for g in grads],
                            (kl_mutual.launches - before[0],
                             kl_mutual.bwd_launches - before[1])))
                del a, b, out, grads
            (out, gs, n_k), (want, wgs, n_r) = res
            lim = 1e-4 if both else 2e-2
            b_rel = max(((g - x).norm() / x.norm()).item()
                        for g, x in zip(gs, wgs))
            f_err = (out - want).abs().max().item()
            if not (torch.allclose(out, want, atol=1e-3, rtol=1e-4)
                    and b_rel <= lim and n_k == (1, 1) and n_r == (0, 0)):
                raise AssertionError(
                    f"blocked pair KL at Kl={Kl} Kg={Kg} {dtype}: forward "
                    f"max |err| {f_err:.3g}, backward relative error "
                    f"{b_rel:.3g}, launches {n_k}")
            n, fe, be = worst.get(dtype, (0, 0.0, 0.0))
            worst[dtype] = (n + 1, max(fe, f_err), max(be, b_rel))
            del live, fixed, gbar, res, out, gs, want, wgs
            torch.cuda.empty_cache()
    for dtype, (n, fe, be) in worst.items():
        print(f"pair KL in client blocks (Kl, Kg) = (9, 9), (16, 16), (9, 16)"
              f", (16, 5) at (B={B}, V={V}) {str(dtype)[6:]}: worst forward "
              f"max |err| {fe:.3g} (limit 1e-3 + 1e-4 |out|), backward "
              f"relative {be:.3g} (limit "
              f"{1e-4 if dtype == torch.float32 else 2e-2}); one launch a "
              f"call each way")
    x = (2 * torch.randn(9, B, V, device="cuda", generator=gen)).to(BF16)
    before = (kl_mutual.mutual_kl_launches, kl_mutual.square_launches,
              kl_mutual.pair_launches)
    got = ops.mutual_kl(x, temperature=T, impl="cuda")
    want = ref.mutual_kl(x, T)
    err = (got - want).abs().max().item()
    if not (torch.allclose(got, want, atol=1e-3, rtol=1e-4)
            and (kl_mutual.mutual_kl_launches, kl_mutual.square_launches,
                 kl_mutual.pair_launches) == tuple(n + 1 for n in before)):
        raise AssertionError(f"mutual_kl at K=9 disagrees: {err:.3g}")
    print(f"mutual_kl at K=9 (B={B}, V={V}) bf16 in client blocks (square "
          f"kernel on the diagonal, pair kernel off it): max |err| "
          f"{err:.3g}")
    del x, got, want
    torch.cuda.empty_cache()


def _sparse_case(gen, Kl, J, B, V, k, T, dtype, tie: bool):
    """Inputs of the sparse KL as the SparseDML path makes them: live
    logits in ``dtype``; the received (idx, logp) the top-k sets of the
    senders' logits (with Kl == J the live clients' own, detached, and
    w = (1 - I) / (K - 1); else J fresh senders and uniform 1/J); with
    ``tie`` row 0 of every client's and sender's logits all tie."""
    from repro_torch.core.mutual import _pair_mask, topk_predictions
    live = (2 * torch.randn(Kl, B, V, device="cuda", generator=gen)) \
        .to(dtype)
    if tie:
        live[:, 0] = 0.5
    if Kl == J:
        senders, w = live, _pair_mask(Kl, None, "cuda")
    else:
        senders = (2 * torch.randn(J, B, V, device="cuda", generator=gen)) \
            .to(dtype)
        if tie:
            senders[:, 0] = -1.0
        w = torch.full((Kl, J), 1.0 / J, device="cuda")
    idx, lp = topk_predictions(senders, k, T)
    gbar = torch.randn(Kl, B, device="cuda", generator=gen)
    return live, idx, lp, w, gbar


def _sparse_bound(Kl, J, B, V, k, dtype, backward: bool) -> tuple:
    """The least time of the sparse KL on these inputs: live read once
    (and dlive written once), the received idx and logp and the weights
    read once, out and the three per-row statistics written once (read by
    the backward, with the cotangent); against about 6 fp32 operations per
    live element (scale, max, subtract, exp, sum, fma; 8 in the backward)
    and 6 per received entry per live client, at the fp32 rate."""
    e = torch.finfo(dtype).bits // 8
    plane, rows = Kl * B * V, Kl * B
    # live (+ dlive), idx and logp, w; out and the statistics written by the
    # forward, the statistics and the cotangent read by the backward
    nbytes = (1 + int(backward)) * plane * e + J * B * k * 8 + Kl * J * 4 \
        + 4 * rows * 4
    flops = (8 if backward else 6) * plane + 6 * Kl * J * B * k
    return _bound(flops, nbytes, torch.float32)


def phase_sparse_kl(path_shapes, K: int) -> list:
    """The sparse-KL forward and backward against ``ref.sparse_kl_pair``
    and its autograd on the card, on the same idx and logp: fp32 and bf16
    at the SparseDML paths' shapes (``path_shapes``: (B, V) with K clients
    sharing their own top-64 sets), and around them Kl = 1 with J = 2,
    k = V on a small vocabulary, temperatures 0.5 and 2, and a row whose
    logits all tie.  Tolerance: relative norm error of out and of dlive
    1e-4 in fp32 (a one-pass streaming sum against a two-pass softmax) and
    2e-2 in bf16 (dlive is rounded to bf16 once).  Returns the two
    kernels' rows, timed at the first path shape in bf16."""
    from repro_torch.kernels import ref, sparse_kl
    gen = torch.Generator(device="cuda").manual_seed(4)
    tol = {torch.float32: 1e-4, BF16: 2e-2}
    B0, V0 = path_shapes[0]
    cases = [(K, K, B, V, 64, 1.0, dtype, False)
             for B, V in path_shapes for dtype in (torch.float32, BF16)]
    cases += [(1, 2, 256, V0, 64, 1.0, dtype, False)
              for dtype in (torch.float32, BF16)]
    cases += [(K, K, 64, 1000, 1000, 1.0, torch.float32, False),
              (2, 3, 33, 1000, 1000, 1.0, BF16, False),
              (K, K, 256, V0, 64, 0.5, torch.float32, False),
              (K, K, 256, V0, 64, 2.0, BF16, False),
              (K, K, 128, V0, 64, 1.0, torch.float32, True),
              (2, 3, 128, 5000, 64, 1.0, BF16, True)]
    # past one launch's 4096 entries: J * k = 6144 in sender blocks, and one
    # sender's k = 5000 read in place
    cases += [(K, K, 64, V0, 2048, 1.0, dtype, False)
              for dtype in (torch.float32, BF16)]
    cases += [(2, 1, 32, V0, 5000, 1.0, dtype, False)
              for dtype in (torch.float32, BF16)]
    worst = {}
    for Kl, J, B, V, k, T, dtype, tie in cases:
        live, idx, lp, w, gbar = _sparse_case(gen, Kl, J, B, V, k, T, dtype,
                                              tie)
        res = []
        for fn in (sparse_kl.sparse_kl_topk, ref.sparse_kl_pair):
            a = live.detach().requires_grad_(True)
            out = fn(a, idx, lp, w, temperature=T)
            (g,) = torch.autograd.grad(out, a, gbar)
            res.append((out.detach(), g.float()))
            del a, out, g
        (out, dl), (want, want_dl) = res
        f_rel = ((out - want).norm() / want.norm()).item()
        b_rel = ((dl - want_dl).norm() / want_dl.norm()).item()
        f_err = (out - want).abs().max().item()
        b_err = (dl - want_dl).abs().max().item()
        what = (f"Kl={Kl} J={J} B={B} V={V} k={k} T={T} {dtype}"
                f"{' tied row' if tie else ''}")
        if not (f_rel <= tol[dtype] and b_rel <= tol[dtype]):
            raise AssertionError(
                f"sparse KL disagrees with ref at {what}: relative error "
                f"of out {f_rel:.3g}, of dlive {b_rel:.3g}")
        n, fr, br = worst.get(dtype, (0, 0.0, 0.0))
        worst[dtype] = (n + 1, max(fr, f_rel), max(br, b_rel))
        if (Kl, J, B, V, k, T, dtype) == (K, K, B0, V0, 64, 1.0, BF16):
            errs = (f_err, b_err)
        del live, idx, lp, res, out, dl, want, want_dl
    for dtype, (n, fr, br) in worst.items():
        print(f"sparse KL vs ref, {n} cases {str(dtype)[6:]}: worst "
              f"relative error of out {fr:.3g}, of dlive {br:.3g} (limit "
              f"{tol[dtype]})")
    print(f"  the SparseDML paths' shapes (K={K}, B, V, k=64): "
          f"{list(path_shapes)}; around them Kl = 1 with J = 2, k = V, "
          f"T 0.5 and 2, rows whose logits all tie, k = 2048 (sender "
          f"blocks) and k = 5000 (in place)")
    torch.cuda.empty_cache()

    live, idx, lp, w, gbar = _sparse_case(gen, K, K, B0, V0, 64, 1.0, BF16,
                                          False)
    out, stats = sparse_kl._forward(live, idx, lp, w, 1.0)
    timed = {"forward": lambda: sparse_kl._forward(live, idx, lp, w, 1.0),
             "backward": lambda: sparse_kl._backward(live, idx, lp, w, stats,
                                                     gbar, 1.0),
             # one read of live by a library kernel: the forward's floor
             "read": lambda: torch.amax(live, dim=-1)}
    # on the rows' window (20 calls after 3), and beside it 50 after 10
    ms = {k: time_ms(fn) for k, fn in timed.items()}
    ms50 = {k: time_ms(fn, iters=50, warmup=10) for k, fn in timed.items()}
    a = live.detach().requires_grad_(True)

    def plain_f():
        with torch.no_grad():
            ref.sparse_kl_pair(a, idx, lp, w)

    def plain_fb():
        torch.autograd.grad(ref.sparse_kl_pair(a, idx, lp, w), a, gbar)
    plain_fwd = time_ms(plain_f, iters=5)
    plain_bwd = time_ms(plain_fb, iters=5) - plain_fwd
    fb = _sparse_bound(K, K, B0, V0, 64, BF16, False)
    bb = _sparse_bound(K, K, B0, V0, 64, BF16, True)
    for name, plain, (bound, by) in (("forward", plain_fwd, fb),
                                     ("backward", plain_bwd, bb)):
        print(f"sparse KL {name} at (Kl=J={K}, B={B0}, V={V0}, k=64) bf16: "
              f"{ms[name]:.4f} ms (50 calls after 10: {ms50[name]:.4f}), "
              f"plain {plain:.4f} ms, no single library call; bound "
              f"{bound:.4f} ms by {by} ({bound / ms[name]:.0%} of it)")
    print(f"one read of the sparse KL's live (Kl={K}, B={B0}, V={V0}) bf16 "
          f"by torch.amax: {ms['read']:.4f} ms (50 calls after 10: "
          f"{ms50['read']:.4f}; {fb[0] / ms['read']:.0%} of the forward's "
          f"bound)")
    del live, idx, lp, w, gbar, out, stats, a
    torch.cuda.empty_cache()
    src = "src/repro_torch/kernels/csrc/sparse_kl.cu"
    row = dict(route="cuda", source=src, launches=None, library_ms=None)
    return [
        {"name": "sparse_kl_fwd", **row,
         "replaces": "src/repro/kernels/sparse_kl.py:47",
         "max_abs_err": errs[0], "ms": ms["forward"], "plain_ms": plain_fwd,
         "bound_ms": fb[0], "bound_by": fb[1]},
        {"name": "sparse_kl_bwd", **row,
         "replaces": "src/repro/kernels/sparse_kl.py:167",
         "max_abs_err": errs[1], "ms": ms["backward"], "plain_ms": plain_bwd,
         "bound_ms": bb[0], "bound_by": bb[1]},
    ]


def _ssd_inputs(B, S, H, P, G, N, dtype, gen):
    """SSD inputs at mamba2's scale: x, B, C ~ N(0, 1) in ``dtype``; dt in
    [1e-3, 0.1] and A = -(1..48) per client (repeated over H / 48 clients),
    fp32, so the decay reaches e^-1200 within a 256-token chunk."""
    x = torch.randn(B, S, H, P, device="cuda", generator=gen).to(dtype)
    dt = (0.1 * torch.rand(B, S, H, device="cuda", generator=gen) + 1e-3)
    A = -(torch.arange(H, device="cuda") % 48 + 1).float()
    Bm = torch.randn(B, S, G, N, device="cuda", generator=gen).to(dtype)
    Cm = torch.randn(B, S, G, N, device="cuda", generator=gen).to(dtype)
    return x, dt, A, Bm, Cm


def _ssd_ops(B, S, H, P, G, N, chunk, backward: bool) -> float:
    """Multiply-add operations (x2) the scan needs on these inputs: per
    chunk of l positions and l(l+1)/2 causal pairs, the scores C.B^T once
    per group, and per head the weighted product with x, the inter-chunk
    C.state and the state update.  The backward needs the scores again
    (per group); per head over the pairs dM = dy.x^T and dx = M^T.dy; per
    group over the pairs dB and dC (C and B are shared by a group's heads,
    so the score cotangent is summed over them first); and per head four
    (l, P, N) products: dC from the entry state, the entry state's
    cotangent, dB from the carried state cotangent, and that cotangent
    times B, which gives dx and ddt.  The inter-chunk term of ddt is the
    elementwise product of C with dC, so C.state need not be recomputed;
    elementwise work is not counted."""
    ops = 0.0
    for c0 in range(0, S, chunk):
        l = min(chunk, S - c0)
        pairs = l * (l + 1) / 2
        if backward:
            ops += 2 * pairs * N * G + 2 * pairs * 2 * P * H \
                + 2 * pairs * 2 * N * G + 4 * 2 * l * N * P * H
        else:
            ops += 2 * pairs * N * G + 2 * pairs * P * H + 2 * 2 * l * N * P * H
    return B * ops


def _ssd_bytes(B, S, H, P, G, N, chunk, dtype, backward: bool) -> float:
    """Each input read once and each output written once: x, dt, B, C in;
    y, the final state and the fp32 entry states out (forward); x, dt, B,
    C, dy and the entry states in, dx, ddt, dB, dC out (backward)."""
    e = torch.finfo(dtype).bits // 8
    nc = -(-S // chunk)
    xs, bcs, dts = B * S * H * P * e, 2 * B * S * G * N * e, B * S * H * 4
    states = B * H * nc * P * N * 4
    if backward:
        return 2 * xs + bcs + dts + states + xs + dts + bcs
    return xs + bcs + dts + xs + B * H * P * N * 4 + states


def _ssd_check(fn_pair, ins, chunk, tol, what, backward, gen,
               state_grad: bool):
    """The kernel against ``ref.ssd`` on ``ins``: y and the final state by
    relative norm, and with ``backward`` the five gradients by relative
    norm, under a cotangent on y and, with ``state_grad``, on the final
    state too (training gives y's only).  Raises outside ``tol``; returns
    (max |y err|, max |grad err| or 0, worst relative error)."""
    kern, plain = fn_pair
    res = []
    cts = None
    for fn in (kern, plain):
        leaves = [t.clone().requires_grad_(backward) for t in ins]
        y, st = fn(*leaves, chunk=chunk)
        if backward:
            if cts is None:
                cts = (torch.randn(y.shape, device="cuda",
                                   generator=gen).to(y.dtype),
                       torch.randn(st.shape, device="cuda", generator=gen))
            outs = (y, st) if state_grad else (y,)
            grads = torch.autograd.grad(outs, leaves, cts[:len(outs)])
        else:
            grads = ()
        res.append((y.detach().float(), st.detach(),
                    [g.float() for g in grads]))
        del leaves, y, st, grads
    (y, st, gs), (wy, wst, wgs) = res
    # relative norm error, the norm floored at 1: a gradient that is 0 up
    # to rounding (dA at S = 1) must not make the check one of noise
    rel = lambda a, b: ((a - b).norm() / b.norm().clamp_min(1.0)).item()  # noqa
    errs = [rel(y, wy), rel(st, wst)] + [rel(g, w) for g, w in zip(gs, wgs)]
    if not max(errs) <= tol:
        raise AssertionError(f"SSD kernels disagree with ref at {what}: "
                             f"relative errors (y, state, dx, ddt, dA, dB, "
                             f"dC) {[f'{e:.3g}' for e in errs]}")
    g_err = max([(g - w).abs().max().item() for g, w in zip(gs, wgs)],
                default=0.0)
    return (y - wy).abs().max().item(), g_err, max(errs)


def phase_ssd(train_shapes, serve_shapes) -> list:
    """The SSD scan's forward and backward kernels against ``ref.ssd`` and
    its autograd on the card: the sweep ``SSD_SWEEP`` of (H, P, N, G),
    lengths and chunks, fp32 and bf16, with cotangents on y and the final
    state; then
    every shape the mamba2 paths give them, with training's cotangent on y
    (``train_shapes``: forward and backward; ``serve_shapes``: forward),
    bf16, chunk 256.  Each shape is (B, S, H, P, G, N).  Tolerance: every
    relative norm error (y, final state, the five gradients; norms floored
    at 1) within 1e-4 in fp32 (summation order) and 2e-2 in bf16 (y and
    dx, dB, dC are rounded to bf16 once).  Returns the two kernels' rows, timed at the training
    path's private-batch shape."""
    from repro_torch.kernels import ref, ssd_scan
    gen = torch.Generator(device="cuda").manual_seed(3)
    tol = {torch.float32: 1e-4, BF16: 2e-2}
    pair = (ssd_scan.ssd_scan, ref.ssd)
    cases = [((2, S, H, P, G, N), chunk, dtype, True)
             for H, P, N, G in SSD_SWEEP["heads"]
             for S in SSD_SWEEP["lengths"]
             for chunk in SSD_SWEEP["chunks"]
             for dtype in (torch.float32, BF16)]
    path = [(shape, 256, BF16, True) for shape in train_shapes]
    path += [(shape, 256, BF16, False) for shape in serve_shapes]
    worst = {}
    for shape, chunk, dtype, backward in cases + path:
        ins = _ssd_inputs(*shape, dtype, gen)
        what = f"(B, S, H, P, G, N) = {shape} chunk {chunk} {dtype}"
        on_path = (shape, chunk, dtype, backward) in path
        y_err, g_err, rel = _ssd_check(pair, ins, chunk, tol[dtype], what,
                                       backward, gen, not on_path)
        key = (dtype, on_path)
        n, e = worst.get(key, (0, 0.0))
        worst[key] = (n + 1, max(e, rel))
        if shape == train_shapes[0]:
            fwd_err, bwd_err = y_err, g_err
        del ins
    for (dtype, on_path), (n, e) in sorted(worst.items(), key=str):
        print(f"SSD kernels vs ref{' (the mamba2 paths)' if on_path else ''},"
              f" {n} cases {str(dtype)[6:]}: worst relative error of y, "
              f"state and the five gradients {e:.3g} (limit {tol[dtype]})")
    print(f"  the mamba2 paths' shapes (B, S, H, P, G, N): training "
          f"{list(train_shapes)} forward and backward, serving "
          f"{list(serve_shapes)} forward")
    torch.cuda.empty_cache()

    rows = []
    for shape, name in ((train_shapes[0], "training"),
                        (serve_shapes[0], "prefill")):
        fwd_ms, bwd_ms, plain_fwd, plain_bwd, fb, bb = _ssd_times(shape,
                                                                  gen)
        print(f"SSD forward at the {name} shape (B, S, H, P, G, N) = {shape} "
              f"bf16 chunk 256: {fwd_ms:.4f} ms, plain {plain_fwd:.4f} ms, "
              f"no single library call; bound {fb[0]:.4f} ms by {fb[1]} "
              f"({_ssd_ops(*shape, 256, False) / 1e9:.1f} GFLOP / "
              f"{BF16_TFLOPS:.0f} TFLOP/s, "
              f"{_ssd_bytes(*shape, 256, BF16, False) / 1e6:.0f} MB / "
              f"{HBM_TBS} TB/s)")
        print(f"SSD backward at the {name} shape: {bwd_ms:.4f} ms, plain "
              f"(autograd of ref, fwd+bwd - fwd) {plain_bwd:.4f} ms; bound "
              f"{bb[0]:.4f} ms by {bb[1]} "
              f"({_ssd_ops(*shape, 256, True) / 1e9:.1f} GFLOP, "
              f"{_ssd_bytes(*shape, 256, BF16, True) / 1e6:.0f} MB)")
        if not rows:
            src = "src/repro_torch/kernels/csrc/ssd_scan_{}.cu"
            row = dict(route="cuda", launches=None, library_ms=None)
            rows = [
                {"name": "ssd_scan_fwd", **row, "source": src.format("fwd"),
                 "replaces": "src/repro/kernels/ssd_scan.py:35",
                 "max_abs_err": fwd_err, "ms": fwd_ms, "plain_ms": plain_fwd,
                 "bound_ms": fb[0], "bound_by": fb[1]},
                {"name": "ssd_scan_bwd", **row, "source": src.format("bwd"),
                 "replaces": "src/repro/kernels/ssd_scan.py:154",
                 "max_abs_err": bwd_err, "ms": bwd_ms, "plain_ms": plain_bwd,
                 "bound_ms": bb[0], "bound_by": bb[1]}]
    return rows


def _ssd_times(shape, gen) -> tuple:
    """The bf16 SSD kernels at ``shape`` (B, S, H, P, G, N), chunk 256, on
    fresh draws: (forward ms, backward ms, the plain version's forward
    and backward ms (autograd of ``ref.ssd``, fwd+bwd - fwd), the forward's
    and the backward's (bound ms, bound by))."""
    from repro_torch.kernels import ref, ssd_scan
    ins = _ssd_inputs(*shape, BF16, gen)
    y, fin, states = ssd_scan._forward(*ins, 256)
    dy = torch.randn(y.shape, device="cuda", generator=gen).to(BF16)
    fwd_ms = time_ms(lambda: ssd_scan._forward(*ins, 256), iters=10)
    bwd_ms = time_ms(lambda: ssd_scan._backward(*ins, states, dy, None, 256),
                     iters=10)
    leaves = [t.detach().requires_grad_(True) for t in ins]

    def plain_f():
        with torch.no_grad():
            ref.ssd(*leaves, chunk=256)

    def plain_fb():
        torch.autograd.grad(ref.ssd(*leaves, chunk=256)[0], leaves, dy)
    plain_fwd = time_ms(plain_f, iters=3, warmup=1)
    plain_bwd = time_ms(plain_fb, iters=3, warmup=1) - plain_fwd
    fb = _bound(_ssd_ops(*shape, 256, False),
                _ssd_bytes(*shape, 256, BF16, False), BF16)
    bb = _bound(_ssd_ops(*shape, 256, True),
                _ssd_bytes(*shape, 256, BF16, True), BF16)
    del ins, y, fin, states, dy, leaves
    torch.cuda.empty_cache()
    return fwd_ms, bwd_ms, plain_fwd, plain_bwd, fb, bb


def bf16_steps(got, want, old):
    """|got - want| in bf16 steps at the operands' scale of p - lr u: the
    step of bf16 numbers as large as the largest of |old|, |want| and
    |got|."""
    scale = torch.maximum(torch.maximum(old.float().abs(),
                                        want.float().abs()),
                          got.float().abs())
    step = torch.ldexp(torch.ones_like(scale), torch.frexp(scale)[1] - 8)
    return (got.float() - want.float()).abs() / step


def phase_adamw(cfg, K: int) -> list:
    """The fused AdamW at a training path's tree: K clients of ``cfg``
    (bf16 params and gradients, fp32 moments; a tied embedding's gradient
    transposed, as the head gives it), clip 1.0, lr 1e-3, the weight
    decay 0.1 on matrices.  One step through the kernels against
    the plain version on a copy: ``grad_norm`` within 1e-6 relative,
    moments within 1e-6 (relative, and 1e-6 of the leaf's largest value
    absolute), bf16 params one bf16 step apart at most (``bf16_steps``),
    on at most 1e-4 of their elements.  Then the kernels' time (the norm pass and the
    update, a host-int step: no sync between launches) beside the bound,
    24 bytes a parameter at the HBM rate (the gradient read for the
    norm; p, g, mu and nu read and p, mu and nu written once), the
    plain version's, and ``torch._fused_adamw_``'s as a yardstick the
    port never calls (no norm or clip; it takes one dtype for params,
    gradients and moments, so it runs on an fp32 copy of the tree: 28
    bytes a parameter).  Returns the kernel's row."""
    from repro_torch import optim
    from repro_torch.kernels import adamw as fused
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.tree import tree_leaves, tree_map
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = tfm.init_model(0, cfg, n_clients=K, device="cuda")
    grads = tree_map(lambda t: (torch.randn(
        t.shape, generator=gen, device="cuda") * 1e-3).to(t.dtype), params)
    if cfg.tie_embeddings:       # the head's gradient comes back transposed
        e = params["embed"]
        grads["embed"] = (torch.randn(
            e.shape[:-2] + e.shape[:-3:-1], generator=gen, device="cuda")
            * 1e-3).to(e.dtype).transpose(-1, -2)
    ocfg = AdamWConfig(lr=1e-3, warmup=5, total_steps=10_000, clip_norm=1.0)
    n = sum(t.numel() for t in tree_leaves(params))
    want_p = tree_map(torch.clone, params)
    opt, want_o = adamw_init(params), adamw_init(want_p)
    opt["step"] = want_o["step"] = 0
    old = tree_map(torch.clone, params)

    def plain(p, o):
        gnorm = optim._plain_norm(tree_leaves(grads))
        scale = optim._clip_scale(gnorm, ocfg.clip_norm)
        o["step"] += 1
        lr, step = ocfg.make_schedule()(o["step"]), o["step"]
        for *leaf, decay in optim._update_leaves(p, grads, o, ocfg):
            optim._plain_update(leaf, scale, lr, 1 - ocfg.b1 ** step,
                                1 - ocfg.b2 ** step, ocfg, decay)
        return gnorm

    before = fused.launches
    om = adamw_update(params, grads, opt, ocfg)[2]
    launched = fused.launches - before
    gnorm = plain(want_p, want_o)
    torch.cuda.synchronize()
    norm_rel = abs(om["grad_norm"].item() / gnorm.item() - 1)
    mom_rel, mom_bits, flips, n16 = 0.0, {"mu": 0, "nu": 0}, 0, 0
    for m in mom_bits:
        for got, want in zip(tree_leaves(opt[m]), tree_leaves(want_o[m])):
            floor = 1e-6 * want.abs().max()
            for a, b in zip(got.view(-1).split(1 << 26),
                            want.view(-1).split(1 << 26)):      # memory
                mom_rel = max(mom_rel, ((a - b).abs() / (b.abs() + floor))
                              .max().item())
                mom_bits[m] += int((a != b).sum())
    steps = 0.0
    for got, want, was in zip(tree_leaves(params), tree_leaves(want_p),
                              tree_leaves(old)):
        for a, b, o in zip(*(t.view(-1).split(1 << 26)
                             for t in (got, want, was))):   # memory
            steps = max(steps, bf16_steps(a, b, o).max().item())
            flips += int((a != b).sum())
        n16 += got.numel()
    print(f"fused AdamW vs plain, one step of {K} x {cfg.name} "
          f"({n / 1e9:.3f} G params, {launched} launches): grad_norm "
          f"relative {norm_rel:.3g}, moments worst relative {mom_rel:.3g} "
          f"(not bit-equal: mu {mom_bits['mu']}, nu {mom_bits['nu']} of "
          f"{n} elements each), bf16 params "
          f"apart on {flips} of {n16}, by at most {steps:.3g} bf16 steps")
    if not (norm_rel <= 1e-6 and mom_rel <= 1e-6 and steps <= 1
            and flips <= 1e-4 * n16):
        raise AssertionError("fused AdamW departs from the plain version")
    del want_p, want_o, old
    torch.cuda.empty_cache()

    leaves = tree_leaves(grads)
    ms = time_ms(lambda: adamw_update(params, grads, opt, ocfg), iters=10)
    norm_ms = time_ms(lambda: fused.sumsq(leaves, clip=1.0), iters=10)
    plain_ms = time_ms(lambda: plain(params, opt), iters=3, warmup=1)
    bound_ms = 24 * n / PEAK_BYTES * 1e3
    del params, grads, opt, leaves
    gc.collect()
    torch.cuda.empty_cache()
    shapes = [t.shape for t in tree_leaves(
        tfm.init_model(0, cfg, n_clients=K, device="meta"))]
    ps = [torch.randn(s, generator=gen, device="cuda") * 0.02
          for s in shapes]
    gs = [torch.randn(s, generator=gen, device="cuda") * 1e-3
          for s in shapes]
    ms_ = [torch.zeros(s, device="cuda") for s in shapes]
    vs = [torch.zeros(s, device="cuda") for s in shapes]
    steps = [torch.ones((), device="cuda") for _ in shapes]
    library_ms = time_ms(lambda: torch._fused_adamw_(
        ps, gs, ms_, vs, [], steps, lr=1e-3, beta1=0.9, beta2=0.95,
        weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False),
        iters=10)
    del ps, gs, ms_, vs, steps
    torch.cuda.empty_cache()
    print(f"fused AdamW at {K} x {cfg.name}'s tree: {ms:.4f} ms (norm pass "
          f"{norm_ms:.4f} ms), {24 * n / ms / 1e9:.2f} TB/s of the "
          f"24 B a parameter; bound {bound_ms:.4f} ms by bytes "
          f"({24 * n / 1e9:.1f} GB / {HBM_TBS} TB/s); plain {plain_ms:.4f} "
          f"ms; torch._fused_adamw_ (fp32 tree, no norm) {library_ms:.4f} ms")
    return [{"name": "adamw_fused", "route": "cuda", "launches": None,
             "source": "src/repro_torch/kernels/csrc/adamw_fused.cu",
             "replaces": "none: XLA fuses repro/optim/__init__.py's update",
             "max_abs_err": mom_rel, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": "bytes",
             "library_ms": library_ms}]


# ---------------------------------------------------------------------------
# phase 3

def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def device_busy(run) -> dict:
    """{kernel name: (device microseconds, launches)} of ``run()`` under
    ``torch.profiler``."""
    return device_spans(run)[0]


def device_spans(run) -> tuple:
    """``device_busy``'s dict, and the microseconds during which at least
    one device activity ran (the union of their time ranges: activities
    that overlap count once), of ``run()`` under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    acc: dict = {}
    spans = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, cnt = acc.get(e.name, (0.0, 0))
            acc[e.name] = (us + e.time_range.elapsed_us(), cnt + 1)
            spans.append((e.time_range.start, e.time_range.end))
    union, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            union += b - max(a, end)
            end = b
    return acc, union


def _print_top(by_name, per: float, unit: str, n: int = 6) -> None:
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    for name, (us, cnt) in top:
        print(f"  {us / per / 1e3:7.3f} ms/{unit} {cnt / per:5.0f} x  "
              f"{name[:90]}")


def profile_decode(eng, prompts, step_secs: float, ttft_secs: float,
                   steps: int = 8, prefix=None) -> None:
    """Device time under ``torch.profiler`` of the first token (a generate
    of one token: the prefill and its sample) against its unprofiled wall
    time ``ttft_secs``, and of the decode loop: the kernels of ``steps``
    decode steps (a generate of ``steps`` minus one of a single step),
    their busy time per step against the unprofiled wall time per step
    ``step_secs``, and the kernels that take most of each.  ``prefix``
    goes to every generate."""
    first = device_busy(lambda: eng.generate(prompts, 1, prefix=prefix))
    first_us = sum(us for us, _ in first.values())
    print(f"time to first token: {ttft_secs * 1e3:.1f} ms wall "
          f"(unprofiled), {first_us / 1e3:.2f} ms device busy in "
          f"{sum(cnt for _, cnt in first.values())} kernels (profiled) -> "
          f"device idle {1 - first_us / 1e6 / ttft_secs:.1%}")
    _print_top(first, 1, "call", 4)
    by_name = device_busy(lambda: eng.generate(prompts, 1 + steps,
                                               prefix=prefix))
    for name, (us, cnt) in first.items():
        us0, cnt0 = by_name.get(name, (0.0, 0))
        by_name[name] = (us0 - us, cnt0 - cnt)
    busy_us = sum(us for us, _ in by_name.values()) / steps
    n_kernels = sum(cnt for _, cnt in by_name.values()) / steps
    print(f"decode step: {step_secs * 1e3:.1f} ms wall (unprofiled), "
          f"{busy_us / 1e3:.2f} ms device busy in {n_kernels:.0f} kernels "
          f"(profiled) -> device idle {1 - busy_us / 1e6 / step_secs:.1%}")
    _print_top(by_name, steps, "step")


def make_requests(cfg, n: int = 6, seed: int = 0) -> list:
    """``n`` (prompt, max_new, prefix) requests of 64-1024 prompt tokens
    and 16-64 new ones, for continuous batching; each request of a
    prefix-token arch has its own (P, prefix_dim) prefix, drawn as the
    serving CLI draws one, else None.  For
    an MoE arch a length past 256 is cut down to a multiple of 256: an MoE
    FFN routes a prompt in groups of min(256, S) tokens that must tile it
    (``models/moe.py``, as ``repro/models/moe.py:68`` asserts and the JAX
    engine's prefill at the request's own length requires)."""
    from repro_torch.launch.serve import _random_prefix
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        s0 = int(rng.integers(64, 1025))
        if cfg.moe and s0 > 256:
            s0 -= s0 % 256
        prefix = _random_prefix(cfg, 1, seed + 1 + i)
        reqs.append((rng.integers(0, cfg.vocab_size, (s0,)).astype(np.int32),
                     int(rng.integers(16, 65)),
                     None if prefix is None else prefix[0]))
    return reqs


def _rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


# The parity rule of every path (serving prefill logits, training
# gradients).  Over many bf16 layers from random weights any difference in
# rounding -- even a 1e-7 relative change of one product -- grows to a
# few percent of the output: two correct bf16 paths of mamba2's 48 layers
# disagree at the level of bf16 itself.  So each path is held three ways:
# the kernel path against the plain path on the same weights cast to fp32
# within 2e-2; the bf16 kernel path no farther from that fp32 plain path
# than FLOOR_FACTOR x the bf16 plain path is, plus 1e-3 (both carry bf16's
# noise, the kernels none of their own); and, where the path gives one
# (``bf16_limit``), the bf16 kernel path against the bf16 plain path.
FLOOR_FACTOR = 1.1


def _parity(what, e32, e16, floor, e_bf16, bf16_limit) -> None:
    """Applies the parity rule to per-client (or single) relative errors:
    ``e32`` kernel vs plain in fp32, ``e16`` and ``floor`` the bf16 kernel
    and plain paths against the fp32 plain path, ``e_bf16`` kernel vs
    plain in bf16."""
    lim = "no limit" if bf16_limit is None else f"limit {bf16_limit}"
    print(f"  {what}, impl=cuda vs impl=ref: bf16 {_fmt(e_bf16, '.4g')} "
          f"({lim}); on the same weights cast to fp32 {_fmt(e32, '.3g')} "
          f"(limit 2e-2); against the fp32 plain path, bf16 impl=cuda "
          f"{_fmt(e16)} and bf16 impl=ref {_fmt(floor)} (the bf16 floor; "
          f"limit {FLOOR_FACTOR} x floor + 1e-3)")
    if not (max(e32) <= 2e-2
            and all(a <= FLOOR_FACTOR * f + 1e-3 for a, f in zip(e16, floor))
            and (bf16_limit is None or max(e_bf16) <= bf16_limit)):
        raise AssertionError(f"{what} disagree with the plain path")


def _route_flips(a, b, n_experts: int) -> list:
    """Per ``apply_moe`` call of two runs (``moe.route_log`` lists, in call
    order: layer by layer), the tokens whose kept experts differ."""
    def kept(idx, keep):
        out = torch.zeros(*idx.shape[:-1], n_experts, dtype=torch.bool,
                          device=idx.device)
        return out.scatter_(-1, idx, keep)
    return [int((kept(*ra) != kept(*rb)).any(-1).sum())
            for ra, rb in zip(a, b)]


def _logged_routes(cfg, fn):
    """``fn()`` with every MoE call's routes logged (``moe.route_log``):
    (its result, the log, or None without MoE layers)."""
    from repro_torch.models import moe
    moe.route_log = [] if cfg.moe else None
    try:
        return fn(), moe.route_log
    finally:
        moe.route_log = None


def _first_layers(params, cfg, n_layers: int):
    """The first ``n_layers`` layers of every client, copied (so that the
    full population can be freed), with the embedding, final norm and
    head; and the config cut to that depth."""
    from repro_torch.tree import tree_map
    cut = cfg.replace(n_layers=n_layers)
    out = dict(params)
    out["periods"] = tree_map(lambda t: t[:, :cut.n_periods].clone(),
                              params["periods"])
    return out, cut


def _prefill_parity(cfg, params, ids, kw, bf16_limit, prefix=None) -> None:
    """The parity rule on the engine's prefill last-token logits of
    ``params`` (bf16) on ``ids`` behind ``prefix`` (None without one):
    engines at impl "cuda" and "ref" on them and on an fp32 copy.  For MoE
    layers, also the tokens per layer whose kept experts differ between
    the two impls, and the largest |logit|."""
    from repro_torch.serve import ServeEngine
    from repro_torch.tree import tree_map

    def prefill(c, p, impl):
        eng = ServeEngine(c, p, mode="average", impl=impl, **kw)
        return _logged_routes(c, lambda: eng._prefill(
            ids, eng._prefix(prefix))[0].float())

    (kernel_bf16, r16), (plain_bf16, p16) = (prefill(cfg, params, impl)
                                             for impl in ("cuda", "ref"))
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    (kernel32, r32), (plain32, p32r) = (prefill(cfg32, p32, impl)
                                        for impl in ("cuda", "ref"))
    del p32
    if cfg.moe:
        print(f"  routes of the {len(r16)} MoE layers: tokens whose kept "
              f"experts differ between impl=cuda and impl=ref, bf16 "
              f"{_route_flips(r16, p16, cfg.moe.n_experts)}, fp32 "
              f"{_route_flips(r32, p32r, cfg.moe.n_experts)} "
              f"(of {ids.numel()} a client); largest |logit| bf16 "
              f"{kernel_bf16.abs().max().item():.4g}")
    _parity("prefill last-token logits", [_rel(kernel32, plain32)],
            [_rel(kernel_bf16, plain32)], [_rel(plain_bf16, plain32)],
            [_rel(kernel_bf16, plain_bf16)], bf16_limit)


def phase_serve(card: str, cfg, reqs, kernel, K: int = 2, B: int = 2,
                S0: int = 512, gen: int = 32,
                bf16_limit: float | None = 2e-2,
                parity_layers: int | None = None, prefix=None) -> dict:
    """The port's serving path at the full width and depth of ``cfg``.
    ``kernel`` = (name, module): the mixer kernel whose module counter
    ``launches`` must show that every prefill and router call ran through
    it.  ``reqs`` are ``make_requests``'s; a prefix-token arch serves its
    B prompts of S0 behind ``prefix`` (B, P, prefix_dim) and each request
    behind its own, and its arena holds P positions more.  The prefill is
    held against an ``impl="ref"`` engine on the same weights by the
    parity rule (``_parity``): on the whole population, or with
    ``parity_layers`` on a copy of its first layers (every client), made
    after the population is freed, where an fp32 copy of the whole would
    not fit.  Returns the launch count over the served requests."""
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import ServeEngine
    from repro_torch.tree import tree_leaves

    params, secs = _timed(lambda: tfm.init_model(0, cfg, n_clients=K))
    leaves = tree_leaves(params)
    n = sum(t.numel() for t in leaves) // K
    gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    print(f"init {K} x {cfg.name} clients (seeded random weights): "
          f"{n / 1e9:.3f} B params each, {gb:.1f} GB on the card, "
          f"{secs:.1f} s")
    P = cfg.prefix_tokens
    max_seq = P + max(1152, S0 + gen)
    kw = dict(slots=4, max_seq=max_seq)
    avg = ServeEngine(cfg, params, mode="average", **kw)
    route = ServeEngine(cfg, params, mode="route", **kw)
    prompts = make_token_stream(B, S0, cfg.vocab_size, seed=0)
    if P:
        ring = min(cfg.sliding_window or max_seq, max_seq)
        print(f"prefix of {P} positions of dim {cfg.prefix_dim} before each "
              f"prompt: generate at {P + S0} positions + {gen} new; arena "
              f"of {max_seq} positions, a ring of {ring} keys a layer"
              f"{' (the window bites: decode wraps the ring)' if P + S0 + gen > ring else ''}")

    name, mod = kernel
    mod.launches = 0                   # the main path starts here
    (toks, lg), warm = _timed(lambda: avg.generate(
        prompts, gen, prefix=prefix, return_logits=True))
    steady_toks, steady = _timed(lambda: avg.generate(prompts, gen,
                                                      prefix=prefix))
    _, ttft = _timed(lambda: avg.generate(prompts, 1, prefix=prefix))
    rids = [avg.submit(p, n_new, prefix=pe) for p, n_new, pe in reqs]
    done, cb_secs = _timed(avg.run)
    rtoks, route_secs = _timed(lambda: route.generate(prompts, 16,
                                                      prefix=prefix))
    launches = mod.launches            # ... and ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    calls = {}
    for counts in (avg.dispatch_counts(), route.dispatch_counts()):
        for prog, c in counts.items():
            calls[prog] = calls.get(prog, 0) + c
    need = cfg.n_layers * (calls["prefill"] + calls["router"])
    print(f"program calls {calls}; {name} launches {launches} "
          f"(need >= {need} = {cfg.n_layers} layers x (prefill + router))")
    if launches < need:
        raise AssertionError(f"a prefill or router call did not run "
                             f"through {name}")
    outs = [toks, steady_toks, rtoks] + [done[r] for r in rids]
    if not all(((o >= 0) & (o < cfg.vocab_size)).all() for o in outs):
        raise AssertionError("token id out of range")
    if not np.isfinite(lg).all():
        raise AssertionError("non-finite logits")
    print(f"largest |logit| of the greedy generate: {np.abs(lg).max():.4g}")
    if not np.array_equal(toks, steady_toks):
        raise AssertionError("greedy generate is not repeatable")
    if sorted(len(done[r]) for r in rids) != sorted(n for _, n, _ in reqs):
        raise AssertionError("continuous batching lost tokens")

    step = (steady - ttft) / (gen - 1)
    profile_decode(avg, prompts, step, ttft, prefix=prefix)
    n_cb = sum(len(done[r]) for r in rids)
    print(f"serve {cfg.name} on {card}: average K={K} B={B} prompt {S0}: "
          f"warmup "
          f"{warm:.3f} s, steady {steady:.3f} s = {B * gen / steady:.1f} "
          f"tok/s; time to first token {ttft * 1e3:.1f} ms (generate with "
          f"gen_len=1: prefill + first token); continuous "
          f"batching {len(reqs)} requests / 4 slots: {n_cb} tokens in "
          f"{cb_secs:.3f} s = {n_cb / cb_secs:.1f} tok/s; decode step "
          f"{step * 1e3:.1f} ms; route generate "
          f"{route_secs:.3f} s; peak memory {peak_gb:.1f} GB")

    # the engine's prefill program against an engine at the plain version
    # on the same weights
    del avg, route, leaves
    what = "the same weights"
    if parity_layers:
        params, cfg = _first_layers(params, cfg, parity_layers)
        what = (f"a copy of the first {parity_layers} layers of "
                f"{cfg.name}, every client")
    gc.collect()
    torch.cuda.empty_cache()
    ids = torch.as_tensor(prompts, dtype=torch.long, device="cuda")
    print(f"prefill parity, engine impl=cuda vs engine impl=ref on {what} "
          f"(relative norm errors):")
    _prefill_parity(cfg, params, ids, kw, bf16_limit, prefix)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {name: launches}


# ---------------------------------------------------------------------------
# phase 4

def _client_grad_errors(g_host, g_dev, K: int, scale: float = 1.0) -> list:
    """Per client, ||scale g_host - g_dev|| / ||g_dev|| over every leaf;
    g_host lives on the CPU and crosses to the card one leaf at a time."""
    from repro_torch.tree import tree_leaves
    num, den = torch.zeros(K), torch.zeros(K)
    for a, b in zip(tree_leaves(g_host), tree_leaves(g_dev)):
        a, b = a.to(b.device).float() * scale, b.float()
        num += (a - b).square().flatten(1).sum(1).cpu()
        den += b.square().flatten(1).sum(1).cpu()
    return (num.sqrt() / den.sqrt()).tolist()


def _fmt(xs, spec: str = ".5f") -> str:
    return "[" + ", ".join(f"{x:{spec}}" for x in xs) + "]"


def _round0_inputs(pop) -> dict:
    """Round 0's DML inputs as the population draws them: the private and
    public batches and, for a prefix-token arch, their prefixes (None
    without), keyed as ``dml_total_loss`` takes them."""
    pub = pop._public_batch(0)
    return {"tokens": pop._private_batch(0), "public_tokens": pub,
            "prefix": pop._private_prefix(0),
            "public_prefix": pop._prefix(10_000, pub.shape[0])}


def _grad_parity(cfg, K: int, inputs, g_kernel_bf16, g_plain_bf16,
                 bf16_limit, loss_kw) -> None:
    """The parity rule on each client's gradient of round 1's loss on
    ``inputs`` (``_round0_inputs``), by relative norm: ``g_kernel_bf16``
    and ``g_plain_bf16`` (on the host) come from the bf16 population at
    impl "cuda" and "ref"; the fp32 gradients run here.  ``loss_kw``
    (SparseDML's ``sparse_k`` and ``received`` sets) goes to every
    gradient's loss alike."""
    from repro_torch.core import distributed as D
    from repro_torch.tree import tree_map
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    p32 = tree_map(lambda t: t.float(),
                   D.stacked_init(0, cfg, K, device="cuda"))
    _, _, g = D.value_and_grad(D.dml_total_loss, p32, cfg32, **inputs,
                               impl="cuda", **loss_kw)
    g_kernel32 = tree_map(lambda t: t.cpu(), g)
    del g
    _, _, g_plain32 = D.value_and_grad(D.dml_total_loss, p32, cfg32,
                                       **inputs, impl="ref", **loss_kw)
    del p32
    e32 = _client_grad_errors(g_kernel32, g_plain32, K)
    floor = _client_grad_errors(g_plain_bf16, g_plain32, K)
    e16 = _client_grad_errors(g_kernel_bf16, g_plain32, K)
    del g_plain32, g_kernel32
    print(f"  fp32 gradients: peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    _parity("per-client gradients", e32, e16, floor,
            _client_grad_errors(g_kernel_bf16, g_plain_bf16, K), bf16_limit)


def _round1_parity(population, cfg, K: int, strategy, bf16_limit, loss_kw,
                   first=None, g_cuda=None, routes=None) -> None:
    """Round 1 at ``impl="ref"`` against the same round through the
    kernels, from the same seeded weights and batches: each client's
    private_loss, public_ce and kld_avg within relative error 2e-2 (plus
    1e-3 absolute on kld_avg), and its gradient of the round's total loss
    by the parity rule (``_parity``).  ``population(impl)`` makes the
    population of ``cfg`` and K clients; ``first`` (round 1's log) and
    ``g_cuda`` (its gradient on the host, and the MoE ``routes`` it took)
    come from the main run when it is this population, else they are made
    here at impl "cuda"."""
    from repro_torch.api import Federation
    from repro_torch.core import distributed as D
    from repro_torch.tree import tree_map

    def grads(pop, impl):
        (_, _, g), routes = _logged_routes(cfg, lambda: D.value_and_grad(
            D.dml_total_loss, pop.client_params, cfg, **inputs, impl=impl,
            **loss_kw))
        return tree_map(lambda t: t.cpu(), g), routes

    if first is None:
        pop = population(None)
        inputs = _round0_inputs(pop)
        g_cuda, routes = grads(pop, "cuda")
        first = Federation(pop, strategy).run(until=1).rounds[0]
        print(f"round 1 at impl=cuda: private_loss {_fmt(first.client_loss)}"
              f" public_ce {_fmt(first.public_ce)} kld_avg "
              f"{_fmt(first.kl_loss)}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
        del pop
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pop = population("ref")
    inputs = _round0_inputs(pop)
    g_ref, ref_routes = grads(pop, "ref")
    if cfg.moe and routes is not None:
        print(f"routes of round 1's gradient: tokens whose kept experts "
              f"differ between impl=cuda and impl=ref, per MoE call in "
              f"call order (forwards, then the recomputes of remat) "
              f"{_route_flips(routes, ref_routes, cfg.moe.n_experts)}"
              f" of {inputs['tokens'].numel()} and "
              f"{K * inputs['public_tokens'].numel()}")
    ref_first = Federation(pop, strategy).run(until=1).rounds[0]
    print(f"round 1 at impl=ref: private_loss {_fmt(ref_first.client_loss)} "
          f"public_ce {_fmt(ref_first.public_ce)} kld_avg "
          f"{_fmt(ref_first.kl_loss)}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    rel = lambda a, b: abs(a - b) / abs(b)                  # noqa: E731
    worst = {
        "private_loss": max(map(rel, first.client_loss,
                                ref_first.client_loss)),
        "public_ce": max(map(rel, first.public_ce, ref_first.public_ce)),
        # |a - b| <= 2e-2 |b| + 1e-3  <=>  |a - b| / (|b| + 0.05) <= 2e-2
        "kld_avg": max(abs(a - b) / (abs(b) + 0.05) for a, b in
                       zip(first.kl_loss, ref_first.kl_loss))}
    print(f"round 1, impl=cuda vs impl=ref: worst relative error {worst} "
          f"(limit 2e-2; kld_avg within 2e-2 |ref| + 1e-3)")
    if not all(v <= 2e-2 for v in worst.values()):
        raise AssertionError("the training round disagrees with the plain "
                             "path")
    del pop
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _grad_parity(cfg, K, inputs, g_cuda, g_ref, bf16_limit, loss_kw)
    del g_ref, g_cuda
    gc.collect()
    torch.cuda.empty_cache()


def phase_train(card: str, cfg, mixer, K: int = 3, B: int = 4, S: int = 512,
                rounds: int = 3, bf16_limit: float | None = 2e-2,
                strategy=None, eq2=None, check=None) -> dict:
    """The port's training path: ``Federation(LMClients(cfg, K), strategy)``
    (``DML()`` by default) at the full width of ``cfg`` (depth as given),
    ``rounds`` fused rounds through the kernels, then Eq. 2 of the final
    public logits: through ``mutual_kl``, or for SparseDML through the
    sparse-KL forward against the clients' top-k sets.  A prefix-token
    arch trains behind the prefixes ``LMClients`` draws, and its Eq.-2
    term and readout read the token positions only.  ``mixer`` and
    ``eq2`` = (forward name, backward name, module): the mixer kernels and,
    for SparseDML, the sparse-KL kernels, counted by the module's
    ``launches`` and ``bwd_launches``.  A DML run's Eq.-2 terms and readout
    must all run the square forward (fixed is live: the pair KL's
    ``square_launches``) and its terms the square backward
    (``square_bwd_launches``), never a pair kernel; a SparseDML run must
    launch no pair-KL kernel.  Then round 1 is held against the same round
    at ``impl="ref"`` (``_round1_parity``): on this population, or with
    ``check`` = (n_layers, K, B) on a smaller copy from the same seed at
    the same width and sequence length, where the plain attention's
    scores over the whole population would not fit.  The two impls' bf16
    logits differ in rounding, so their top-k sets can differ at
    near-ties: the SparseDML round 1 of each impl shares its own sets, but
    every gradient of the parity runs on one (idx, logp) computed once,
    from the kernel path's logits.  Returns the kernels' launch counts
    over the training run."""
    from repro_torch.api import DML, Federation, LMClients
    from repro_torch.core import distributed as D
    from repro_torch.configs import get_config
    from repro_torch.core.mutual import (_pair_mask, mutual_kl_eval,
                                         topk_predictions)
    from repro_torch.kernels import kl_mutual as klm
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw_update
    from repro_torch.tree import tree_leaves, tree_map

    strategy = strategy or DML()
    sparse_k = strategy.sparse_k

    def population(impl, c=cfg, k=K, b=B):
        return LMClients(c, n_clients=k, rounds=rounds, batch=b, seq=S,
                         seed=0, kernel_impl=impl)

    def public_logits(pop, inputs):
        """The token positions' public logits (K, B_pub * S, V)."""
        with torch.no_grad():
            return D._public_ce_and_logits(
                pop.client_params, cfg, inputs["public_tokens"],
                inputs["public_prefix"], False, pop.impl)[1].reshape(
                    K, -1, cfg.vocab_size)

    torch.cuda.reset_peak_memory_stats()
    pop, secs = _timed(lambda: population(None))
    n = pop.params_per_client
    state_gb = sum(t.numel() * t.element_size() for t in
                   tree_leaves(pop.state_dict())) / 1e9
    print(f"init {K} x {cfg.name} clients, {cfg.n_layers} of "
          f"{get_config(cfg.name).n_layers} layers at "
          f"full width (seeded random weights): {n / 1e9:.3f} B params "
          f"each, {state_gb:.1f} GB of params and AdamW moments on the card, "
          f"{secs:.1f} s; kernels impl={pop.impl}")
    inputs = _round0_inputs(pop)
    received = None
    if sparse_k:                  # one (idx, logp) for every gradient below
        received = topk_predictions(public_logits(pop, inputs), sparse_k)
    loss_kw = {"sparse_k": sparse_k, "received": received}
    g_cuda = routes = None
    if check is None:             # the parity's kernel gradient, this state
        (_, _, grads), routes = _logged_routes(cfg, lambda: D.value_and_grad(
            D.dml_total_loss, pop.client_params, cfg, **inputs,
            impl=pop.impl, **loss_kw))
        g_cuda = tree_map(lambda t: t.cpu(), grads)
        del grads

    fed = Federation(pop, strategy)
    fwd_name, bwd_name, mod = mixer
    mod.launches = mod.bwd_launches = 0            # the main path starts here
    if eq2:
        eq2[2].launches = eq2[2].bwd_launches = 0
    klm.launches = klm.bwd_launches = klm.mutual_kl_launches = 0
    klm.square_launches = klm.pair_launches = 0
    klm.square_bwd_launches = klm.pair_bwd_launches = 0
    tokens = K * (B + max(1, B // 2)) * S
    positions = K * (B + max(1, B // 2)) * (cfg.prefix_tokens + S)
    walls = []
    for r in range(rounds):
        torch.cuda.reset_peak_memory_stats()
        if r == rounds - 1:                        # profile the last round
            t0 = time.perf_counter()
            by_name = device_busy(lambda: fed.run(until=r + 1))
            prof_secs = time.perf_counter() - t0
        else:
            _, secs = _timed(lambda: fed.run(until=r + 1))
            walls.append(secs)
        rl = fed.history.rounds[-1]
        wall = walls[-1] if r < rounds - 1 else prof_secs
        print(f"round {r}: {wall:.3f} s wall"
              f"{' (profiled)' if r == rounds - 1 else ''}, "
              f"{tokens / wall:.0f} trained tok/s; private_loss "
              f"{_fmt(rl.client_loss)} public_ce {_fmt(rl.public_ce)} "
              f"kld_avg {_fmt(rl.kl_loss)}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    last = {"public_tokens": pop._public_batch(rounds - 1),
            "public_prefix": pop._prefix(10_000 + rounds - 1, max(1, B // 2))}
    flat = public_logits(pop, last)
    with torch.no_grad():
        if sparse_k:
            readout = ops.sparse_mutual_kl(
                flat, *topk_predictions(flat, sparse_k),
                _pair_mask(K, None, flat.device), impl=pop.impl)
        else:
            readout = mutual_kl_eval(flat, impl=pop.impl)
    counts = {fwd_name: mod.launches,                # ... and ends here
              bwd_name: mod.bwd_launches,
              # the pair KL by kernel (calls of an entry point)
              "kl_mutual_square_fwd": klm.square_launches,
              "kl_mutual_pair_fwd": klm.pair_launches,
              "kl_mutual_square_bwd": klm.square_bwd_launches,
              "kl_mutual_pair_bwd": klm.pair_bwd_launches,
              "mutual_kl": klm.mutual_kl_launches}
    need = {fwd_name: 2 * 2 * cfg.n_layers * rounds,
            bwd_name: 2 * cfg.n_layers * rounds}
    if eq2:
        counts.update({eq2[0]: eq2[2].launches, eq2[1]: eq2[2].bwd_launches})
        need.update({eq2[0]: rounds + 1, eq2[1]: rounds})
    else:   # each round's Eq.-2 term and the readout: fixed is live
        need.update({"kl_mutual_square_fwd": rounds + 1,
                     "kl_mutual_square_bwd": rounds, "mutual_kl": 1})
    print(f"training launches {counts} (kl_mutual_pair called {klm.launches}"
          f" times); need at least {need} (private and public forward in "
          f"each of {cfg.n_layers} layers, twice under remat; their "
          f"backward; one Eq.-2 term per round; the readout)")
    short = [k for k in need if counts[k] < need[k]]
    if short:
        raise AssertionError(f"the training path did not run through {short}")
    if sparse_k and klm.launches + klm.bwd_launches + klm.mutual_kl_launches:
        raise AssertionError("the SparseDML path launched a pair-KL kernel")
    if not sparse_k and (klm.pair_launches or klm.pair_bwd_launches
                         or klm.square_launches != klm.launches + 1
                         or klm.square_bwd_launches != klm.bwd_launches
                         or klm.square_bwd_launches != rounds):
        raise AssertionError("a DML round's Eq.-2 term left the square "
                             "kernels")
    if readout.shape != (K, last["public_tokens"].numel()) or \
            not bool(torch.isfinite(readout).all()) or \
            float(readout.min()) < -1e-3:
        raise AssertionError(f"bad Eq.-2 readout {tuple(readout.shape)}")
    hist = fed.history.rounds
    if not all(np.isfinite(x).all() for rl in hist
               for x in (rl.client_loss, rl.public_ce, rl.kl_loss)):
        raise AssertionError("non-finite training losses")
    how = (f"the sparse-KL forward against their top-{sparse_k} sets"
           if sparse_k else "mutual_kl_eval, kernel 3")
    print(f"Eq.-2 readout of round {rounds - 1}'s public logits ({how}): "
          f"per-client mean {_fmt(readout.mean(1))}")
    if cfg.moe:
        with torch.no_grad():
            _, m = tfm.loss_fn_clients(pop.client_params, cfg,
                                       inputs["tokens"], inputs["prefix"],
                                       impl=pop.impl)
        print(f"after {rounds} rounds, on round 0's private batch: "
              f"load_balance {_fmt(m['load_balance'], '.6f')} router_z "
              f"{_fmt(m['router_z'], '.6f')} (summed over the MoE layers)")
    busy_us = sum(us for us, _ in by_name.values())
    n_kernels = sum(cnt for _, cnt in by_name.values())
    steady = walls[-1]
    behind = (f"; {positions} positions with the prefixes, "
              f"{positions / steady:.0f} a second"
              if cfg.prefix_tokens else "")
    print(f"train round on {card}: {steady:.3f} s wall (round {rounds - 2}, "
          f"unprofiled) = {tokens / steady:.0f} trained tok/s "
          f"(K*(B + B_pub)*S = {tokens} text tokens a round{behind}); round "
          f"{rounds - 1}: {busy_us / 1e3:.1f} ms device busy in {n_kernels} "
          f"kernels (profiled) -> device idle {1 - busy_us / 1e6 / steady:.1%}")
    _print_top(by_name, 1, "round", n=8)
    # the round's two halves timed apart, on a fourth update
    (_, _, grads), grad_secs = _timed(lambda: D.value_and_grad(
        D.dml_total_loss, pop.client_params, cfg, **inputs, impl=pop.impl,
        sparse_k=sparse_k))
    _, opt_secs = _timed(lambda: adamw_update(        # keep only metrics
        pop.client_params, grads, pop.client_opts, pop.opt_cfg)[2])
    print(f"round breakdown (a fourth update, host clock around "
          f"synchronised work): loss, forward and backward {grad_secs:.3f} "
          f"s; AdamW with the global-norm clip {opt_secs:.3f} s; peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    if sparse_k:
        topk_ms = time_ms(lambda: topk_predictions(flat, sparse_k), iters=5)
        print(f"  of it, the top-{sparse_k} payload of the public logits "
              f"{tuple(flat.shape)} (topk_predictions, CUDA events): "
              f"{topk_ms:.3f} ms")
    del grads
    first = hist[0]
    del fed, pop, flat, readout, inputs, last
    gc.collect()
    torch.cuda.empty_cache()

    if check is None:
        _round1_parity(population, cfg, K, strategy, bf16_limit, loss_kw,
                       first, g_cuda, routes)
    else:
        n_layers, ck, cb = check
        ccfg = cfg.replace(n_layers=n_layers)
        print(f"round 1 parity on a copy of {ck} x {cfg.name} clients cut "
              f"to {n_layers} layers, batch {cb} (public "
              f"{max(1, cb // 2)}), seq {S}, from the same seed: the plain "
              f"attention's fp32 scores over the whole population's "
              f"{K * (B + max(1, B // 2))} sequences would not fit")
        _round1_parity(lambda impl: population(impl, ccfg, ck, cb), ccfg,
                       ck, strategy, bf16_limit, loss_kw)
    return counts


# ---------------------------------------------------------------------------
# phase 8

def _group_sizes(cfg, params, K: int) -> tuple:
    """(shallow, deep) parameters per client, from the config's rule:
    embed and projector, and the first half of the periods, are shallow."""
    from repro_torch.tree import tree_leaves
    shallow = deep = 0
    for name, sub in params.items():
        for t in tree_leaves(sub):
            n = t.numel() // K
            if name == "periods":
                half = n // cfg.n_periods * (cfg.n_periods // 2)
                shallow, deep = shallow + half, deep + n - half
            elif name in ("embed", "projector"):
                shallow += n
            else:
                deep += n
    return shallow, deep


def _synced(params, mask, K: int, group: str) -> bool:
    """Whether every client holds the same values in ``group`` ('all',
    'shallow' or 'deep' of the float lerp ``mask``, whose leaves vary only
    along the period axis)."""
    from repro_torch.tree import tree_leaves
    for p, m in zip(tree_leaves(params), tree_leaves(mask)):
        keep = m.reshape(-1) > 0.5
        if group == "deep":
            keep = ~keep
        elif group == "all":
            keep = torch.ones_like(keep)
        if not bool(keep.any()):
            continue
        x = p if keep.numel() == 1 else p[:, keep]
        if not all(torch.equal(x[c], x[0]) for c in range(1, K)):
            return False
    return True


def phase_weights(card: str, cfg, mixer, K: int = 3, B: int = 4,
                  S: int = 512, fedavg_rounds: int = 2,
                  async_rounds: int = 3) -> dict:
    """The weight-sharing baselines at the full width of ``cfg`` (depth as
    given): ``fedavg_rounds`` rounds of ``FedAvg()``, after each of which
    every leaf is identical across the K clients, then ``async_rounds``
    rounds of ``AsyncWeights(delta=2, min_round=1)`` (shallow, deep,
    shallow), after each of which the scheduled group is identical across
    clients and the other is not.  Each round's comm_bytes must equal the
    analytic value from the config's shallow/deep rule, and the local
    step's mixer launches (``mixer`` as in ``phase_train``) at least
    2 * n_layers forward (remat) and n_layers backward a round.  Returns
    the mixer's launch counts."""
    from repro_torch.api import AsyncWeights, FedAvg, Federation, LMClients
    from repro_torch.core import distributed as D
    from repro_torch.core.async_fl import layer_schedule

    torch.cuda.reset_peak_memory_stats()
    pop = LMClients(cfg, n_clients=K, rounds=fedavg_rounds + async_rounds,
                    batch=B, seq=S, seed=0)
    n = pop.params_per_client
    shallow, deep = _group_sizes(cfg, pop.client_params, K)
    mask = D.transformer_shallow_mask(cfg, pop.client_params)
    print(f"weight baselines: {K} x {cfg.name}, {cfg.n_layers} layers at "
          f"full width, {n / 1e9:.3f} B params each ({shallow / 1e9:.3f} B "
          f"shallow, {deep / 1e9:.3f} B deep)")
    fwd_name, bwd_name, mod = mixer
    mod.launches = mod.bwd_launches = 0            # the main path starts here
    tokens = K * B * S
    for strategy, rounds in ((FedAvg(), fedavg_rounds),
                             (AsyncWeights(delta=2, min_round=1),
                              async_rounds)):
        fed = Federation(pop, strategy)
        for r in range(rounds):
            before = (mod.launches, mod.bwd_launches)
            torch.cuda.reset_peak_memory_stats()
            _, secs = _timed(lambda: fed.run(until=r + 1))
            rl = fed.history.rounds[-1]
            if strategy.name == "fedavg":
                want = 2 * K * n * 4
                ok = _synced(pop.client_params, mask, K, "all")
                what = "every leaf identical across clients"
            else:
                layer = layer_schedule(r, 2, 1)
                other = "deep" if layer == "shallow" else "shallow"
                want = 2 * K * (shallow if layer == "shallow" else deep) * 4
                ok = rl.layer == layer \
                    and _synced(pop.client_params, mask, K, layer) \
                    and not _synced(pop.client_params, mask, K, other)
                what = (f"{layer} group identical across clients, {other} "
                        f"group not")
            got = (mod.launches - before[0], mod.bwd_launches - before[1])
            print(f"{strategy.name} round {r}"
                  f"{' (' + rl.layer + ')' if rl.layer else ''}: {secs:.3f} "
                  f"s wall, {tokens / secs:.0f} trained tok/s; local loss "
                  f"{_fmt(rl.client_loss)}; comm_bytes {rl.comm_bytes} "
                  f"(analytic {want}); {what}: {ok}; {fwd_name} / "
                  f"{bwd_name} launches {got[0]} / {got[1]}; peak memory "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
            if not ok or rl.comm_bytes != want:
                raise AssertionError(f"{strategy.name} round {r} failed its "
                                     f"checks")
            if got[0] < 2 * cfg.n_layers or got[1] < cfg.n_layers:
                raise AssertionError(f"the local step did not run through "
                                     f"{fwd_name} / {bwd_name}")
            if not np.isfinite(rl.client_loss).all():
                raise AssertionError("non-finite local losses")
    counts = {fwd_name: mod.launches, bwd_name: mod.bwd_launches}
    print(f"weight baselines on {card}: launches {counts} over "
          f"{fedavg_rounds + async_rounds} rounds")
    del fed, pop, mask
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 9

# every kernel's launch counter, by the name of its row in the kernels line:
# (module of repro_torch.kernels, counter)
KERNEL_COUNTERS = {
    "flash_attention_fwd": ("flash_attention", "launches"),
    "flash_attention_bwd": ("flash_attention", "bwd_launches"),
    "kl_mutual_pair_fwd": ("kl_mutual", "pair_launches"),
    "kl_mutual_square_fwd": ("kl_mutual", "square_launches"),
    "kl_mutual_square_bwd": ("kl_mutual", "square_bwd_launches"),
    "kl_mutual_pair_bwd": ("kl_mutual", "pair_bwd_launches"),
    "mutual_kl": ("kl_mutual", "mutual_kl_launches"),
    "ssd_scan_fwd": ("ssd_scan", "launches"),
    "ssd_scan_bwd": ("ssd_scan", "bwd_launches"),
    "sparse_kl_fwd": ("sparse_kl", "launches"),
    "sparse_kl_bwd": ("sparse_kl", "bwd_launches"),
    "adamw_fused": ("adamw", "launches"),
}


def _kernel_counts(zero: bool = False) -> dict:
    """Every kernel's launch count (set to 0 first when ``zero``)."""
    import importlib
    counts = {}
    for name, (module, attr) in KERNEL_COUNTERS.items():
        mod = importlib.import_module(f"repro_torch.kernels.{module}")
        if zero:
            setattr(mod, attr, 0)
        counts[name] = getattr(mod, attr)
    return counts


@functools.lru_cache(maxsize=1)
def _paper_datasets(image_size: int, n_train: int, n_test: int):
    """``make_paper_datasets`` at these sizes, made once for phases 9 and
    20."""
    from repro_torch.data.synthetic import make_paper_datasets
    return make_paper_datasets(image_size=image_size, n_train=n_train,
                               n_test=n_test)


def phase_vision(card: str, cfg=None, K: int = 5, rounds: int = 12,
                 epochs: int = 3, B: int = 16, lr: float = 0.05,
                 n_train: int = 3833, n_test: int = 5988) -> dict:
    """The paper's VisionNet case study on the card, the protocol of the
    JAX package's ``examples/federated_visionnet.py`` at full width
    (``configs/visionnet.CONFIG`` by default: 100x100x3, convs 32/64/128,
    dense 64; K = 5 clients, ``make_paper_datasets`` at the paper's Table I
    sizes, 3 local epochs of batch 16, lr 0.05).  (1) Round 1 of DML with
    dropout off on the card and on the CPU from the same state, the card
    on cuDNN's deterministic algorithms: each client's params within
    relative norm error 1e-3, the round's client_loss and kl_loss vectors
    within 1e-4.  The losses amplify the params' rounding (saturated
    logits, |z| ~ 15): with the card's nondeterministic weight gradients
    its state varied run to run and the losses' error with it, up to
    3.7e-4.  (2) 12 rounds each of DML,
    FedAvg and AsyncWeights(delta=3, min_round=5) with the paper's dropout,
    then ``evaluate`` on dataset 2: comm bytes equal to the analytic
    values, every leaf identical across clients after each FedAvg round,
    the scheduled group (and only it) after each async round, finite
    losses, accuracies in [0, 1]; round wall, trained images/s, one
    profiled DML round's device busy time, peak memory and the Table-II
    analogue printed.  No kernel of this repo lies on the path: returns
    every kernel's launch count over the phase, all 0."""
    from repro_torch.api import (DML, AsyncWeights, FedAvg, Federation,
                                 VisionClients)
    from repro_torch.configs.visionnet import CONFIG
    from repro_torch.core.async_fl import layer_schedule
    from repro_torch.tree import tree_leaves, tree_map

    cfg = cfg or CONFIG
    # the shallow/deep rule as ``_synced``'s float lerp mask
    conv_mask = lambda pop: tree_map(              # noqa: E731
        lambda sh: torch.tensor([float(sh)]), pop.shallow_mask)
    t0 = time.perf_counter()
    (tx, ty), (ex, ey) = _paper_datasets(cfg.image_size, n_train, n_test)
    # the parameter counts, from the config alone
    k2 = cfg.kernel_size ** 2
    chans = (cfg.channels,) + tuple(cfg.conv_features)
    n_shallow = sum(k2 * a * b + b for a, b in zip(chans, chans[1:]))
    side = cfg.image_size // 4
    n_deep = (side * side * chans[-1] * cfg.dense_features
              + cfg.dense_features + cfg.dense_features * cfg.n_classes
              + cfg.n_classes)
    n_params = n_shallow + n_deep
    print(f"vision: {K} x VisionNet {cfg.image_size}x{cfg.image_size}x"
          f"{cfg.channels}, convs {cfg.conv_features}, dense "
          f"{cfg.dense_features}: {n_params:,} params each ({n_shallow:,} "
          f"shallow, {n_deep:,} deep); datasets {len(tx)} train / "
          f"{len(ex)} unseen test made in {time.perf_counter() - t0:.1f} s")
    kw = dict(n_clients=K, rounds=rounds, local_epochs=epochs,
              batch_size=B, lr=lr)
    torch.cuda.reset_peak_memory_stats()
    _kernel_counts(zero=True)                     # the main path starts here

    # (1) round 1 of DML, card against CPU, dropout off; cuDNN's
    # deterministic algorithms, so that every run holds the same state and
    # round (its weight gradients otherwise sum in a varying order)
    cfg0 = cfg.replace(dropout_rate=0.0)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        pop = VisionClients(cfg0, tx, ty, **kw)
        host = VisionClients(cfg0, tx, ty, device="cpu", **kw)
        host.load_state_dict(tree_map(lambda t: t.cpu(), pop.state_dict()),
                             pop.meta_dict())
        (h_card, secs) = _timed(lambda: Federation(pop, DML()).run(until=1))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if pop.params_per_client != n_params:
        raise AssertionError(f"{pop.params_per_client} params a client, "
                             f"not {n_params}")
    t1 = time.perf_counter()
    h_host = Federation(host, DML()).run(until=1)
    host_secs = time.perf_counter() - t1
    a, b = h_card.rounds[0], h_host.rounds[0]
    e_loss = _rel(torch.tensor(a.client_loss), torch.tensor(b.client_loss))
    e_kl = _rel(torch.tensor(a.kl_loss), torch.tensor(b.kl_loss))
    e_par = [_rel(*(torch.cat([t[c].flatten().cpu() for t in tree_leaves(p)])
                    for p in (pop.client_params, host.client_params)))
             for c in range(K)]
    print(f"DML round 1 without dropout, card ({secs:.3f} s) vs CPU "
          f"({host_secs:.1f} s) from the same state: client_loss "
          f"{_fmt(a.client_loss, '.7f')} vs {_fmt(b.client_loss, '.7f')}, "
          f"kl_loss {_fmt(a.kl_loss, '.7f')} vs {_fmt(b.kl_loss, '.7f')}; "
          f"relative norm error client_loss {e_loss:.3g}, kl_loss "
          f"{e_kl:.3g} (limit 1e-4), params by client {_fmt(e_par, '.3g')} "
          f"(limit 1e-3)")
    if not (e_loss <= 1e-4 and e_kl <= 1e-4 and max(e_par) <= 1e-3):
        raise AssertionError("the vision round on the card disagrees with "
                             "the CPU")
    del pop, host
    gc.collect()
    torch.cuda.empty_cache()

    # (2) the paper's run, with dropout
    results = {}
    for strategy in (DML(kl_weight=1.0, mutual_epochs=1), FedAvg(),
                     AsyncWeights(delta=3, min_round=5)):
        name = strategy.name
        pop = VisionClients(cfg, tx, ty, **kw)
        fed = Federation(pop, strategy)
        walls, images, busy = [], [], None
        for r in range(rounds):
            if name == "dml" and r == rounds - 1:    # profile the last round
                (by_name, union), prof_secs = _timed(
                    lambda: device_spans(lambda: fed.run(until=r + 1)))
                busy = sum(us for us, _ in by_name.values()) / 1e3
            else:
                _, s = _timed(lambda: fed.run(until=r + 1))
                walls.append(s)
            rl = fed.history.rounds[-1]
            fold = [len(f) for f in pop._last_folds]
            payload = len(pop.folds._folds[pop.folds._cursor - 1])
            n_img = sum(epochs * (n // B) * B for n in fold)
            if name == "dml":
                want = 2 * K * payload * 4
                n_img += K * payload
                ok, what = True, "-"
            elif name == "fedavg":
                want = 2 * K * n_params * 4
                ok = _synced(pop.client_params, conv_mask(pop), K, "all")
                what = "every leaf identical across clients"
            else:
                layer = layer_schedule(r, 3, 5)
                other = "deep" if layer == "shallow" else "shallow"
                want = 2 * K * (n_shallow if layer == "shallow"
                                else n_deep) * 4
                n_img += epochs * (payload // B) * B
                ok = rl.layer == layer and \
                    _synced(pop.client_params, conv_mask(pop), K, layer) and \
                    not _synced(pop.client_params, conv_mask(pop), K, other)
                what = (f"{layer} group identical across clients, {other} "
                        f"group not")
            images.append(n_img)
            if rl.comm_bytes != want or not ok or \
                    not np.isfinite(rl.client_loss + rl.kl_loss).all():
                raise AssertionError(
                    f"{name} round {r}: comm_bytes {rl.comm_bytes} "
                    f"(analytic {want}), {what}: {ok}, losses "
                    f"{rl.client_loss} {rl.kl_loss}")
        (h, eval_secs) = _timed(lambda: fed.evaluate(split=(ex, ey)))
        accs = h.client_test_acc + [h.global_test_acc]
        if not all(np.isfinite(x) and 0.0 <= x <= 1.0 for x in accs) or \
                len(h.client_test_acc) != K:
            raise AssertionError(f"{name}: bad accuracies {accs}")
        steady = walls[1:]
        rate = sum(images[1:len(walls)]) / sum(steady)
        print(f"{name}: {rounds} rounds, round wall {_fmt(walls, '.4f')} s "
              f"(round 0 first; mean after it {np.mean(steady):.4f} s), "
              f"{rate:.0f} trained images/s; comm {h.total_comm_bytes} "
              f"bytes (analytic every round); evaluate {eval_secs:.3f} s "
              f"wall ({len(ex)} images x {K + 1} models, eval_batch "
              f"{pop.eval_batch}); last-round loss {_fmt(rl.client_loss)}")
        if busy is not None:
            mean = float(np.mean(steady))
            print(f"  one DML round profiled ({prof_secs * 1e3:.1f} ms "
                  f"wall): {sum(c for _, c in by_name.values())} device "
                  f"activities, {busy:.2f} ms summed, {union / 1e3:.2f} ms "
                  f"with one running (their union) against {mean * 1e3:.1f} "
                  f"ms unprofiled wall -> device idle "
                  f"{1 - union / 1e6 / mean:.1%}")
            _print_top(by_name, 1, "round", 6)
        results[name] = h
        del fed, pop
        gc.collect()
        torch.cuda.empty_cache()
    print(f"vision peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"GB on {card}")
    print("paper Table II analogue (accuracy % on the unseen dataset 2):")
    print(f"  {'framework':28s}" + "".join(f"client{c}  " for c in range(K))
          + "global")
    names = {"fedavg": "Vanilla FL", "async": "Async Weight FL",
             "dml": "Mutual Learning FL (ours)"}
    for name in ("fedavg", "async", "dml"):
        h = results[name]
        print(f"  {names[name]:28s}" + "".join(
            f"{100 * x:7.2f}  " for x in h.client_test_acc)
            + f"{100 * h.global_test_acc:6.2f}")
    ratio = results["fedavg"].total_comm_bytes / results["dml"].total_comm_bytes
    print(f"  DML moves {ratio:.0f}x fewer bytes than FedAvg "
          f"({results['dml'].total_comm_bytes} against "
          f"{results['fedavg'].total_comm_bytes} over {rounds} rounds)")
    counts = _kernel_counts()                     # ... and ends here
    if any(counts.values()):
        raise AssertionError(f"the vision path launched a kernel: {counts}")
    return counts


# ---------------------------------------------------------------------------
# phases 17-18: HeteroClients

def _expand(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t[None], tree)


def _host(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.cpu(), tree)


def _expand_dev(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.cuda(), tree)


def _tree_rel(a, b) -> list:
    """[||a - b|| / ||b||] over every leaf of two one-model trees: ``b``
    on the card (moved there whole), ``a`` anywhere (one leaf at a
    time)."""
    return _client_grad_errors(_expand(a), _expand(_expand_dev(b)), 1)


def _mutual_grad(cm, params, inputs, received, impl: str, robust=None):
    """Client ``cm``'s gradient of its Eq.-1 mutual-step loss at
    ``params``: public CE on ``inputs`` + Eq. 2 against ``received`` (the
    (J, N_pub, V) logits, or SparseDML's (idx, logp) sets; with
    ``robust`` (mode, trim) the KL to their robust consensus), the loss of
    ``HeteroClients._mutual_step``; returns (loss, gradient)."""
    from repro_torch.core import distributed as D
    from repro_torch.core.mutual import (kl_to_received,
                                         kl_to_robust_received,
                                         sparse_kl_to_received)

    def loss(p):
        ce, live = cm.public_ce_and_logits(p, inputs, None, None, impl=impl)
        if isinstance(received, tuple):
            terms = sparse_kl_to_received(live, *received, impl=impl)
        elif robust is not None:
            terms = kl_to_robust_received(live, received, *robust)
        else:
            terms = kl_to_received(live, received.to(live.dtype), impl=impl)
        return ce + torch.mean(terms), None
    total, _, g = D.value_and_grad(loss, params)
    return float(total), g


def _hetero_grad_parity(cms, seeds, inputs, stack, sparse_k: int,
                        limits, robust=None) -> None:
    """The parity rule on each client's gradient of its mutual-step loss
    at its initial weights (drawn again from the population's seeds, one
    client at a time): bf16 at impl "cuda" and "ref", and an fp32 copy of
    the same weights at both, every one against the same received
    predictions: the other clients' rows of ``stack``, the kernel path's
    shared logits (or a DP release of them), or their top-``sparse_k``
    sets; ``robust`` (mode, trim) descends the KL to their consensus.  ``limits`` holds each
    client's bf16-vs-bf16 limit (None for MoE clients: a route flip moves
    a token by O(1))."""
    from repro_torch.core.mutual import topk_predictions
    from repro_torch.models import get_client_model
    from repro_torch.tree import tree_map
    for c, (cm, seed, lim) in enumerate(zip(cms, seeds, limits)):
        others = torch.cat([stack[:c], stack[c + 1:]])
        received = topk_predictions(others, sparse_k) if sparse_k else others
        p16 = cm.init(seed, "cuda")
        l16k, g = _mutual_grad(cm, p16, inputs, received, "cuda", robust)
        g16k = _host(g)
        l16p, g = _mutual_grad(cm, p16, inputs, received, "ref", robust)
        g16p = _host(g)
        del g
        p32 = tree_map(lambda t: t.float(), p16)
        del p16
        cm32 = get_client_model(cm.cfg.replace(param_dtype="float32",
                                               compute_dtype="float32"))
        if not sparse_k:
            received = others.float()
        l32k, g = _mutual_grad(cm32, p32, inputs, received, "cuda", robust)
        g32k = _host(g)
        del g
        l32p, g32p = _mutual_grad(cm32, p32, inputs, received, "ref",
                                  robust)
        del p32
        print(f"  client {c} ({cm.arch}): mutual-step loss impl=cuda / ref "
              f"bf16 {l16k:.5f} / {l16p:.5f}, fp32 {l32k:.5f} / {l32p:.5f}")
        _parity(f"client {c}'s gradient ({cm.arch})", _tree_rel(g32k, g32p),
                _tree_rel(g16k, g32p), _tree_rel(g16p, g32p),
                _tree_rel(g16k, g16p), lim)
        if abs(l16k - l16p) > 2e-2 * abs(l16p):
            raise AssertionError(f"client {c}'s mutual-step loss disagrees")
        del g16k, g16p, g32k, g32p
        gc.collect()
        torch.cuda.empty_cache()


def _hetero_round_parity(first, ref_first, what: str) -> None:
    """Round 1 through the kernels against the same round at impl "ref":
    each client's local loss, public CE and KL within relative error 2e-2
    (KL within 2e-2 |ref| + 1e-3), as ``_round1_parity``."""
    rel = lambda a, b: abs(a - b) / abs(b)                  # noqa: E731
    worst = {
        "local_loss": max(map(rel, first.client_loss, ref_first.client_loss)),
        "public_ce": max(map(rel, first.public_ce, ref_first.public_ce)),
        "kl": max(abs(a - b) / (abs(b) + 0.05) for a, b in
                  zip(first.kl_loss, ref_first.kl_loss))}
    print(f"{what} round 1, impl=cuda vs impl=ref: local loss "
          f"{_fmt(first.client_loss)} / {_fmt(ref_first.client_loss)}, "
          f"public_ce {_fmt(first.public_ce)} / {_fmt(ref_first.public_ce)},"
          f" kl {_fmt(first.kl_loss)} / {_fmt(ref_first.kl_loss)}; worst "
          f"relative error {worst} (limit 2e-2; kl within 2e-2 |ref| + 1e-3)")
    if not all(v <= 2e-2 for v in worst.values()):
        raise AssertionError(f"the {what} round disagrees with the plain "
                             f"path")


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def phase_hetero(card: str, cfgs, B: int = 4, S: int = 512, pub: int = 2,
                 fold: int = 8, dml_rounds: int = 3, sparse_rounds: int = 2,
                 k: int = 64) -> dict:
    """A mixed-architecture federation at full width:
    ``Federation(HeteroClients(cfgs, pool, labels), strategy)`` with one
    client per config (one vocabulary), folds of ``fold`` sequences of
    ``S`` tokens (T = fold / B local AdamW steps a client) and ``pub``
    public sequences.  ``dml_rounds`` rounds of ``DML()`` (the last one
    profiled), one at participation K - 1 (the absent client's params and
    moments bitwise untouched, checked on a host copy) and
    ``sparse_rounds`` of ``SparseDML(k)``.  Each DML round's Eq. 2 runs
    the pair kernels, M x E launches each way (one live row against the
    J = M - 1 received) and no square or sparse kernel; each SparseDML
    round the sparse kernels M x E times each way and no pair-KL kernel;
    comm bytes equal ``comm_bytes_per_round`` / ``sparse_share_bytes``.
    Then round 1 of DML and of SparseDML from fresh populations against
    the same round at impl "ref" (``_hetero_round_parity``), and each
    client's gradient by the parity rule (``_hetero_grad_parity``).
    Returns the kernels' launch counts over the main run."""
    from repro_torch.api import (DML, Federation, HeteroClients, SparseDML,
                                 comm_bytes_per_round, make_lm_pool)
    from repro_torch.configs import get_config
    from repro_torch.core.mutual import sparse_share_bytes
    from repro_torch.tree import tree_leaves

    K, V = len(cfgs), cfgs[0].vocab_size
    rounds = dml_rounds + 1 + sparse_rounds
    pool, labels = make_lm_pool(((1 + K) * rounds + 1) * fold, S, V, seed=0)

    def population(impl):
        return HeteroClients(cfgs, pool, labels, rounds=rounds,
                             batch_size=B, public_batch=pub, seed=0,
                             kernel_impl=impl)

    torch.cuda.reset_peak_memory_stats()
    pop, secs = _timed(lambda: population(None))
    T, n_pub = pop._local_T, pop._pub_n * S
    tokens = K * (T * B + pop._pub_n) * S
    state_gb = sum(t.numel() * t.element_size() for t in
                   tree_leaves(pop.state_dict())) / 1e9
    print(f"hetero fleet of {K} at full width (seeded random weights), "
          f"V = {V}: " + ", ".join(
              f"{c.name} ({pop._models[c.name].family}, {c.n_layers} of "
              f"{get_config(c.name).n_layers} layers, {n / 1e9:.3f} B)"
              for c, n in zip(cfgs, pop.n_params))
          + f"; {state_gb:.1f} GB of params and AdamW moments, {secs:.1f} s;"
          f" T = {T} local steps of ({B}, {S}) a client, public "
          f"({pop._pub_n}, {S}) = {n_pub} positions; {tokens} trained "
          f"tokens a round; kernels impl={pop.impl}")
    mixers = ("flash_attention_fwd", "flash_attention_bwd")
    _kernel_counts(zero=True)                       # the main path starts here
    walls = []

    def run_round(fed, r, profile=False):
        before = _kernel_counts()
        torch.cuda.reset_peak_memory_stats()
        if profile:
            t0 = time.perf_counter()
            by_name, busy = device_spans(lambda: fed.run(until=r + 1))
            wall = time.perf_counter() - t0
        else:
            _, wall = _timed(lambda: fed.run(until=r + 1))
            by_name = busy = None
        return fed.history.rounds[-1], wall, _delta(before,
                                                    _kernel_counts()), \
            by_name, busy

    fed = Federation(pop, DML())
    first = None
    # the DML rounds' logs and the fleet's settings, for phase 26
    MEASURED["phase 17"] = dict(logs=[], rounds=rounds, B=B, S=S, pub=pub,
                                fold=fold)
    for r in range(dml_rounds):
        prof = r == dml_rounds - 1
        rl, wall, ran, by_name, busy = run_round(fed, r, prof)
        MEASURED["phase 17"]["logs"].append(rl)
        if r == 0:
            first = rl
        if not prof:
            walls.append(wall)
        M = len(rl.participants)
        want = comm_bytes_per_round(M, n_pub, V, 1)["round"]
        print(f"DML round {r}: {wall:.3f} s wall{' (profiled)' if prof else ''}"
              f", {tokens / wall:.0f} trained tok/s; local loss "
              f"{_fmt(rl.client_loss)} public_ce {_fmt(rl.public_ce)} kl "
              f"{_fmt(rl.kl_loss)}; comm_bytes {rl.comm_bytes} (analytic "
              f"{want}); launches {ran}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
        if rl.comm_bytes != want or ran.get("kl_mutual_pair_fwd") != M or \
                ran.get("kl_mutual_pair_bwd") != M or any(
                    ran.get(n) for n in ("kl_mutual_square_fwd",
                                         "kl_mutual_square_bwd",
                                         "sparse_kl_fwd", "sparse_kl_bwd")) \
                or not all(ran.get(n) for n in mixers):
            raise AssertionError(f"DML round {r} of the hetero fleet left "
                                 f"its kernels or its bytes")
        if not all(np.isfinite(x).all() for x in (rl.client_loss,
                                                  rl.public_ce, rl.kl_loss)):
            raise AssertionError("non-finite hetero losses")
    steady = walls[-1]
    busy_us = sum(us for us, _ in by_name.values())
    print(f"hetero DML round on {card}: {steady:.3f} s wall (round "
          f"{dml_rounds - 2}, unprofiled) = {tokens / steady:.0f} trained "
          f"tok/s; round {dml_rounds - 1}: {busy / 1e3:.1f} ms device busy "
          f"(union of activities; {busy_us / 1e3:.1f} ms summed) in "
          f"{sum(c for _, c in by_name.values())} kernels (profiled) -> "
          f"device idle {1 - busy / 1e6 / steady:.1%}")
    _print_top(by_name, 1, "round", n=8)

    # one round at participation K - 1: the absent client untouched
    r = dml_rounds
    fedp = Federation(pop, DML(), participation=K - 1)
    fedp.round = r
    absent, = set(range(K)) - set(fedp.participants(r))
    snap = _host(pop.state_dict()["clients"][absent])
    rl, wall, ran, _, _ = run_round(fedp, r)
    now = pop.state_dict()["clients"][absent]
    untouched = all(torch.equal(a, b.cpu()) for a, b in
                    zip(tree_leaves(snap["params"]) + tree_leaves(
                        snap["opt"]["mu"]) + tree_leaves(snap["opt"]["nu"]),
                        tree_leaves(now["params"]) + tree_leaves(
                            now["opt"]["mu"]) + tree_leaves(now["opt"]["nu"])))
    want = comm_bytes_per_round(K - 1, n_pub, V, 1)["round"]
    print(f"DML round {r} at participation {K - 1} (participants "
          f"{rl.participants}): {wall:.3f} s wall; local loss "
          f"{_fmt(rl.client_loss)}; comm_bytes {rl.comm_bytes} (analytic "
          f"{want}); launches {ran}; client {absent}'s params and moments "
          f"bitwise untouched: {untouched}")
    del snap, now
    if not untouched or rl.comm_bytes != want or \
            ran.get("kl_mutual_pair_fwd") != K - 1 or \
            ran.get("kl_mutual_pair_bwd") != K - 1:
        raise AssertionError("the partial-participation hetero round failed "
                             "its checks")

    feds = Federation(pop, SparseDML(k=k))
    for r in range(dml_rounds + 1, rounds):
        feds.round = r
        rl, wall, ran, _, _ = run_round(feds, r)
        want = sparse_share_bytes(K, n_pub, k)
        print(f"SparseDML(k={k}) round {r}: {wall:.3f} s wall, "
              f"{tokens / wall:.0f} trained tok/s; local loss "
              f"{_fmt(rl.client_loss)} public_ce {_fmt(rl.public_ce)} kl "
              f"{_fmt(rl.kl_loss)}; comm_bytes {rl.comm_bytes} (analytic "
              f"{want}); launches {ran}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
        if rl.comm_bytes != want or ran.get("sparse_kl_fwd") != K or \
                ran.get("sparse_kl_bwd") != K or any(
                    ran.get(n) for n in ("kl_mutual_pair_fwd",
                                         "kl_mutual_pair_bwd",
                                         "kl_mutual_square_fwd",
                                         "kl_mutual_square_bwd")) or \
                not np.isfinite(rl.kl_loss).all():
            raise AssertionError(f"SparseDML round {r} of the hetero fleet "
                                 f"left its kernels or its bytes")
    counts = _kernel_counts()                        # ... and ends here
    counts = {n: c for n, c in counts.items() if c}
    print(f"hetero launches over {rounds} rounds: {counts}")

    # the parity: round 1 of each strategy from fresh populations, and
    # each client's gradient at the initial weights
    inputs = pop._gather(pop.eval_fold)[0]
    cms = [pop._models[c.name] for c in cfgs]
    seeds = [pop._init_seed(c) for c in range(K)]
    del fed, fedp, feds, pop
    gc.collect()
    torch.cuda.empty_cache()
    for strat, main_first in ((DML(), first), (SparseDML(k=k), None)):
        if main_first is None:
            p = population(None)
            main_first = Federation(p, strat).run(until=1).rounds[0]
            del p
            gc.collect()
            torch.cuda.empty_cache()
        p = population("ref")
        ref_first = Federation(p, strat).run(until=1).rounds[0]
        del p
        gc.collect()
        torch.cuda.empty_cache()
        _hetero_round_parity(main_first, ref_first, strat.name)
    with torch.no_grad():
        stack = []
        for cm, seed in zip(cms, seeds):
            p = cm.init(seed, "cuda")
            stack.append(cm.share_logits(p, inputs, impl="cuda"))
            del p
        stack = torch.stack(stack)
    limits = [2e-2 if cm.cfg.moe is None else None for cm in cms]
    for sparse_k in (0, k):
        print(f"per-client gradients of the mutual-step loss at the initial "
              f"weights, {'SparseDML' if sparse_k else 'DML'} (received: the "
              f"kernel path's shared logits"
              f"{f', their top-{k} sets' if sparse_k else ''}):")
        _hetero_grad_parity(cms, seeds, inputs, stack, sparse_k, limits)
    del stack, inputs
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_hetero_small(card: str, tcfg, B: int = 4, S: int = 64,
                       rounds: int = 2, TB: int = 4, TS: int = 512) -> dict:
    """(a) The CLI's default fleet, ("qwen3-4b", "mamba2-780m",
    "dbrx-132b") at their reduced configs (fp32, vocab 512: dense, SSM at
    P 32 N 16 chunk 32, MoE), ``rounds`` DML rounds through the flash, SSD
    and pair-KL kernels (each round's launches checked), against the same
    rounds at impl "ref": every round's losses within relative error 1e-3
    and the final params within relative norm error 2e-2 a client (the
    parity rule's fp32 limit); ``FedAvg()`` refused on it.  (b) Three
    clients of ``tcfg`` (one arch, full width): 2 FedAvg rounds (every leaf
    identical across clients after each) and 3 AsyncWeights(delta=2,
    min_round=1) rounds (the scheduled group identical, the other not),
    comm bytes analytic.  Returns the kernels' launch counts."""
    from repro_torch.api import (DML, AsyncWeights, FedAvg, Federation,
                                 HeteroClients, make_lm_pool)
    from repro_torch.core import distributed as D
    from repro_torch.core import stacking
    from repro_torch.core.async_fl import layer_schedule
    from repro_torch.tree import tree_leaves

    archs = ("qwen3-4b", "mamba2-780m", "dbrx-132b")
    K = len(archs)
    pool, labels = make_lm_pool(((1 + K) * rounds + 1) * 8, S, 512, seed=0)
    runs = {}
    _kernel_counts(zero=True)                        # the main path starts
    for impl in (None, "ref"):
        pop = HeteroClients(archs, pool, labels, rounds=rounds,
                            batch_size=B, public_batch=2, seed=0,
                            kernel_impl=impl)
        fed = Federation(pop, DML())
        logs = []
        for r in range(rounds):
            before = _kernel_counts()
            rl = fed.run(until=r + 1).rounds[-1]
            ran = _delta(before, _kernel_counts())
            logs.append(rl)
            if pop.impl == "cuda" and not (
                    ran.get("kl_mutual_pair_fwd") == K
                    and ran.get("kl_mutual_pair_bwd") == K
                    and all(ran.get(n) for n in (
                        "flash_attention_fwd", "flash_attention_bwd",
                        "ssd_scan_fwd", "ssd_scan_bwd"))):
                raise AssertionError(f"reduced hetero round {r} left its "
                                     f"kernels: {ran}")
            if pop.impl == "cuda":
                print(f"reduced fleet {archs} (fp32) DML round {r}: local "
                      f"loss {_fmt(rl.client_loss)} kl {_fmt(rl.kl_loss)}; "
                      f"launches {ran}")
        runs[pop.impl] = (logs, [_host(p) for p in pop.client_params])
        if pop.impl == "cuda":
            try:
                Federation(pop, FedAvg())
                refusal = None
            except ValueError as e:
                refusal = str(e)
            if not refusal or "undefined across heterogeneous" not in \
                    refusal:
                raise AssertionError(f"FedAvg on the mixed fleet: {refusal}")
            print(f"FedAvg on the mixed fleet refused: {refusal[:90]}...")
            counts = {n: c for n, c in _kernel_counts().items() if c}
        del fed, pop
    (logs, params), (ref_logs, ref_params) = runs["cuda"], runs["ref"]
    # the kernel path's logs and the fleet's settings, for phase 26
    MEASURED["phase 18"] = dict(logs=logs, archs=archs, rounds=rounds, B=B,
                                S=S, V=512, fold=8)
    worst = max(abs(a - b) / abs(b) for g, w in zip(logs, ref_logs)
                for f in ("client_loss", "public_ce", "kl_loss")
                for a, b in zip(getattr(g, f), getattr(w, f)))
    errs = [_tree_rel(p, q)[0] for p, q in zip(params, ref_params)]
    print(f"reduced fleet, {rounds} DML rounds, impl=cuda vs impl=ref: "
          f"worst relative error of the round logs {worst:.3g} (limit "
          f"1e-3); final params' relative norm error per client "
          f"{_fmt(errs, '.3g')} (limit 2e-2)")
    if worst > 1e-3 or max(errs) > 2e-2:
        raise AssertionError("the reduced hetero fleet disagrees with the "
                             "plain path")
    del runs, params, ref_params

    # (b) one arch at full width: the weight strategies
    n_rounds = 5
    pool, labels = make_lm_pool(((1 + K) * n_rounds + 1) * 8, TS,
                                tcfg.vocab_size, seed=0)
    torch.cuda.reset_peak_memory_stats()
    pop = HeteroClients((tcfg,) * K, pool, labels, rounds=n_rounds,
                        batch_size=TB, public_batch=2, seed=0)
    stacked = stacking.stack_params(pop.client_params)
    shallow, deep = _group_sizes(tcfg, stacked, K)
    mask = D.transformer_shallow_mask(tcfg, stacked)
    del stacked
    n = pop.params_per_client
    print(f"weight baselines on a one-arch hetero fleet: {K} x {tcfg.name}, "
          f"{tcfg.n_layers} layers at full width, {n / 1e9:.3f} B params "
          f"each ({shallow / 1e9:.3f} B shallow, {deep / 1e9:.3f} B deep)")
    before = _kernel_counts()
    r = 0
    for strategy, n_r in ((FedAvg(), 2), (AsyncWeights(delta=2,
                                                       min_round=1), 3)):
        fed = Federation(pop, strategy)
        for _ in range(n_r):
            fed.round = r
            _, secs = _timed(lambda: fed.run(until=r + 1))
            rl = fed.history.rounds[-1]
            stacked = stacking.stack_params(pop.client_params)
            if strategy.name == "fedavg":
                want = 2 * K * n * 4
                ok = _synced(stacked, mask, K, "all")
                what = "every leaf identical across clients"
            else:
                layer = layer_schedule(r, 2, 1)
                other = "deep" if layer == "shallow" else "shallow"
                want = 2 * K * (shallow if layer == "shallow" else deep) * 4
                ok = rl.layer == layer and \
                    _synced(stacked, mask, K, layer) and \
                    not _synced(stacked, mask, K, other)
                what = (f"{layer} group identical across clients, {other} "
                        f"group not")
            del stacked
            print(f"{strategy.name} round {r}"
                  f"{' (' + rl.layer + ')' if rl.layer else ''}: {secs:.3f} "
                  f"s wall; local loss {_fmt(rl.client_loss)}; comm_bytes "
                  f"{rl.comm_bytes} (analytic {want}); {what}: {ok}; peak "
                  f"memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
            if not ok or rl.comm_bytes != want or \
                    not np.isfinite(rl.client_loss).all():
                raise AssertionError(f"{strategy.name} round {r} of the "
                                     f"one-arch hetero fleet failed")
            r += 1
    ran = _delta(before, _kernel_counts())
    if not all(ran.get(n, 0) >= 2 * tcfg.n_layers * 5 for n in
               ("flash_attention_fwd",)):
        raise AssertionError(f"the weight rounds left the flash kernels: "
                             f"{ran}")
    for name, c in ran.items():
        counts[name] = counts.get(name, 0) + c
    del fed, pop, mask
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 19: single-model training and the step factories

def phase_single(card: str, cfg, B: int = 4, S: int = 512, steps: int = 3,
                 prompt: int = 64, gen_len: int = 32) -> dict:
    """``launch.steps.make_train_step`` on one model of ``cfg`` (full width
    and depth) for ``steps`` steps of (B, S), the CLI's batches
    (``make_token_stream`` of domain 0 seeded by the step): ce and
    grad_norm finite, the flash kernels' launches.  Step 1's loss and
    gradient first, against impl "ref" and an fp32 copy, one after another
    on the same weights, by the parity rule (no bf16-vs-bf16 limit: 36
    bf16 layers).  Then ``make_multistep_decode``'s greedy tokens against
    ``greedy_generate``'s over ``gen_len`` new tokens of 2 prompts of
    ``prompt``.  Returns the kernels' launch counts."""
    from repro_torch.core import distributed as D
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.launch.steps import (make_multistep_decode,
                                          make_prefill_step,
                                          make_train_step)
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.tree import tree_leaves, tree_map

    def batch(i):
        return torch.as_tensor(make_token_stream(
            B, S + 1, cfg.vocab_size, seed=1000 * i, domain=0)[:, :S],
            dtype=torch.long, device="cuda")

    torch.cuda.reset_peak_memory_stats()
    params, secs = _timed(lambda: tfm.init_model(0, cfg))
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"single model: {cfg.name} at full width and depth "
          f"({cfg.n_layers} layers, {n / 1e9:.3f} B params, seeded random "
          f"weights), {secs:.1f} s")
    toks = batch(0)

    def grad(p, c, impl):
        loss, m, g = D.value_and_grad(tfm.loss_fn, p, c, toks, impl=impl)
        return float(loss), g
    l16k, g = grad(params, cfg, "cuda")
    g16k = _host(g)
    l16p, g = grad(params, cfg, "ref")
    g16p = _host(g)
    del g
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    l32k, g = grad(p32, cfg32, "cuda")
    g32k = _host(g)
    del g
    l32p, g32p = grad(p32, cfg32, "ref")
    del p32
    print(f"step 1's loss impl=cuda / ref: bf16 {l16k:.5f} / {l16p:.5f}, "
          f"fp32 {l32k:.5f} / {l32p:.5f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    _parity("step 1's gradient", _tree_rel(g32k, g32p),
            _tree_rel(g16k, g32p), _tree_rel(g16p, g32p),
            _tree_rel(g16k, g16p), None)
    if abs(l16k - l16p) > 2e-2 * abs(l16p):
        raise AssertionError("step 1's loss disagrees with the plain path")
    del g16k, g16p, g32k, g32p
    gc.collect()
    torch.cuda.empty_cache()

    opt_cfg = AdamWConfig(lr=1e-3, warmup=5, total_steps=steps)
    opt = adamw_init(params)
    step = make_train_step(cfg, opt_cfg, impl="cuda")
    _kernel_counts(zero=True)                        # the main path starts
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        toks = batch(i)
        (params, opt, m), secs = _timed(lambda: step(params, opt, toks))
        ce, gn = float(m["ce"]), float(m["grad_norm"])
        print(f"step {i}: {secs:.3f} s wall, {B * S / secs:.0f} trained "
              f"tok/s; ce {ce:.4f} grad_norm {gn:.3f}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
        if not (np.isfinite(ce) and np.isfinite(gn)):
            raise AssertionError("non-finite single-model metrics")
    del opt, m
    gc.collect()
    torch.cuda.empty_cache()

    prompts = torch.as_tensor(make_token_stream(2, prompt, cfg.vocab_size,
                                                seed=9), dtype=torch.long,
                              device="cuda")
    want, g_secs = _timed(lambda: greedy_generate(cfg, params, prompts,
                                                  gen_len, impl="cuda"))

    def multistep():
        logits, cache = make_prefill_step(cfg, max_seq=prompt + gen_len,
                                          impl="cuda")(params, prompts)
        tok = torch.argmax(logits, dim=-1)[:, None]
        return make_multistep_decode(cfg, gen_len)(
            params, tok, cache, prompt, torch.Generator(device="cuda"))
    (got, logits, *_), m_secs = _timed(multistep)
    same = torch.equal(got, want)
    print(f"make_multistep_decode vs greedy_generate, {gen_len} new tokens "
          f"of 2 prompts of {prompt}: tokens equal {same}; {m_secs:.2f} s / "
          f"{g_secs:.2f} s wall ({m_secs / gen_len * 1e3:.1f} / "
          f"{g_secs / gen_len * 1e3:.1f} ms a token, prefill included)")
    if not same or not bool(torch.isfinite(logits).all()):
        raise AssertionError("the multi-step decode disagrees with greedy "
                             "generation")
    counts = {n: c for n, c in _kernel_counts().items() if c}
    need = 2 * cfg.n_layers * steps + 2 * cfg.n_layers
    print(f"single-model launches {counts} (need flash forward >= {need}: "
          f"{steps} steps under remat and the two prefills)")
    if counts.get("flash_attention_fwd", 0) < need or \
            counts.get("flash_attention_bwd", 0) < cfg.n_layers * steps:
        raise AssertionError("the single-model path left the flash kernels")
    del params, prompts, got, want, logits
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phases 20-21b: privacy and robustness

def _closed_epsilon(sigma: float, delta: float, releases: int) -> float:
    """The Renyi accountant's (epsilon, delta) after ``releases`` Gaussian
    releases at noise multiplier ``sigma``, in closed form: S = n / (2
    sigma^2), epsilon = S + 2 sqrt(S log(1 / delta))."""
    S = releases / (2.0 * sigma * sigma)
    return S + 2.0 * float(np.sqrt(S * np.log(1.0 / delta)))


def _byz_experiment(seed: int = 0) -> dict:
    """The JAX suite's calibrated attack (``tests/test_privacy_robust.py``
    ``_byz_experiment``) through the port on the card: K = 4 VisionNet
    clients (the reduced config at 16 px) on a +-0.3 class-offset Gaussian
    task, client 3 colluding; the honest clients' mean accuracy on 300
    unseen examples under DML without and with the colluder, TrimmedDML
    and MedianDML."""
    from repro_torch.api import Federation, VisionClients, get_strategy
    from repro_torch.configs.visionnet import reduced
    cfg = reduced().replace(image_size=16)
    K, R, kl, me, le, off, lr = 4, 4, 5.0, 3, 2, 0.3, 0.03
    rng = np.random.default_rng(seed)

    def make_xy(n):
        y = (rng.random(n) > 0.5).astype(np.float32)
        x = rng.normal(size=(n, 16, 16, 3)).astype(np.float32)
        x += (y * 2 - 1)[:, None, None, None] * off
        return x, y

    imgs, labs = make_xy(420)
    test, tlab = make_xy(300)
    byz = {K - 1: "collude"}

    def run(name, attacked, **kw):
        pop = VisionClients(cfg, imgs, labs, n_clients=K, rounds=R,
                            local_epochs=le, batch_size=16, seed=seed, lr=lr,
                            byzantine=byz if attacked else None)
        fed = Federation(pop, get_strategy(name, kl_weight=kl,
                                           mutual_epochs=me, **kw))
        fed.run()
        h = fed.evaluate(split=(test, tlab))
        by_client[f"{name}{', attacked' if attacked else ''}"] = \
            [round(a, 4) for a in h.client_test_acc]
        return float(np.mean([a for c, a in enumerate(h.client_test_acc)
                              if c != K - 1]))

    by_client = {}
    acc = {"clean": run("dml", False), "poisoned": run("dml", True),
           "trimmed": run("trimmed-dml", True, trim=1),
           "median": run("median-dml", True)}
    print(f"robust experiment, every client's accuracy: "
          f"{json.dumps(by_client)}")
    return acc


def _mia_experiment(seed: int = 0) -> tuple:
    """The JAX suite's leakage-ordering experiment
    (``tests/test_privacy_attacks.py`` ``_mia_experiment``) through the
    port on the card: K = 4 clients, 3 rounds of 20 local epochs on 220
    examples (60% learnable labels); the MIA advantage, averaged over the
    4 victims, of a FedAvg weight upload, of DML's payload stream and of
    DP-DML's (sigma 1).  Returns (FedAvg, DML, DP-DML)."""
    from repro_torch.api import Federation, VisionClients, get_strategy
    from repro_torch.configs.visionnet import reduced
    from repro_torch.core import stacking
    from repro_torch.privacy.attacks import (collect_client_payloads,
                                             payload_mia, weight_upload_mia)
    cfg = reduced().replace(image_size=16)
    K, R, LE, BS, N = 4, 3, 20, 8, 220
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(N, 16, 16, 3)).astype(np.float32)
    labs = (imgs.mean(axis=(1, 2, 3)) > 0).astype(np.float32)
    rand_mask = rng.random(N) < 0.4
    labs[rand_mask] = (rng.random(int(rand_mask.sum())) > 0.5
                       ).astype(np.float32)

    def make_pop(rounds=R):
        return VisionClients(cfg, imgs, labs, n_clients=K, rounds=rounds,
                             local_epochs=LE, batch_size=BS, lr=0.05,
                             seed=seed, record_payloads=True)

    def mem_non(pop, client):
        other = (client + 1) % K
        mem = np.unique(np.concatenate([f[client] for f in pop.fold_log]))
        non = np.setdiff1d(
            np.unique(np.concatenate([f[other] for f in pop.fold_log])), mem)
        return mem, non

    # the FedAvg upload tap: R full rounds, then the (R+1)-th local phase
    # is the upload an eavesdropper observes
    pop_fa = make_pop(rounds=R + 1)
    Federation(pop_fa, get_strategy("fedavg")).run(until=R)
    pop_fa.begin_round(R)
    part = list(range(K))
    pop_fa.local_phase(R, part, pop_fa.part_mask(part))
    adv_fa = float(np.mean([weight_upload_mia(
        stacking.client_slice(pop_fa.client_params, c), cfg, imgs, labs,
        *mem_non(pop_fa, c)) for c in range(K)]))

    def payload_probe(pop):
        advs = []
        for c in range(K):
            pi, pp = collect_client_payloads(pop.payload_log, imgs, c)
            advs.append(payload_mia(cfg, pi, pp, imgs, labs,
                                    *mem_non(pop, c), 1000 + c, steps=300,
                                    device="cuda"))
        return float(np.mean(advs))

    pop_dml = make_pop()
    Federation(pop_dml, get_strategy("dml")).run()
    pop_dp = make_pop()
    Federation(pop_dp, get_strategy("dp-dml", dp_noise_multiplier=1.0)).run()
    return adv_fa, payload_probe(pop_dml), payload_probe(pop_dp)


def phase_vision_privacy(card: str, cfg=None, K: int = 5, rounds: int = 12,
                         epochs: int = 3, B: int = 16, lr: float = 0.05,
                         n_train: int = 3833, n_test: int = 5988,
                         sigma: float = 1.0, delta: float = 1e-5) -> dict:
    """Privacy and robustness on the paper's VisionNet protocol (phase 9's
    sizes: K = 5 at 100 px, Table I's datasets, 3 local epochs of batch
    16, 12 rounds).  (1) Round 1 of ``DPDML(sigma)`` with dropout off on
    the card and on the CPU from the same state, both sides drawing the
    same noise (the card's draw made on the CPU for this round only),
    cuDNN deterministic: params within relative norm error 1e-3 a client,
    the losses within 1e-3.  (2) 12 rounds of DP-DML (clip 1) with the
    paper's dropout and ``record_payloads``: epsilon after each round equal
    to the accountant's closed form, one (1, K, B_pub) payload a round
    inside [1e-4, 1 - 1e-4], comm bytes DML's.  (3) 12 rounds each of DML,
    DML with client 4 colluding, TrimmedDML(trim=1) and MedianDML with the
    colluder: round wall and the honest clients' unseen-set accuracy.  (4)
    The JAX suite's two experiments through the port: the directions
    poisoned DML < clean DML, trimmed and median > poisoned DML, and
    FedAvg's MIA advantage > DML's payload advantage are asserted; the
    JAX suite's margins are printed beside them, not asserted (the port's
    dropout draws are its own).  No kernel of this repo lies on the path:
    returns every launch count over the phase, all 0."""
    from repro_torch.api import (DML, DPDML, Federation, MedianDML,
                                 TrimmedDML, VisionClients)
    from repro_torch.configs.visionnet import CONFIG
    from repro_torch.privacy import dp as dp_mod
    from repro_torch.privacy.accountant import gaussian_epsilon
    from repro_torch.tree import tree_leaves, tree_map

    cfg = cfg or CONFIG
    (tx, ty), (ex, ey) = _paper_datasets(cfg.image_size, n_train, n_test)
    kw = dict(n_clients=K, rounds=rounds, local_epochs=epochs,
              batch_size=B, lr=lr)
    torch.cuda.reset_peak_memory_stats()
    _kernel_counts(zero=True)                     # the main path starts here

    # (1) round 1 of DP-DML, card against CPU, the same noise on both
    cfg0 = cfg.replace(dropout_rate=0.0)
    draw = dp_mod.gaussian
    deterministic = torch.backends.cudnn.deterministic
    dp_mod.gaussian = lambda w, shape, device: draw(w, shape, "cpu").to(
        device)
    torch.backends.cudnn.deterministic = True
    try:
        pop = VisionClients(cfg0, tx, ty, **kw)
        host = VisionClients(cfg0, tx, ty, device="cpu", **kw)
        host.load_state_dict(tree_map(lambda t: t.cpu(), pop.state_dict()),
                             pop.meta_dict())
        h_card, secs = _timed(lambda: Federation(
            pop, DPDML(dp_noise_multiplier=sigma)).run(until=1))
        h_host = Federation(host, DPDML(dp_noise_multiplier=sigma)).run(
            until=1)
    finally:
        dp_mod.gaussian = draw
        torch.backends.cudnn.deterministic = deterministic
    a, b = h_card.rounds[0], h_host.rounds[0]
    e_loss = _rel(torch.tensor(a.client_loss), torch.tensor(b.client_loss))
    e_kl = _rel(torch.tensor(a.kl_loss), torch.tensor(b.kl_loss))
    e_par = [_rel(*(torch.cat([t[c].flatten().cpu() for t in tree_leaves(p)])
                    for p in (pop.client_params, host.client_params)))
             for c in range(K)]
    print(f"DP-DML (sigma {sigma}) round 1 without dropout, card "
          f"({secs:.3f} s) vs CPU from the same state and noise: "
          f"client_loss {_fmt(a.client_loss, '.7f')} vs "
          f"{_fmt(b.client_loss, '.7f')}; relative norm error client_loss "
          f"{e_loss:.3g}, kl_loss {e_kl:.3g}, params by client "
          f"{_fmt(e_par, '.3g')} (limit 1e-3)")
    if not (e_loss <= 1e-3 and e_kl <= 1e-3 and max(e_par) <= 1e-3):
        raise AssertionError("the DP-DML vision round on the card disagrees "
                             "with the CPU")
    del pop, host
    gc.collect()
    torch.cuda.empty_cache()

    def run(pop, strategy):
        fed = Federation(pop, strategy)
        walls = []
        for r in range(rounds):
            _, sec = _timed(lambda: fed.run(until=r + 1))
            walls.append(sec)
            rl = fed.history.rounds[-1]
            payload = len(pop.folds._folds[pop.folds._cursor - 1])
            if rl.comm_bytes != 2 * K * payload * 4 or \
                    not np.isfinite(rl.client_loss + rl.kl_loss).all():
                raise AssertionError(
                    f"{strategy.name} round {r}: comm_bytes {rl.comm_bytes} "
                    f"(DML's {2 * K * payload * 4}), losses "
                    f"{rl.client_loss} {rl.kl_loss}")
            if strategy.name == "dp-dml":
                e, want = strategy.epsilon(), _closed_epsilon(sigma, delta,
                                                              r + 1)
                eps.append(e)
                if abs(e - want) > 1e-9 * want:
                    raise AssertionError(f"epsilon {e} after round {r}, "
                                         f"closed form {want}")
        return fed.evaluate(split=(ex, ey)), walls

    # (2) DP-DML with the paper's dropout and the payload tap
    eps = []
    pop = VisionClients(cfg, tx, ty, record_payloads=True, **kw)
    h, walls = run(pop, DPDML(dp_noise_multiplier=sigma, dp_delta=delta))
    log = pop.payload_log
    ok = len(log) == rounds == len(pop.fold_log) and all(
        e["payloads"].shape == (1, K, len(e["public"])) and
        np.all((e["payloads"] >= 1e-4) & (e["payloads"] <= 1 - 1e-4))
        for e in log)
    single = gaussian_epsilon(sigma, delta)
    print(f"DP-DML (sigma {sigma}, clip 1, delta {delta}): epsilon after "
          f"each round {_fmt(eps, '.4f')} = the closed form S + 2 sqrt(S "
          f"log(1/delta)), S = n / (2 sigma^2) (one release: "
          f"{_closed_epsilon(sigma, delta, 1):.6f}, gaussian_epsilon "
          f"{single:.6f}); {len(log)} tapped payloads of (1, {K}, B_pub) "
          f"inside [1e-4, 1 - 1e-4]: {ok}; round wall mean after round 0 "
          f"{np.mean(walls[1:]):.4f} s; unseen accuracy "
          f"{_fmt(h.client_test_acc, '.4f')}")
    if not ok or abs(_closed_epsilon(sigma, delta, 1) - single) > 1e-9:
        raise AssertionError("the DP-DML payload tap or epsilon failed")
    walls_by = {"DP-DML": np.mean(walls[1:])}
    del pop, h, log
    gc.collect()

    # (3) one colluder in five against DML and the robust combiners
    byz = {K - 1: "collude"}
    honest = {}
    for label, strategy, b in (
            ("DML", DML(), None),
            ("DML, client 4 colluding", DML(), byz),
            ("TrimmedDML(trim=1), client 4 colluding", TrimmedDML(trim=1),
             byz),
            ("MedianDML, client 4 colluding", MedianDML(), byz)):
        pop = VisionClients(cfg, tx, ty, byzantine=b, **kw)
        h, walls = run(pop, strategy)
        honest[label] = float(np.mean(h.client_test_acc[:K - 1]))
        walls_by[label] = np.mean(walls[1:])
        print(f"{label}: {rounds} rounds, round wall mean after round 0 "
              f"{walls_by[label]:.4f} s; unseen accuracy "
              f"{_fmt(h.client_test_acc, '.4f')}, honest clients 0-3 "
              f"{honest[label]:.4f}")
        del pop, h
        gc.collect()
    dml = walls_by["DML"]
    print("round wall against DML's: " + ", ".join(
        f"{k} {v / dml:.3f}" for k, v in walls_by.items()))

    # (4) the JAX suite's two experiments, at its sizes
    acc = _byz_experiment(0)
    print(f"robust experiment (K = 4, 16 px, client 3 colluding), honest "
          f"clients' accuracy: {json.dumps(acc)}; the JAX suite asserts "
          f"poisoned <= clean - 0.25 ({acc['poisoned'] <= acc['clean'] - 0.25}"
          f") and trimmed, median >= clean - 0.02 "
          f"({min(acc['trimmed'], acc['median']) >= acc['clean'] - 0.02})"
          f"; asserted here: poisoned < clean, trimmed and median > "
          f"poisoned")
    if not (acc["poisoned"] < acc["clean"] and
            min(acc["trimmed"], acc["median"]) > acc["poisoned"]):
        raise AssertionError(f"the robust experiment's directions: {acc}")
    adv_fa, adv_dml, adv_dp = _mia_experiment(0)
    print(f"leakage experiment (K = 4, 16 px, 3 rounds of 20 local "
          f"epochs), MIA advantage: FedAvg weight upload {adv_fa:.4f}, DML "
          f"payloads {adv_dml:.4f}, DP-DML payloads {adv_dp:.4f}; the JAX "
          f"suite asserts FedAvg > DML + 0.1 ({adv_fa > adv_dml + 0.1}), "
          f"DP-DML <= DML + 0.08 ({adv_dp <= adv_dml + 0.08}), FedAvg > 0.2 "
          f"({adv_fa > 0.2}); asserted here: FedAvg > DML")
    if not adv_fa > adv_dml:
        raise AssertionError("the weight upload leaks no more than the "
                             "payloads")
    print(f"privacy vision peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB on {card}")
    counts = _kernel_counts()                     # ... and ends here
    if any(counts.values()):
        raise AssertionError(f"the vision path launched a kernel: {counts}")
    return counts


def phase_hetero_privacy(card: str, cfgs, B: int = 4, S: int = 512,
                         pub: int = 2, fold: int = 8, byz=None,
                         sigma: float = 1.0, delta: float = 1e-5) -> dict:
    """DP-DML and the robust combiners on a mixed fleet of four at full
    width (``cfgs``, one vocabulary), a sign-flipping client 3: 3 rounds of
    ``DPDML(sigma)`` (clip 1; the first warms the fleet's first calls up,
    the second gives the round wall, the third is profiled), 2 of
    ``TrimmedDML(trim=1)`` and 1 of ``MedianDML()``.  Each DP-DML round's
    Eq. 2 runs the pair kernels against the noised (1 of 4 rows poisoned)
    stack, M x E = 4 launches each way (one live row against J = 3); the
    robust rounds launch no Eq.-2 kernel (the consensus is plain PyTorch,
    as in the JAX package); every round the flash kernels.  Comm bytes are
    DML's (``comm_bytes_per_round``); epsilon is the accountant's closed
    form.  Then round 1 of DP-DML and of TrimmedDML from fresh fleets
    against the same round at impl "ref" (``_hetero_round_parity``; the
    same seeds, so the same noise), and each client's gradient by the
    parity rule (``_hetero_grad_parity``) against a DP release, and the
    trimmed consensus, of the kernel path's poisoned shared logits.
    Returns the kernels' launch counts over the main run."""
    from repro_torch.api import (DPDML, Federation, HeteroClients,
                                 MedianDML, TrimmedDML, comm_bytes_per_round,
                                 make_lm_pool)
    from repro_torch.configs import get_config
    from repro_torch.core.mutual import robust_categorical_target
    from repro_torch.privacy import dp as dp_mod
    from repro_torch.tree import tree_leaves

    K, V = len(cfgs), cfgs[0].vocab_size
    byz = byz or {K - 1: "sign-flip"}
    dp = DPDML(dp_noise_multiplier=sigma, dp_delta=delta)
    plan = [dp] * 3 + [TrimmedDML(trim=1)] * 2 + [MedianDML()]
    rounds = len(plan)
    pool, labels = make_lm_pool(((1 + K) * rounds + 1) * fold, S, V, seed=0)

    def population(impl):
        return HeteroClients(cfgs, pool, labels, rounds=rounds,
                             batch_size=B, public_batch=pub, seed=0,
                             kernel_impl=impl, byzantine=byz)

    torch.cuda.reset_peak_memory_stats()
    pop, secs = _timed(lambda: population(None))
    T, n_pub = pop._local_T, pop._pub_n * S
    tokens = K * (T * B + pop._pub_n) * S
    state_gb = sum(t.numel() * t.element_size() for t in
                   tree_leaves(pop.state_dict())) / 1e9
    print(f"privacy fleet of {K} at full width (seeded random weights), "
          f"V = {V}, byzantine {byz}: " + ", ".join(
              f"{c.name} ({pop._models[c.name].family}, {c.n_layers} of "
              f"{get_config(c.name).n_layers} layers, {n / 1e9:.3f} B)"
              for c, n in zip(cfgs, pop.n_params))
          + f"; {state_gb:.1f} GB of params and AdamW moments, {secs:.1f} s;"
          f" T = {T} local steps of ({B}, {S}) a client, public "
          f"({pop._pub_n}, {S}) = {n_pub} positions; {tokens} trained "
          f"tokens a round; kernels impl={pop.impl}")
    eq2 = ("kl_mutual_pair_fwd", "kl_mutual_pair_bwd", "kl_mutual_square_fwd",
           "kl_mutual_square_bwd", "sparse_kl_fwd", "sparse_kl_bwd")
    _kernel_counts(zero=True)                       # the main path starts here
    first_dp, walls, prof = None, {}, None
    for r, strategy in enumerate(plan):
        fed = Federation(pop, strategy)
        fed.round = r
        before = _kernel_counts()
        torch.cuda.reset_peak_memory_stats()
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        if r == 2:                                  # profile the 3rd DP round
            t0 = time.perf_counter()
            prof = device_spans(lambda: fed.run(until=r + 1))
            wall = time.perf_counter() - t0
        else:
            _, wall = _timed(lambda: fed.run(until=r + 1))
            walls.setdefault(strategy.name, []).append(wall)
        rl = fed.history.rounds[-1]
        ran = _delta(before, _kernel_counts())
        M = len(rl.participants)
        want = comm_bytes_per_round(M, n_pub, V, 1)["round"]
        is_dp = strategy.name == "dp-dml"
        need = ({"kl_mutual_pair_fwd": M, "kl_mutual_pair_bwd": M}
                if is_dp else {})
        eps = ""
        if is_dp:
            if first_dp is None:
                first_dp = rl
            e, e_want = dp.epsilon(), _closed_epsilon(sigma, delta, r + 1)
            eps = f"; epsilon {e:.4f} (closed form {e_want:.4f})"
            if abs(e - e_want) > 1e-9 * e_want:
                raise AssertionError(f"epsilon {e} after round {r}")
        print(f"{strategy.name} round {r}: {wall:.3f} s wall"
              f"{' (profiled)' if r == 2 else ''}, {tokens / wall:.0f} "
              f"trained tok/s; local loss {_fmt(rl.client_loss)} public_ce "
              f"{_fmt(rl.public_ce)} kl {_fmt(rl.kl_loss)}; comm_bytes "
              f"{rl.comm_bytes} (DML's {want}); launches {ran}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB allocated, "
              f"{torch.cuda.max_memory_reserved() / 1e9:.1f} GB reserved, "
              f"{torch.cuda.memory_stats().get('num_alloc_retries', 0) - retries}"
              f" allocator retries{eps}")
        if rl.comm_bytes != want or \
                {n: ran.get(n, 0) for n in eq2 if ran.get(n)} != need or \
                not all(ran.get(n) for n in ("flash_attention_fwd",
                                             "flash_attention_bwd")):
            raise AssertionError(f"{strategy.name} round {r} of the privacy "
                                 f"fleet left its kernels or its bytes")
        if not all(np.isfinite(x).all() for x in (rl.client_loss,
                                                  rl.public_ce, rl.kl_loss)):
            raise AssertionError("non-finite privacy-fleet losses")
    by_name, busy = prof
    steady = walls["dp-dml"][1]
    busy_us = sum(us for us, _ in by_name.values())
    print(f"privacy fleet on {card}: DP-DML round {steady:.3f} s wall (round "
          f"1, unprofiled) = {tokens / steady:.0f} trained tok/s; round 2: "
          f"{busy / 1e3:.1f} ms device busy (union of activities; "
          f"{busy_us / 1e3:.1f} ms summed) in "
          f"{sum(c for _, c in by_name.values())} kernels (profiled) -> "
          f"device idle {1 - busy / 1e6 / steady:.1%}; TrimmedDML "
          f"{_fmt(walls['trimmed-dml'], '.3f')} s, MedianDML "
          f"{_fmt(walls['median-dml'], '.3f')} s")
    _print_top(by_name, 1, "round", n=8)
    counts = _kernel_counts()                        # ... and ends here
    counts = {n: c for n, c in counts.items() if c}
    print(f"privacy fleet launches over {rounds} rounds: {counts}")

    # the parity: round 1 of each strategy from fresh fleets, and each
    # client's gradient at the initial weights
    inputs = pop._gather(pop.eval_fold)[0]
    cms = [pop._models[c.name] for c in cfgs]
    seeds = [pop._init_seed(c) for c in range(K)]
    del fed, pop
    gc.collect()
    torch.cuda.empty_cache()
    for make, main_first in ((lambda: DPDML(dp_noise_multiplier=sigma),
                              first_dp),
                             (lambda: TrimmedDML(trim=1), None)):
        if main_first is None:
            p = population(None)
            main_first = Federation(p, make()).run(until=1).rounds[0]
            del p
            gc.collect()
            torch.cuda.empty_cache()
        p = population("ref")
        ref_first = Federation(p, make()).run(until=1).rounds[0]
        del p
        gc.collect()
        torch.cuda.empty_cache()
        _hetero_round_parity(main_first, ref_first, make().name)
    with torch.no_grad():
        stack = []
        for cm, seed in zip(cms, seeds):
            p = cm.init(seed, "cuda")
            stack.append(cm.share_logits(p, inputs, impl="cuda"))
            del p
        stack = torch.stack(stack)
        for c, mode in byz.items():               # what a sign-flipper sends
            if mode == "sign-flip":
                stack[c] = -stack[c]
        key = np.array([0, 1], np.uint32)
        noise = dp_mod.gaussian(key, stack.shape, stack.device)
        noised = dp_mod.dp_noise_payload(stack, 1.0, sigma, noise)
        ms = {"the draw": time_ms(lambda: dp_mod.gaussian(
                  key, stack.shape, stack.device), iters=3),
              "the clip and noise": time_ms(lambda: dp_mod.dp_noise_payload(
                  stack, 1.0, sigma, noise), iters=3),
              "the trimmed consensus of J = 3": time_ms(
                  lambda: robust_categorical_target(stack[1:], "trimmed", 1),
                  iters=3),
              "the median consensus of J = 3": time_ms(
                  lambda: robust_categorical_target(stack[1:], "median", 1),
                  iters=3)}
        del noise
    print(f"the DP release and the robust consensus at the fleet's shapes "
          f"({tuple(stack.shape)} bf16): " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in ms.items()))
    limits = [2e-2 if cm.cfg.moe is None else None for cm in cms]
    print("per-client gradients of the mutual-step loss at the initial "
          "weights, DP-DML (received: a DP release of the kernel path's "
          "poisoned shared logits):")
    _hetero_grad_parity(cms, seeds, inputs, noised, 0, limits)
    del noised
    print("per-client gradients of the mutual-step loss at the initial "
          "weights, TrimmedDML(trim=1) (received: the kernel path's "
          "poisoned shared logits):")
    _hetero_grad_parity(cms, seeds, inputs, stack, 0, limits,
                        robust=("trimmed", 1))
    del stack, inputs
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_hetero_small_privacy(card: str, B: int = 4, S: int = 64,
                               rounds_each: int = 2) -> dict:
    """The reduced fleet of four (qwen3-4b, mamba2-780m, qwen3-4b,
    dbrx-132b at their reduced configs, fp32, vocab 512), client 3
    sign-flipping: ``rounds_each`` rounds of DPDML(1) (the pair kernels,
    M = 4 launches each way, and the flash and SSD kernels) then of
    MedianDML (the flash and SSD kernels, no Eq.-2 kernel), against the
    same rounds at impl "ref" (the same seeds, so the same noise): every
    round's losses within relative error 1e-3 and the final params within
    relative norm error 2e-2 a client.  Returns the kernels' launch
    counts."""
    from repro_torch.api import (DPDML, Federation, HeteroClients, MedianDML,
                                 make_lm_pool)

    archs = ("qwen3-4b", "mamba2-780m", "qwen3-4b", "dbrx-132b")
    K = len(archs)
    rounds = 2 * rounds_each
    pool, labels = make_lm_pool(((1 + K) * rounds + 1) * 8, S, 512, seed=0)
    mixers = ("flash_attention_fwd", "flash_attention_bwd", "ssd_scan_fwd",
              "ssd_scan_bwd")
    runs = {}
    _kernel_counts(zero=True)                        # the main path starts
    for impl in (None, "ref"):
        pop = HeteroClients(archs, pool, labels, rounds=rounds,
                            batch_size=B, public_batch=2, seed=0,
                            kernel_impl=impl, byzantine={K - 1: "sign-flip"})
        plan = [DPDML()] * rounds_each + [MedianDML()] * rounds_each
        logs = []
        for r, strategy in enumerate(plan):
            fed = Federation(pop, strategy)
            fed.round = r
            before = _kernel_counts()
            rl = fed.run(until=r + 1).rounds[-1]
            ran = _delta(before, _kernel_counts())
            logs.append(rl)
            if pop.impl != "cuda":
                continue
            pair = 0 if strategy.name == "median-dml" else K
            if ran.get("kl_mutual_pair_fwd", 0) != pair or \
                    ran.get("kl_mutual_pair_bwd", 0) != pair or \
                    not all(ran.get(n) for n in mixers):
                raise AssertionError(f"reduced privacy round {r} left its "
                                     f"kernels: {ran}")
            print(f"reduced fleet {archs} (fp32, client 3 sign-flipping) "
                  f"{strategy.name} round {r}: local loss "
                  f"{_fmt(rl.client_loss)} kl {_fmt(rl.kl_loss)}; launches "
                  f"{ran}")
        runs[pop.impl] = (logs, [_host(p) for p in pop.client_params])
        if pop.impl == "cuda":
            counts = {n: c for n, c in _kernel_counts().items() if c}
        del fed, pop
    (logs, params), (ref_logs, ref_params) = runs["cuda"], runs["ref"]
    worst = max(abs(a - b) / abs(b) for g, w in zip(logs, ref_logs)
                for f in ("client_loss", "public_ce", "kl_loss")
                for a, b in zip(getattr(g, f), getattr(w, f)))
    errs = [_tree_rel(p, q)[0] for p, q in zip(params, ref_params)]
    print(f"reduced privacy fleet, {rounds_each} DP-DML + {rounds_each} "
          f"MedianDML rounds, impl=cuda vs impl=ref: worst relative error "
          f"of the round logs {worst:.3g} (limit 1e-3); final params' "
          f"relative norm error per client {_fmt(errs, '.3g')} (limit 2e-2)")
    if worst > 1e-3 or max(errs) > 2e-2:
        raise AssertionError("the reduced privacy fleet disagrees with the "
                             "plain path")
    return counts


# ---------------------------------------------------------------------------
# phases 22-23: the client mesh

def _sharded_pair_call(K: int, n_dev: int):
    """Entry 0's side of the sharded step's Eq.-2 call at K clients over
    n_dev entries: its global ids (K_loc,) and its rows of
    ``_pair_mask(K_pad, pm)`` on the card, checked zero on each live
    client's own column and on the pad columns."""
    from repro_torch.core import stacking
    from repro_torch.core.mutual import _pair_mask
    k_loc, k_pad = stacking.client_layout(K, n_dev)
    gids = stacking.local_client_ids(K, n_dev, 0)
    pm = torch.zeros(k_pad)
    pm[:K] = 1.0
    w = _pair_mask(k_pad, pm)[gids].cuda()
    self_w = w[torch.arange(k_loc), gids.cuda()]
    if bool((self_w != 0).any()) or bool((w[:, K:] != 0).any()):
        raise AssertionError(f"pair weights not zero on self and pads: {w}")
    return gids, w


def phase_kl_sharded(B: int, V: int, n_dev: int = 2, checked=(3, 4),
                     timed: int = 4) -> list:
    """The Eq.-2 pair kernels as the sharded DML step calls them
    (``core.distributed.make_sharded_dml_step``, phase 22): entry 0's live
    public logits (K_loc, B, V) against the gathered fleet (K_pad, B, V)
    in natural order, the pads trailing (a dummy re-hosts a real client),
    with entry 0's rows of ``_pair_mask(K_pad, pm)``: zero on each live
    client's own column and on the pad columns.  Over 2 entries, K = 3
    and K = 4 are both Kl = 2 against J = 4; at K = 3 the pad column has
    weight zero in both rows.  At each K of ``checked``, fp32 and bf16
    through ``ops.mutual_kl_pair`` at impl "cuda" against impl "ref", the
    value and dlive (``phase_kl_received``'s tolerances; one pair forward
    and one pair backward, no square kernel).  Then the bf16 times at K =
    ``timed`` beside their bounds, which count the planes the function
    needs: the Kl live ones and the fixed columns some row weights
    nonzero, read by the forward; the backward reads them and writes
    dlive (Kl more).  Returns the pair kernels' rows at the timed call."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(11)
    errs = {}
    for K in checked:
        gids, w = _sharded_pair_call(K, n_dev)
        k_loc, k_pad = w.shape
        print(f"sharded Eq. 2 at K = {K} over {n_dev} entries: entry 0 "
              f"holds clients {gids.tolist()} (Kl = {k_loc}) against the "
              f"gathered fleet (J = K_pad = {k_pad}); weights {w.tolist()}")
        for dtype in (torch.float32, BF16):
            fleet = (2 * torch.randn(k_pad, B, V, device="cuda",
                                     generator=gen)).to(dtype)
            fleet[K:] = fleet[:k_pad - K]        # a dummy re-hosts client 0
            live = fleet[gids.cuda()]
            gbar = torch.randn(k_loc, B, device="cuda", generator=gen)
            res = []
            for impl in ("cuda", "ref"):
                a = live.detach().requires_grad_(True)
                before = _kernel_counts()
                out = ops.mutual_kl_pair(a, fleet, w, impl=impl)
                (g,) = torch.autograd.grad(out, a, gbar)
                after = _kernel_counts()
                ran = {n: after[n] - before[n] for n in after
                       if after[n] != before[n]}
                res.append((out.detach(), g.float(), ran))
                del a, out, g
            (out, dl, ran), (want, want_dl, ran_ref) = res
            f_err = (out - want).abs().max().item()
            f_rel = ((out - want).norm() / want.norm()).item()
            b_rel = ((dl - want_dl).norm() / want_dl.norm()).item()
            lim = 1e-4 if dtype == torch.float32 else 2e-2
            need = {"kl_mutual_pair_fwd": 1, "kl_mutual_pair_bwd": 1}
            if not (torch.allclose(out, want, atol=1e-3, rtol=1e-4)
                    and b_rel <= lim and ran == need and not ran_ref):
                raise AssertionError(
                    f"sharded Eq. 2 at K = {K}, {dtype}: forward max |err| "
                    f"{f_err:.3g}, relative {f_rel:.3g}; dlive relative "
                    f"{b_rel:.3g}; launched {ran} (ref {ran_ref})")
            print(f"sharded Eq. 2 at K = {K}, Kl={k_loc} against J={k_pad} "
                  f"(B={B}, V={V}) {str(dtype)[6:]}, impl=cuda vs impl=ref:"
                  f" forward max |err| {f_err:.3g} (relative {f_rel:.3g}), "
                  f"dlive relative {b_rel:.3g} (limit {lim}); launched "
                  f"{ran}")
            if K == timed:
                errs[dtype] = (f_err, (dl - want_dl).abs().max().item())
            del res, out, dl, want, want_dl, fleet, live, gbar
            torch.cuda.empty_cache()

    gids, w = _sharded_pair_call(timed, n_dev)
    k_loc, k_pad = w.shape
    used = int((w != 0).any(0).sum())
    fleet = (2 * torch.randn(k_pad, B, V, device="cuda", generator=gen)) \
        .to(BF16)
    live = fleet[gids.cuda()]
    gbar = torch.randn(k_loc, B, device="cuda", generator=gen)
    ms_f, ms_b, plain_fwd, plain_bwd, fb, bb = _pair_times(live, fleet, w,
                                                           gbar)
    for what, ms, plain, (bound, by) in (("forward", ms_f, plain_fwd, fb),
                                         ("backward", ms_b, plain_bwd, bb)):
        print(f"KL pair {what} at K = {timed}, Kl={k_loc} against J={k_pad}"
              f" ({used} columns weighted) at (B={B}, V={V}) bf16: "
              f"{ms:.4f} ms, plain {plain:.4f} ms; bound {bound:.4f} ms by "
              f"{by} ({bound / ms:.0%} of it)")
    del fleet, live, gbar
    torch.cuda.empty_cache()
    src = "src/repro_torch/kernels/csrc/kl_mutual_pair.cu"
    row = dict(route="cuda", source=src, launches=None, library_ms=None)
    return [
        {"name": "kl_mutual_pair_fwd", **row,
         "replaces": "src/repro/kernels/kl_mutual.py:68",
         "max_abs_err": errs[BF16][0], "ms": ms_f, "plain_ms": plain_fwd,
         "bound_ms": fb[0], "bound_by": fb[1]},
        {"name": "kl_mutual_pair_bwd", **row,
         "replaces": "src/repro/kernels/kl_mutual.py:178",
         "max_abs_err": errs[BF16][1], "ms": ms_b, "plain_ms": plain_bwd,
         "bound_ms": bb[0], "bound_by": bb[1]},
    ]


def _pair_times(live, fixed, w, gbar) -> tuple:
    """The pair kernels on live (Kl, B, V) against fixed (J, B, V) with
    (Kl, J) weights ``w`` and cotangent ``gbar``: (forward ms, backward
    ms, the plain version's forward and backward ms (autograd of
    ``ref.mutual_kl_pair``, fwd+bwd - fwd), the forward's and the
    backward's (bound ms, bound by)).  The bounds count the planes the
    function needs: the live ones and the fixed columns some row weights
    nonzero, read by the forward; the backward reads them and writes
    dlive.  Raises if the call leaves the pair kernel."""
    from repro_torch.kernels import kl_mutual, ref
    k_loc, B, V = live.shape
    used = int((w != 0).any(0).sum())
    out, zl, zf, name = kl_mutual._forward(live, fixed, w, 1.0)
    if name != kl_mutual.PAIR:
        raise AssertionError(f"the call left the pair kernel: {name}")
    ms_f = time_ms(lambda: kl_mutual._forward(live, fixed, w, 1.0))
    ms_b = time_ms(lambda: kl_mutual._backward(live, fixed, w, out, zl, zf,
                                               gbar, 1.0, False))
    a = live.detach().requires_grad_(True)

    def plain_f():
        with torch.no_grad():
            ref.mutual_kl_pair(a, fixed, w)

    def plain_fb():
        torch.autograd.grad(ref.mutual_kl_pair(a, fixed, w), a, gbar)
    plain_fwd = time_ms(plain_f, iters=5)
    plain_bwd = time_ms(plain_fb, iters=5) - plain_fwd
    plane = B * V * live.element_size()
    fb = _bound(_kl_ops(k_loc, used, B, V), (k_loc + used) * plane,
                torch.float32)
    bb = _bound(_kl_bwd_ops(k_loc, used, B, V), (2 * k_loc + used) * plane,
                torch.float32)
    del out, zl, zf, a
    return ms_f, ms_b, plain_fwd, plain_bwd, fb, bb


def _sync_all() -> None:
    """Wait for every visible card (a mesh of distinct cards ends a round
    with work still queued on the others)."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _peak_gb(devices) -> list:
    """The peak memory allocated since the last reset, GB, on each distinct
    device of ``devices`` in order."""
    return [round(torch.cuda.max_memory_allocated(d) / 1e9, 1)
            for d in dict.fromkeys(devices)]


def _reset_peaks(devices) -> None:
    for d in dict.fromkeys(devices):
        torch.cuda.reset_peak_memory_stats(d)


def _rel_norm(host, dev) -> float:
    """||host - dev|| / ||dev|| over matching lists of tensors, ``host`` on
    the CPU crossing to ``dev``'s device one tensor at a time."""
    num = den = 0.0
    for a, b in zip(host, dev):
        a, b = a.to(b.device).float(), b.float()
        num += float((a - b).square().sum())
        den += float(b.square().sum())
    return (num / den) ** 0.5


def _slot_state(params, opts, slot) -> list:
    """Host copies of one entry slot's params and AdamW moments."""
    from repro_torch.tree import tree_leaves
    d, i = slot
    return [t[i].cpu() for tree in (params[d], opts[d]["mu"], opts[d]["nu"])
            for t in tree_leaves(tree)]


def phase_sharded_train(card: str, cfg, K: int, B: int = 4, S: int = 512,
                        rounds: int = 3,
                        devices=("cuda:0", "cuda:0")) -> dict:
    """The client mesh's training path: ``Federation(LMClients(cfg, K,
    mesh=ClientMesh(devices)), DML())`` at the full width of ``cfg``
    (depth as given).  By default two entries of the one card, K_loc
    clients each (K = 3: a dummy slot on entry 1); ``devices`` distinct
    cards give each card its own entry, the unsharded comparisons running
    on the first.  Round 1's metrics and each
    client's gradient are taken first through the sharded step
    (``value_and_grad``, no update); then ``rounds`` rounds at impl "cuda"
    (the first warms up, the last is profiled): each entry's private and
    public forwards through the flash kernels, one gather of the public
    logits, and each entry's Eq. 2 through the pair kernels at (K_loc,
    K_pad): one pair forward and backward per entry a round, no square
    kernel.  Then a fourth update with client 1 absent: its slot and the
    dummy slot keep their params and moments bit for bit.  Round 1 is
    held against the sharded step at impl "ref" (its metrics and each
    client's gradient) and against the unsharded ``make_dml_train_step``
    through the kernels: both steps run round 1's whole update at
    ``clip_norm=None`` from the same seeded state, and their metrics,
    every client's gradient (the unsharded one read from its first
    moment, (1 - b1) g at step 1) and client 1's updated params and
    moments are compared, the sharded client's slice on the host.  The
    limits: metrics within relative 2e-2, bf16 gradients and state within
    relative norm error 2e-2, the parity rule's bf16 clause for a dense
    path of at most 4 layers.  Its fp32 clauses hold the kernels
    themselves: phase 2 the pair kernels at this call, phase 4 the flash
    kernels at these widths.  Returns the kernels' launch counts over the
    rounds."""
    from repro_torch.api import DML, Federation, LMClients
    from repro_torch.configs import get_config
    from repro_torch.core import distributed as D
    from repro_torch.core import stacking
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding import ClientMesh
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    mesh = ClientMesh(devices)
    n = mesh.size
    k_loc, k_pad = stacking.client_layout(K, n)
    B_pub = max(1, B // 2)
    _reset_peaks(mesh.devices)
    pop, secs = _timed(lambda: LMClients(
        cfg, n_clients=K, rounds=rounds + 1, batch=B, seq=S, seed=0,
        mesh=mesh))
    state_gb = sum(t.numel() * t.element_size() for t in
                   tree_leaves(pop.state_dict())) / 1e9
    print(f"sharded DML: {K} x {cfg.name} clients, {cfg.n_layers} of "
          f"{get_config(cfg.name).n_layers} layers at full width (seeded "
          f"random weights), over a mesh of {n} entries "
          f"({mesh.devices}): K_loc {k_loc}, K_pad {k_pad} "
          f"({k_pad - K} dummy slots); {pop.params_per_client / 1e9:.3f} B "
          f"params a client, {state_gb:.1f} GB of params and AdamW moments; "
          f"init {secs:.1f} s; kernels impl={pop.impl}")
    inputs = _round0_inputs(pop)
    tokens, pub = inputs["tokens"], inputs["public_tokens"]
    step = pop._dml_step(1.0, 0)
    _, g_cuda = step.value_and_grad(pop._to_mesh()[0], tokens, pub,
                                    device="cpu")

    fed = Federation(pop, DML())
    _kernel_counts(zero=True)                     # the main path starts here
    trained = K * (B + B_pub) * S
    walls = []
    for r in range(rounds):
        _reset_peaks(mesh.devices)
        if r == rounds - 1:
            (by_name, union), wall = _timed(lambda: device_spans(
                lambda: (fed.run(until=r + 1), _sync_all())))
        else:
            _, wall = _timed(lambda: (fed.run(until=r + 1), _sync_all()))
            walls.append(wall)
        rl = fed.history.rounds[-1]
        print(f"sharded round {r}: {wall:.3f} s wall"
              f"{' (profiled)' if r == rounds - 1 else ''}, "
              f"{trained / wall:.0f} trained tok/s; private_loss "
              f"{_fmt(rl.client_loss)} public_ce {_fmt(rl.public_ce)} "
              f"kld_avg {_fmt(rl.kl_loss)}; peak memory "
              f"{_peak_gb(mesh.devices)} GB")
    counts = _kernel_counts()                     # ... and ends here
    need = {"flash_attention_fwd": n * 2 * 2 * cfg.n_layers * rounds,
            "flash_attention_bwd": n * 2 * cfg.n_layers * rounds,
            "kl_mutual_pair_fwd": n * rounds,
            "kl_mutual_pair_bwd": n * rounds,
            "adamw_fused": n * rounds}
    exact = ("kl_mutual_pair_fwd", "kl_mutual_pair_bwd", "adamw_fused")
    ran = {k: v for k, v in counts.items() if v}
    print(f"sharded training launches {ran}; need {need} exactly for the "
          f"pair kernels and the fused AdamW's update (one a round per "
          f"entry) and at least for flash, and no square or sparse kernel")
    if any(counts[k] < v for k, v in need.items()) or \
            any(counts[k] != need[k] for k in exact) or \
            set(ran) - set(need):
        raise AssertionError("the sharded round left its kernels")
    hist = fed.history.rounds
    if not all(np.isfinite(x).all() for rl in hist
               for x in (rl.client_loss, rl.public_ce, rl.kl_loss)):
        raise AssertionError("non-finite sharded training losses")
    steady = walls[-1]
    busy_us = sum(us for us, _ in by_name.values())
    n_dist = len(set(mesh.devices))
    gathered = n_dist * k_pad * B_pub * S * cfg.vocab_size * 2
    comm = D.comm_bytes(cfg, K, B_pub * S)["dml_round"]
    # idle is the one card's; over distinct cards the busy time is their sum
    idle = f"device idle {1 - union / 1e6 / steady:.1%}" if n_dist == 1 \
        else f"{busy_us / 1e3 / n_dist:.1f} ms busy a card, idle not measured"
    print(f"sharded train round on {card}: {steady:.3f} s wall (round "
          f"{rounds - 2}, unprofiled) = {trained / steady:.0f} trained tok/s;"
          f" round {rounds - 1}: {busy_us / 1e3:.1f} ms device busy, "
          f"{union / 1e3:.1f} ms with one running -> {idle}; gathered "
          f"{gathered / 1e9:.3f} GB "
          f"a round (K_pad x B_pub*S x V bf16 onto each of {n_dist} distinct "
          f"devices) against "
          f"comm_bytes' dml_round {comm / 1e9:.3f} GB (sent and received by "
          f"K clients); history comm {hist[-1].comm_bytes} bytes")
    _print_top(by_name, 1, "round", n=6)

    # a fourth update with client 1 absent: its slot and the dummies hold
    params, opts = pop._to_mesh()
    slots = [(1 % n, 1 // n)] + [(d, i) for d in range(n)
                                 for i in range(k_loc) if i * n + d >= K]
    before = [_slot_state(params, opts, sl) for sl in slots]
    pm = [1.0] * K
    pm[1] = 0.0
    step.on_entries(params, opts, pop._private_batch(rounds),
                    pop._public_batch(rounds), part_mask=pm)
    same = [all(torch.equal(a, b) for a, b in
                zip(was, _slot_state(params, opts, sl)))
            for was, sl in zip(before, slots)]
    print(f"an update with client 1 absent: slots (entry, slot) {slots} "
          f"(client 1, then the dummies) unchanged bit for bit: {same}")
    if not all(same):
        raise AssertionError("an absent or dummy slot moved")
    first = hist[0]
    noclip = dataclasses.replace(pop.opt_cfg, clip_norm=None)
    del fed, pop, params, opts, before, step
    gc.collect()
    torch.cuda.empty_cache()

    # round 1 against impl "ref" (the sharded step on the plain versions)
    _reset_peaks(mesh.devices)
    ref_step = D.make_sharded_dml_step(cfg, AdamWConfig(), mesh, K,
                                       impl="ref")
    m_ref, g_ref = ref_step.value_and_grad(stacking.to_entries(
        D.stacked_init(0, cfg, K, device="cuda"), K, mesh.devices), tokens,
        pub)
    e_ref = _client_grad_errors(g_cuda, g_ref, K)
    del g_ref
    gc.collect()
    torch.cuda.empty_cache()

    # ... and round 1's whole update at clip_norm=None, sharded and then
    # unsharded, each from the seeded state; client c's updated slice of
    # the sharded state crosses to the host
    c = 1
    sh_step = D.make_sharded_dml_step(cfg, noclip, mesh, K, impl="cuda")
    params = stacking.to_entries(D.stacked_init(0, cfg, K, device="cuda"),
                                 K, mesh.devices)
    opts = [D.stacked_adamw_init(p) for p in params]
    m_sh = sh_step.on_entries(params, opts, tokens, pub)
    n_leaves = len(tree_leaves(params[0]))
    s_sh = _slot_state(params, opts, (c % n, c // n))
    del params, opts, sh_step
    gc.collect()
    torch.cuda.empty_cache()
    p_un = D.stacked_init(0, cfg, K, device="cuda")
    o_un = D.stacked_adamw_init(p_un)
    _, _, m_un = D.make_dml_train_step(cfg, noclip, impl="cuda")(
        p_un, o_un, tokens, pub)
    e_un = _client_grad_errors(g_cuda, o_un["mu"], K, scale=1 - noclip.b1)
    s_un = [t[c] for tree in (p_un, o_un["mu"], o_un["nu"])
            for t in tree_leaves(tree)]
    e_state = [_rel_norm(s_sh[k * n_leaves:(k + 1) * n_leaves],
                         s_un[k * n_leaves:(k + 1) * n_leaves])
               for k in range(3)]
    del p_un, o_un, s_un, s_sh
    gc.collect()
    torch.cuda.empty_cache()
    rel = lambda a, b: abs(a - b) / abs(b)                  # noqa: E731
    worst = {}
    for what, got, m in (("round 1 vs unsharded", first, m_un),
                         ("round 1 vs sharded impl=ref", first, m_ref),
                         ("sharded vs unsharded update", None, m_un)):
        mine = (m_sh["private_loss"].tolist(), m_sh["public_ce"].tolist(),
                m_sh["kld_avg"].tolist()) if got is None else \
            (got.client_loss, got.public_ce, got.kl_loss)
        worst[what] = {
            "private_loss": max(map(rel, mine[0], m["private_loss"].tolist())),
            "public_ce": max(map(rel, mine[1], m["public_ce"].tolist())),
            "kld_avg": max(abs(a - b) / (abs(b) + 0.05) for a, b in
                           zip(mine[2], m["kld_avg"].tolist()))}
    gn = float(torch.sqrt(torch.sum(torch.square(m_sh["grad_norm"]))))
    worst["sharded vs unsharded update"].update(
        grad_norm=rel(gn, float(m_un["grad_norm"])),
        lr=rel(float(m_sh["lr"]), float(m_un["lr"])))
    print(f"sharded round 1 (impl=cuda) against the unsharded step and the "
          f"sharded step at impl=ref: worst relative error {worst} (limit "
          f"2e-2; kld_avg within 2e-2 |ref| + 1e-3; the fleet's grad norm "
          f"from the per-client ones); per-client gradients in bf16, "
          f"relative norm error against the unsharded impl=cuda ones "
          f"{_fmt(e_un, '.4g')} and against the sharded impl=ref ones "
          f"{_fmt(e_ref, '.4g')}; client {c} after the update at "
          f"clip_norm=None, sharded against unsharded: params, mu, nu "
          f"{_fmt(e_state, '.4g')} (limit 2e-2); peak memory "
          f"{_peak_gb(mesh.devices)} GB")
    if not (all(v <= 2e-2 for w in worst.values() for v in w.values())
            and max(e_un + e_ref + e_state) <= 2e-2):
        raise AssertionError("the sharded round disagrees with the "
                             "unsharded step or the plain path")
    del g_cuda
    gc.collect()
    torch.cuda.empty_cache()
    print(f"sharded DML at K = {K}: {time.perf_counter() - t_phase:.1f} s "
          f"of command time")
    return counts


def phase_vision_mesh(card: str, cfg=None, K: int = 5, n_rounds: int = 2,
                      rounds: int = 12, epochs: int = 3, B: int = 16,
                      lr: float = 0.05,
                      devices=("cuda:0", "cuda:0")) -> dict:
    """Phase 9's VisionNet protocol (full width, K = 5, the paper's
    datasets and schedule, fp32 with TF32 off) over a client mesh of
    ``devices``, by default two entries of the card: K_loc 4, K_pad 8,
    three dummy slots.  For each of
    ``DML()``, ``FedAvg()`` and ``AsyncWeights(delta=2, min_round=0)``
    (shallow, then deep), ``n_rounds`` rounds with the paper's dropout of
    the sharded population and of an unsharded one loaded with its state,
    both on cuDNN's deterministic algorithms: the first round's client_loss
    and kl_loss within relative norm error 1e-4 (phase 9's limit), the
    second's within 1e-3, and after the rounds each client's params within
    1e-3 (phase 9's).  The two engines draw the same dropout masks, but
    their convolutions run at other group counts, and training amplifies
    the rounding: the second round's losses differ by ~2e-4, on the CPU
    as on the card (phase 9: the losses amplify the params' rounding).
    Then each weight sync alone, from one state in both layouts, must give
    the same bits.  Round walls beside phase 9's; no kernel of this repo
    runs: returns every launch count, all 0."""
    from repro_torch.api import (DML, AsyncWeights, FedAvg, Federation,
                                 VisionClients)
    from repro_torch.configs.visionnet import CONFIG
    from repro_torch.sharding import ClientMesh
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    cfg = cfg or CONFIG
    mesh = ClientMesh(devices)
    (tx, ty), _ = _paper_datasets(cfg.image_size, 3833, 5988)
    kw = dict(n_clients=K, rounds=rounds, local_epochs=epochs, batch_size=B,
              lr=lr)
    clone = lambda pop: tree_map(torch.clone, pop.state_dict())  # noqa: E731
    _kernel_counts(zero=True)                     # the main path starts here
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for make in (DML, FedAvg, lambda: AsyncWeights(delta=2,
                                                       min_round=0)):
            a = VisionClients(cfg, tx, ty, mesh=mesh, **kw)
            b = VisionClients(cfg, tx, ty, **kw)
            b.load_state_dict(clone(a), a.meta_dict())
            fa, fb = Federation(a, make()), Federation(b, make())
            name = fa.strategy.name
            walls = {"sharded": [], "unsharded": []}
            e_loss, lims = [], []
            for r in range(n_rounds):
                walls["sharded"].append(_timed(
                    lambda: (fa.run(until=r + 1), _sync_all()))[1])
                walls["unsharded"].append(_timed(
                    lambda: fb.run(until=r + 1))[1])
                ra, rb = fa.history.rounds[-1], fb.history.rounds[-1]
                for x, y in ((ra.client_loss, rb.client_loss),
                             (ra.kl_loss, rb.kl_loss)):
                    y = torch.tensor(y)
                    if float(y.norm()):
                        e_loss.append(_rel(torch.tensor(x), y))
                        lims.append(1e-4 if r == 0 else 1e-3)
                if ra.comm_bytes != rb.comm_bytes:
                    raise AssertionError(f"{name}: comm bytes differ")
            e_par = [_rel(*(torch.cat([t[c].flatten().cpu()
                                       for t in tree_leaves(p)])
                            for p in (a.client_params, b.client_params)))
                     for c in range(K)]
            print(f"vision on a mesh of {mesh.size} entries "
                  f"({len(set(mesh.devices))} devices), {name}: round walls "
                  f"sharded {_fmt(walls['sharded'], '.4f')} s, unsharded "
                  f"{_fmt(walls['unsharded'], '.4f')} s; losses' relative "
                  f"norm error {_fmt(e_loss, '.3g')} (limits "
                  f"{_fmt(lims, '.0e')}), params "
                  f"by client after {n_rounds} rounds {_fmt(e_par, '.3g')} "
                  f"(limit 1e-3)")
            if any(e > lim for e, lim in zip(e_loss, lims)) or \
                    max(e_par) > 1e-3:
                raise AssertionError(f"the sharded {name} rounds disagree "
                                     f"with the unsharded engine")
            if name != "dml":
                # the sync alone from one state, sharded and not: one bits
                c = VisionClients(cfg, tx, ty, mesh=mesh, **kw)
                for pop in (c, b):
                    pop.load_state_dict(clone(b), b.meta_dict())
                    pop._last_folds = b._last_folds
                c._to_mesh()
                part, pm = list(range(K)), np.ones(K, np.float32)
                for pop in (c, b):
                    if name == "fedavg":
                        pop.fedavg_combine(part, pm)
                    else:
                        pop.async_combine(n_rounds, part, pm, 2, 0,
                                          pop.weights_payload(n_rounds))
                sa, sb = c.state_dict(), b.state_dict()
                same = all(torch.equal(x, y) for x, y in
                           zip(tree_leaves(sa), tree_leaves(sb)))
                print(f"  {name}'s sync alone from one state, gathered "
                      f"from the mesh and unsharded: the same bits {same}")
                if not same:
                    raise AssertionError(f"the {name} sync differs on the "
                                         f"mesh")
                del c
            del fa, fb, a, b
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    counts = _kernel_counts()                     # ... and ends here
    if any(counts.values()):
        raise AssertionError(f"the vision mesh launched a kernel: {counts}")
    print(f"vision mesh peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB on {card}; "
          f"{time.perf_counter() - t_phase:.1f} s of command time")
    return counts


# ---------------------------------------------------------------------------
# phase 24: the dry-run against the card, the examples

def phase_tooling(card: str, tcfg, K: int, B: int, S: int) -> dict:
    """Phase 24.  (a) Phase 4's round (``make_dml_train_step`` of K
    ``tcfg`` clients, batch B, public B // 2, seq S, LMClients' AdamW and
    DML()'s weight) counted on the meta device by ``launch.dryrun.count``
    and run on the card at impl "ref" under ``FlopCounterMode``: the FLOP
    counts agree to 1e-6 (one aten program).  (b) The dry-run's peak bytes
    against the card's ``max_memory_allocated`` over that round, less
    what was allocated before it: within 0.8-1.25x.  (c)
    ``launch.quickstart`` and ``launch.serve_lm`` on the card, whose
    kernel launches are this path's.  Returns (c)'s launch counts."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.api import DML
    from repro_torch.launch import dryrun, quickstart, serve_lm
    from repro_torch.optim import AdamWConfig
    from repro_torch.tree import tree_leaves

    pub = max(1, B // 2)
    # LMClients' optimiser at phase 4's 3 rounds; DML()'s Eq.-1 weight
    kw = dict(opt_cfg=AdamWConfig(lr=1e-3, warmup=5, total_steps=3),
              kl_weight=DML().kl_weight)
    fn, args = dryrun.dml_case(tcfg, K, B, pub, S, **kw)
    t0 = time.perf_counter()
    with dryrun.count() as meta:
        out = fn(*args)
    meta_secs = time.perf_counter() - t0
    del fn, args, out
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    fn, args = dryrun.dml_case(tcfg, K, B, pub, S, device="cuda", **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        (_, _, m), secs = _timed(lambda: fn(*args))
    card_peak = torch.cuda.max_memory_allocated() - base
    card_flops = fc.get_total_flops()
    if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(m)
               if isinstance(t, torch.Tensor)):
        raise AssertionError("the impl-ref round's metrics are not finite")
    del fn, args, m
    gc.collect()
    torch.cuda.empty_cache()
    rel = abs(meta.flops - card_flops) / card_flops
    print(f"phase 4's round (K={K} x {tcfg.name} at {tcfg.n_layers} layers, "
          f"B {B}, public {pub}, S {S}, impl ref): FLOPs on the meta device "
          f"{meta.flops} ({meta_secs:.1f} s on the host), on the card under "
          f"FlopCounterMode {card_flops} ({secs:.2f} s): relative "
          f"difference {rel:.3g} (limit 1e-6)")
    if rel > 1e-6:
        raise AssertionError("the meta count and the card's disagree")
    ratio = meta.peak_bytes / card_peak
    print(f"  memory: dry-run peak {meta.peak_bytes / 1e9:.3f} GB (arguments "
          f"{meta.argument_bytes / 1e9:.3f}, outputs "
          f"{meta.output_bytes / 1e9:.6f}, temporaries "
          f"{meta.temp_bytes / 1e9:.3f}) against the card's "
          f"max_memory_allocated {card_peak / 1e9:.3f} GB over the round: "
          f"{ratio:.3f}x (limit 0.8-1.25x)")
    if not 0.8 <= ratio <= 1.25:
        raise AssertionError("the dry-run's peak memory is off the card's")

    _kernel_counts(zero=True)                       # the path starts here
    t0 = time.perf_counter()
    if quickstart.main([]) != 0:
        raise AssertionError("launch.quickstart failed")
    t1 = time.perf_counter()
    if serve_lm.main([]) != 0:
        raise AssertionError("launch.serve_lm failed")
    counts = {n: c for n, c in _kernel_counts().items() if c}
    print(f"examples on the card: quickstart {t1 - t0:.1f} s, serve_lm "
          f"{time.perf_counter() - t1:.1f} s; launches {counts}")
    short = [n for n in ("flash_attention_fwd", "flash_attention_bwd",
                         "kl_mutual_square_fwd", "kl_mutual_square_bwd",
                         "ssd_scan_fwd") if not counts.get(n)]
    if short:
        raise AssertionError(f"the examples did not run through {short}")
    return counts


# ---------------------------------------------------------------------------
# phase 25: the data x model mesh

DM_COLLECTIVES = ("all_gather_into_tensor", "all_reduce",
                  "reduce_scatter_tensor", "all_to_all_single")
# phase 25's limits on each leaf, sharded against unsharded: the relative
# norm error of the update (after - before) and of the first moment.  On
# the H100, full-width 2-layer qwen3-4b in bf16, the sound programs read at
# most 0.149 and 0.0197 a leaf and the half-batch control at least 0.635
# and 0.509 (Adam's first steps are near sign(g): a gradient near 0 whose
# sign flips moves a whole step); each limit is near the geometric mean
DM_UPDATE_LIMIT = 0.3
DM_MU_LIMIT = 0.1


def _dm_collectives(dev) -> dict:
    """Which of the four collectives the process group takes on tensors of
    ``dev``, each checked against its expected values: "ok", or the
    refusal's first line."""
    import torch.distributed as dist
    n, r = dist.get_world_size(), dist.get_rank()
    x = torch.arange(2 * n, dtype=torch.float32, device=dev) + 100 * r
    ranks = torch.arange(n, dtype=torch.float32, device=dev)

    def gather():
        out = torch.empty(2 * n * n, device=dev)
        dist.all_gather_into_tensor(out, x)
        want = (torch.arange(2 * n, device=dev)[None] + 100 * ranks[:, None])
        return torch.equal(out, want.reshape(-1))

    def reduce():
        y = x.clone()
        dist.all_reduce(y)
        return torch.equal(y, n * torch.arange(2 * n, device=dev)
                           + 100 * ranks.sum())

    def scatter():
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, x)
        return torch.equal(out, n * torch.arange(2 * r, 2 * r + 2,
                                                 device=dev)
                           + 100 * ranks.sum())

    def to_all():
        out = torch.empty(2 * n, device=dev)
        dist.all_to_all_single(out, x)
        want = torch.arange(2 * r, 2 * r + 2, device=dev)[None] \
            + 100 * ranks[:, None]
        return torch.equal(out, want.reshape(-1))

    out = {}
    for name, fn in zip(DM_COLLECTIVES, (gather, reduce, scatter, to_all)):
        try:
            out[name] = "ok" if fn() else "wrong values"
        except Exception as e:  # noqa: BLE001 - a refusal is the answer
            out[name] = f"{type(e).__name__}: {e}".splitlines()[0][:160]
    return out


def _full(v):
    """A metric as a host float tensor: a DTensor gathered (every rank
    takes part), a plain tensor copied."""
    from torch.distributed.tensor import DTensor
    if isinstance(v, DTensor):
        v = v.full_tensor()
    return v.detach().float().cpu()


def _dm_paths(cfg, K: int, B: int, S: int, sparse_k: int, steps: int):
    """The programs of phase 25, each a dict: ``name``; ``mesh``, the mesh
    it runs on ("data_model", (data 2, model 2), or "pod", (pod 2, data
    1, model 2)); ``rules``, the axis rules it is placed and run under;
    ``build(dev, mesh)``, which draws the params (seed 0, on the card)
    and, with a mesh, distributes them by their logical axes; ``run(params,
    dev, mesh, half=False)``, which steps them from zero moments and
    returns (params, optimizer state, metrics per step as the step returns
    them, step walls); ``held``: its leaves are held to the limits and a
    half-batch control must fail every leaf (else the readings are
    printed only, with no control run); ``routes``: its MoE routes are
    logged sharded and unsharded; ``need``: the kernels it must launch.
    ``half`` runs the program on the first half of every batch: the
    control that the comparison must reject (a gradient that misses half
    the rows, as a partial sum left unreduced over the data axis would).

    qwen3-4b (``cfg``, full width, bf16): ``steps`` train steps of B x S,
    a fused DML round and a SparseDML round (k = ``sparse_k``) of K
    clients (private B, public B // 2).  Then (all full width, impl
    "cuda", one step each): M1 qwen2-moe-a2.7b at 1 layer (its period) in
    fp32, a train step (the flash fp32 path; with TF32 off the sharded and
    unsharded routes should agree); M2 the same at bf16, a DML round of K
    clients (printed, not held: a bf16 route flip moves a whole expert's
    gradient); M3 mamba2-780m at 2 layers, a train step (the SSD scan on
    each rank's (batch, heads) shard); M4 qwen3-4b's DML round with the
    clients on the pod axis (``spmd_client_axis="pod"``, the dry-run's DML
    rules), whose Eq.-2 term runs the rectangular pair kernels, one live
    client against both."""
    from repro_torch import sharding as shd
    from repro_torch.configs import get_config
    from repro_torch.core import distributed as D
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as st
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import AdamWConfig, adamw_init

    # LMClients' optimiser and DML()'s Eq.-1 weight, as phase 24's
    opt_cfg = AdamWConfig(lr=1e-3, warmup=5, total_steps=3)
    pub = max(1, B // 2)
    moe32 = get_config("qwen2-moe-a2.7b").replace(
        n_layers=1, param_dtype="float32", compute_dtype="float32")
    moe16 = get_config("qwen2-moe-a2.7b").replace(n_layers=1)
    ssm = get_config("mamba2-780m").replace(n_layers=2)

    def draw(V, seed, n_train):
        gen = torch.Generator().manual_seed(seed)
        return {"train": [torch.randint(0, V, (B, S), generator=gen)
                          for _ in range(n_train)],
                "tokens": torch.randint(0, V, (K, B, S), generator=gen),
                "public": torch.randint(0, V, (pub, S), generator=gen)}

    def put(t, axes, dev, mesh):
        t = t.to(dev, torch.int32)
        return shd.distribute(t, axes, mesh) if mesh is not None else t

    def build(c, stacked):
        def fn(dev, mesh):
            if stacked:
                params = D.stacked_init(0, c, K, device=dev)
                axes = D.stacked_logical_axes(c)
            else:
                params = tfm.init_model(0, c, device=dev)
                axes = tfm.logical_axes(c)
            if mesh is not None:
                params = shd.distribute_tree(params, axes, mesh)
            return params
        return fn

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def train(c, data):
        def run(params, dev, mesh, half=False):
            step = st.make_train_step(c, opt_cfg, impl="cuda")
            opt = adamw_init(params)
            ms, walls = [], []
            for toks in data["train"]:
                x = put(toks[:B // 2] if half else toks, ("batch", "seq"),
                        dev, mesh)
                (params, opt, m), secs = timed(lambda: step(params, opt, x))
                ms.append({k: v for k, v in m.items() if k != "lr"})
                walls.append(secs)
            return params, opt, ms, walls
        return run

    def dml(c, data, sk, client_axis=None):
        def run(params, dev, mesh, half=False):
            step = D.make_dml_train_step(c, opt_cfg, sparse_k=sk,
                                         spmd_client_axis=client_axis,
                                         impl="cuda")
            opt = adamw_init(params)
            toks, public = data["tokens"], data["public"]
            if half:
                toks, public = toks[:, :B // 2], public[:max(1, pub // 2)]
            x = put(toks, ("client", "batch", "seq"), dev, mesh)
            p = put(public, ("batch", "seq"), dev, mesh)
            (params, opt, m), secs = timed(lambda: step(params, opt, x, p))
            return params, opt, [{k: m[k] for k in (
                "private_loss", "public_ce", "kld_avg", "grad_norm")}], [secs]
        return run

    qwen = draw(cfg.vocab_size, 25, steps)
    flash = ("flash_attention_fwd", "flash_attention_bwd")
    square = flash + ("kl_mutual_square_fwd", "kl_mutual_square_bwd")
    one = dict(mesh="data_model", rules={}, held=True, routes=False,
               need=flash)
    return [
        dict(one, name="train", cfg=cfg, build=build(cfg, False),
             run=train(cfg, qwen)),
        dict(one, name="dml", cfg=cfg, build=build(cfg, True),
             run=dml(cfg, qwen, 0), need=square),
        dict(one, name="sparse_dml", cfg=cfg, build=build(cfg, True),
             run=dml(cfg, qwen, sparse_k),
             need=flash + ("sparse_kl_fwd", "sparse_kl_bwd")),
        dict(one, name="M1 moe_train", cfg=moe32, routes=True,
             build=build(moe32, False),
             run=train(moe32, draw(moe32.vocab_size, 27, 1))),
        dict(one, name="M2 moe_dml", cfg=moe16, routes=True, held=False,
             build=build(moe16, True),
             run=dml(moe16, draw(moe16.vocab_size, 28, 0), 0), need=square),
        dict(one, name="M3 ssd_train", cfg=ssm, build=build(ssm, False),
             run=train(ssm, draw(ssm.vocab_size, 29, 1)),
             need=("ssd_scan_fwd", "ssd_scan_bwd")),
        dict(one, name="M4 pod_dml", cfg=cfg, mesh="pod",
             rules=dryrun.mesh_rules("dml"), build=build(cfg, True),
             run=dml(cfg, qwen, 0, client_axis="pod"),
             need=flash + ("kl_mutual_pair_fwd", "kl_mutual_pair_bwd")),
    ]


class _AxisBytes:
    """Bytes of the functional collectives run inside, by mesh dim and
    kind (the tensor each writes, as the dry-run counts them): a dispatch
    mode that
    names each op's process group by ``mesh``'s dims, the flattened ones
    included, and passes every op through."""

    def __init__(self, mesh):
        from repro_torch.launch.mesh import flat_dims
        names = list(mesh.mesh_dim_names)
        names += ["_".join(d) for d in flat_dims(mesh)]
        self.axis_of = {mesh[n].get_group().group_name: n for n in names}
        self.bytes: dict = {}

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        outer = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(isinstance(a, DTensor) for a in args):
                    return NotImplemented   # DTensor runs the local ops
                out = func(*args, **kwargs)
                kind = func._overloadpacket.__name__
                if getattr(func, "namespace", "") == "_c10d_functional" \
                        and kind in DM_COLLECTIVES:
                    axis = outer.axis_of.get(args[-1], str(args[-1]))
                    per = outer.bytes.setdefault(axis, {})
                    per[kind] = per.get(kind, 0) \
                        + out.numel() * out.element_size()
                return out

        self.mode = Mode()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def _record_calls(module, attr: str, log: list):
    """Wraps ``module.attr`` so that each call appends its tensor
    arguments' shapes and dtypes to ``log``; returns the undo."""
    fn = getattr(module, attr)

    def wrapped(*args, **kw):
        log.append([(tuple(a.shape), str(a.dtype)[6:]) for a in args
                    if isinstance(a, torch.Tensor)])
        return fn(*args, **kw)
    setattr(module, attr, wrapped)
    return lambda: setattr(module, attr, fn)


# the library that runs the functional collectives of CUDA tensors on a
# card the ranks share (``_shared_card_collectives``), once
_SHARED_CARD = []


def _ipc_copy(x):
    """A contiguous copy of the CUDA tensor ``x`` in memory that CUDA IPC
    can share (expandable segments off for the allocation)."""
    torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    try:
        return x.detach().contiguous().clone()
    finally:
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")


def _shared_card_collectives() -> None:
    """DTensor moves data with ``torch.distributed``'s functional
    collectives (``_c10d_functional.*`` and ``wait_tensor``); over gloo on
    CUDA tensors their ``wait_tensor`` crashes the process, and gloo's
    eager collectives stage every byte through the host.  Where the ranks
    share one card, each functional collective is written here card to
    card: every rank shares a copy of its input through CUDA IPC (the
    handles cross the op's gloo group), reads the others' copies, and
    combines them in group-rank order, so every rank computes the same
    bits (an average as a sum over the group's size); a barrier keeps
    each copy alive until every rank has read it.  ``wait_tensor``
    returns its input."""
    if _SHARED_CARD:
        return
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    from torch.multiprocessing.reductions import reduce_tensor

    def parts(x, group, meta=None):
        """The group's inputs in group-rank order (this rank's own copy
        and IPC views of the others'), each rank's ``meta``, this rank's
        place in the group, and a done() that waits for the reads, then
        for every rank's, and drops the views."""
        pg = _resolve_process_group(group)
        keep = [_ipc_copy(x)]
        shared = [None] * pg.size()
        dist.all_gather_object(shared, (reduce_tensor(keep[0]), meta),
                               group=pg)
        me = dist.get_group_rank(pg, dist.get_rank())
        got = [keep[0] if i == me else h[0](*h[1])
               for i, (h, _) in enumerate(shared)]

        def done():
            torch.cuda.current_stream().synchronize()
            got.clear()
            dist.barrier(group=pg)
            keep.clear()
            torch.cuda.ipc_collect()
        return got, [m for _, m in shared], me, done

    def reduce(xs, op):
        out = xs[0].clone()
        for t in xs[1:]:
            if op in ("sum", "avg"):
                out += t
            elif op == "max":
                torch.maximum(out, t, out=out)
            elif op == "min":
                torch.minimum(out, t, out=out)
            else:
                out *= t
        return out / len(xs) if op == "avg" else out

    def all_reduce(x, op, group):
        xs, _, _, done = parts(x, group)
        out = reduce(xs, op.lower())
        done()
        return out

    def all_gather_into_tensor(x, size, group):
        xs, _, _, done = parts(x, group)
        out = torch.cat(xs)
        done()
        return out

    def reduce_scatter_tensor(x, op, size, group):
        xs, _, me, done = parts(x, group)
        rows = x.shape[0] // size
        out = reduce([t[me * rows:(me + 1) * rows] for t in xs], op.lower())
        done()
        return out

    def all_to_all_single(x, out_sizes, in_sizes, group):
        n = _resolve_process_group(group).size()
        splits = list(in_sizes) or [x.shape[0] // n] * n
        xs, sizes, me, done = parts(x, group, splits)
        # rank i sends this rank the chunk ``me`` of its input
        out = torch.cat([t[sum(s[:me]):sum(s[:me + 1])]
                         for t, s in zip(xs, sizes)])
        done()
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    for fn in (all_reduce, all_gather_into_tensor, reduce_scatter_tensor,
               all_to_all_single):
        lib.impl(fn.__name__, fn, "CUDA")
    lib.impl("wait_tensor", lambda t: t, "CUDA")
    _SHARED_CARD.append(lib)


def _on_rank0(t, group):
    """The DTensor ``t`` whole on rank 0's card (None on the others): each
    rank shares a copy of its shard with rank 0 through CUDA IPC (only the
    handle crosses ``group``), and rank 0 copies the shards into place
    card to card, so no shard is staged through the host.  Each sender
    keeps its copy until rank 0 has read every shard (a barrier)."""
    import torch.distributed as dist
    from torch.multiprocessing.reductions import reduce_tensor

    from repro_torch.sharding import local_offset
    mesh = t.device_mesh
    local = _ipc_copy(t.to_local())
    first = dist.get_rank() == 0
    handles = [None] * dist.get_world_size() if first else None
    dist.gather_object(None if first else reduce_tensor(local), handles,
                       dst=0, group=group)
    full = None
    if first:
        full = torch.empty(t.shape, dtype=local.dtype, device=local.device)
        for r, shared in enumerate(handles):
            part = local if r == 0 else shared[0](*shared[1])
            coord = [int(c) for c in (mesh.mesh == r).nonzero()[0]]
            full[tuple(slice(o, o + n) for o, n in
                       zip(local_offset(t, coord), part.shape))] = part
            del part
        torch.cuda.synchronize()
    dist.barrier(group=group)
    del local
    torch.cuda.ipc_collect()
    return full


def _dm_rank(rank: int, world: int, store: str, out_dir: str, backend: str,
             cfg, K: int, B: int, S: int, sparse_k: int, steps: int) -> None:
    """One rank of phase 25: the programs of ``_dm_paths`` on their meshes
    at impl "cuda" under ``CommDebugMode`` (and ``_AxisBytes``), each
    program's launches counted from 0 and read right after it (M1 and M2
    also log their routes, M3 and M4 the local shapes of their SSD and
    pair-KL calls); then rank 0 runs each again unsharded on its card
    from the same seeded draw, and (for a held program) once more on half
    of every batch (the control), and compares leaf by leaf: each leaf's
    update (after - before) and first moment (the clipped gradients'
    average), the sharded leaf sent to rank 0 whole.  Writes its record to
    ``out_dir/rank<r>.json``; any failure raises, so the rank exits
    non-zero."""
    import faulthandler

    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch import sharding as shd
    from repro_torch.checkpoint import flatten
    from repro_torch.kernels import kl_mutual, ssd_scan
    from repro_torch.launch.mesh import make_card_mesh
    from repro_torch.models import moe

    faulthandler.enable()           # a crashing rank says where

    # four ranks share the card's 80 GB: whole blocks go back between the
    # programs
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        rec = {"rank": rank, "device": str(dev), "backend": backend,
               "collectives": _dm_collectives(dev)}
        if backend == "gloo":
            _shared_card_collectives()
        meshes = {"data_model": make_card_mesh((2, 2), ("data", "model")),
                  "pod": make_card_mesh((2, 1, 2), ("pod", "data", "model"))}
        host = dist.new_group(backend="gloo")   # the comparison's sends
        for path in _dm_paths(cfg, K, B, S, sparse_k, steps):
            name, build, run = path["name"], path["build"], path["run"]
            mesh = meshes[path["mesh"]]
            calls: dict = {"ssd": [], "pair": []}
            undo = [_record_calls(ssd_scan, "ssd_scan", calls["ssd"]),
                    _record_calls(kl_mutual, "kl_mutual_pair",
                                  calls["pair"])]
            with shd.axis_rules(path["rules"]):
                params = build(dev, mesh)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                _kernel_counts(zero=True)
                moe.route_log = [] if path["routes"] else None
                try:
                    with shd.use_mesh(mesh), CommDebugMode() as comm, \
                            _AxisBytes(mesh) as axis_bytes:
                        params, opt, gms, walls = run(params, dev, mesh)
                    routes = moe.route_log
                    # read after the counts: a metric's gather is no part
                    # of the program
                    gms = [{k: _full(v) for k, v in m.items()} for m in gms]
                finally:
                    moe.route_log = None
                    for u in undo:
                        u()
            launches = {n: c for n, c in _kernel_counts().items() if c}
            rec[name] = {
                "walls": walls, "launches": launches,
                "peak_bytes": torch.cuda.max_memory_allocated(dev),
                "comm": {str(k).split(".")[-1]: v
                         for k, v in comm.get_comm_counts().items()},
                "axis_bytes": axis_bytes.bytes,
                "local_calls": {k: v[:1] for k, v in calls.items() if v},
                "metrics": [{k: v.tolist() for k, v in m.items()}
                            for m in gms]}
            mu = opt["mu"]
            del opt
            # rank 0: the draw every run starts from, the unsharded run
            # and the control; their params and first moments kept
            t_ref = time.perf_counter()
            gc.collect()
            torch.cuda.empty_cache()
            dist.barrier()
            if rank == 0:
                before = flatten(build(dev, None))
                ref_routes = [] if path["routes"] else None
                moe.route_log = ref_routes
                try:
                    want, w_opt, ms, ref_walls = run(build(dev, None), dev,
                                                     None)
                finally:
                    moe.route_log = None
                ms = [{k: _full(v) for k, v in m.items()} for m in ms]
                rec[name].update(ref_walls=ref_walls, metric_rel={
                    k: max(float(((g[k] - w[k]).abs()
                                  / w[k].abs().clamp(min=1e-6)).max())
                           for g, w in zip(gms, ms)) for k in ms[0]})
                if routes is not None:
                    E = path["cfg"].moe.n_experts
                    rec[name]["route_flips"] = _route_flips(routes,
                                                            ref_routes, E)
                    rec[name]["routed_tokens"] = [int(i.shape[0] * i.shape[1])
                                                  for i, _ in routes]
                del routes, ref_routes
                want, w_mu = flatten(want), flatten(w_opt["mu"])
                del w_opt
                gc.collect()
                torch.cuda.empty_cache()  # the reference's activations
                if path["held"]:
                    c_p, c_opt, _, _ = run(build(dev, None), dev, None,
                                           half=True)
                    c_p, c_mu = flatten(c_p), flatten(c_opt["mu"])
                    del c_opt
                    rec[name]["control"] = {
                        "update": {k: _rel(c_p[k].float() - before[k],
                                           want[k].float() - before[k])
                                   for k in want},
                        "mu": {k: _rel(c_mu[k], w_mu[k]) for k in w_mu}}
                    del c_p, c_mu
                gc.collect()
                torch.cuda.empty_cache()
            else:
                del routes
            dist.barrier()
            t_cmp = time.perf_counter()
            upd, mus = {}, {}
            got_mu = flatten(mu)
            for k, t in flatten(params).items():
                p = _on_rank0(t, host)
                m = _on_rank0(got_mu[k], host)
                if rank == 0:
                    w, b = want[k].float(), before[k].float()
                    upd[k] = _rel(p.float() - b, w - b)
                    mus[k] = _rel(m, w_mu[k])
                del p, m
            if rank == 0:
                rec[name].update(update_rel=upd, mu_rel=mus)
                del want, w_mu, before
            rec[name]["secs"] = {"reference": t_cmp - t_ref,
                                 "compare": time.perf_counter() - t_cmp}
            del params, mu, got_mu
            gc.collect()
            torch.cuda.empty_cache()
            dist.barrier()
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(rec))
    finally:
        dist.destroy_process_group()


def phase_data_model(card: str, cfg, K: int = 2, B: int = 4, S: int = 512,
                     sparse_k: int = 64, steps: int = 2,
                     world: int = 4) -> tuple:
    """Phase 25: the data x model mesh.  Four ranks form a (data 2, model
    2) DeviceMesh (``launch.mesh.make_card_mesh``) and a (pod 2, data 1,
    model 2) one: over NCCL when each rank has its own card, else over
    gloo with the ranks sharing the one card (NCCL refuses two ranks on
    one device); which collectives gloo takes on CUDA tensors is checked
    first and printed.  Each rank draws each program's params from seed 0
    on its card and keeps its shards by the logical axes
    (``sharding.distribute_tree``); under ``sharding.use_mesh`` it runs
    the programs of ``_dm_paths`` at impl "cuda": on ``cfg`` (qwen3-4b)
    ``steps`` ``launch.steps.make_train_step`` steps of B x S, one fused
    DML round of K clients (private B, public B // 2) and one SparseDML
    round at k = ``sparse_k`` (the flash kernels on each rank's (batch,
    heads) shard, the square Eq.-2 and sparse-KL kernels on the
    vocab-gathered logits, the top-k through the vocab-sharded two-stage
    ``_distributed_topk``); then M1-M4 (the MoE FFN on each rank's shards
    in fp32 and in a bf16 DML round, the SSD scan sharded over (batch,
    heads), the clients on the pod axis through the rectangular pair
    kernels).  Rank 0 then runs each program unsharded on its card from
    the same seeded state; the limits: metrics within relative 2e-2, and
    for a held program on every leaf (the gathered shards against the
    unsharded tree) the relative norm error of the update (after -
    before) within ``DM_UPDATE_LIMIT`` and of the first moment within
    ``DM_MU_LIMIT``, and the control (rank 0's run on half of every batch)
    must exceed both on every leaf.  M2's leaves are printed, not held.
    Prints each rank's peak memory, the walls of both, the collectives
    ``CommDebugMode`` counted, the MoE programs' route flips against the
    unsharded run, and the bytes M4 moved over each mesh dim; then times
    the pair kernels and the SSD scan at the local shapes M4 and M3 gave
    them; then the ``pod``-mesh dry-run of phase 4's round and phase 19's
    step in a subprocess.  Returns (the launches summed over the ranks,
    the timed rows by kernel name)."""
    import tempfile

    import torch.multiprocessing as mp

    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= world else "gloo"
    # the pod dry-run counts on the host's CPU meanwhile
    pod = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                            "--pod-dryrun"], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            store = str(Path(tmp, "store"))
            t0 = time.perf_counter()
            mp.start_processes(_dm_rank, args=(world, store, tmp, backend, cfg,
                                               K, B, S, sparse_k, steps),
                               nprocs=world, join=True, start_method="spawn")
            secs = time.perf_counter() - t0
            recs = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                    for r in range(world)]
        r0 = recs[0]
        print(f"phase 25 on {card}: {world} ranks as (data 2, model 2) and "
              f"(pod 2, data 1, model 2) over {backend} on "
              f"{min(n_cards, world)} card(s), {secs:.1f} s with the spawns;"
              f" full width; collectives on CUDA tensors: "
              f"{r0['collectives']}")
        launches: dict = {}
        bad = []
        for path in _dm_paths(cfg, K, B, S, sparse_k, steps):
            name, c = path["name"], path["cfg"]
            row = r0[name]
            for r in recs:
                for k, v in r[name]["launches"].items():
                    launches[k] = launches.get(k, 0) + v
            peaks = [f"{r[name]['peak_bytes'] / 1e9:.2f}" for r in recs]
            print(f"  {name}: {c.name} at {c.n_layers} layer(s), "
                  f"{c.param_dtype}, on {path['mesh']}; walls sharded "
                  f"{_fmt(row['walls'], '.3f')} s, unsharded "
                  f"{_fmt(row['ref_walls'], '.3f')} s; peak GB per rank "
                  f"{peaks}; collectives (rank 0) {row['comm']}; bytes by "
                  f"mesh dim (rank 0) {row['axis_bytes']}; launches (rank "
                  f"0) {row['launches']}; metrics {row['metrics'][-1]}; "
                  f"relative errors {row['metric_rel']}; rank 0's seconds "
                  f"{row['secs']}")
            short = [n for n in path["need"] if not row["launches"].get(n)]
            if short:
                bad.append(f"{name} did not run through {short}")
            if "route_flips" in row:
                print(f"    routes sharded vs unsharded, per apply_moe call "
                      f"(forward and recompute): tokens whose kept experts "
                      f"differ {row['route_flips']} of "
                      f"{row['routed_tokens']}")
            if name == "M4 pod_dml":
                pub, V = max(1, B // 2), c.vocab_size
                print(f"    bytes over pod: {row['axis_bytes'].get('pod', {})}"
                      f" (expected: the public logits all-gathered, K x "
                      f"B_pub*S x V = {K} x {pub * S} x {V} at 2 bytes = "
                      f"{K * pub * S * V * 2} (4 bytes: "
                      f"{K * pub * S * V * 4}), + the (K,) term {4 * K}; "
                      f"one scalar all-reduce, 4)")
            bad += [f"{name} {k}" for k, v in row["metric_rel"].items()
                    if not v <= 2e-2]
            for what, limit in (("update", DM_UPDATE_LIMIT),
                                ("mu", DM_MU_LIMIT)):
                got = row[f"{what}_rel"]
                worst = max(got, key=got.get)
                line = (f"    {what} by leaf (limit {limit:g}"
                        f"{'' if path['held'] else ', not held'}): sharded "
                        f"max {got[worst]:.3e} ({worst})")
                if path["held"]:
                    ctl = row["control"][what]
                    easiest = min(ctl, key=ctl.get)
                    line += (f", half-batch control min {ctl[easiest]:.3e} "
                             f"({easiest})")
                    bad += [f"{name} {what} {k}" for k, v in got.items()
                            if not v <= limit]
                    bad += [f"{name} control {what} {k} passed"
                            for k, v in ctl.items() if not v > limit]
                line += "; sharded " + json.dumps(
                    {k: float(f"{v:.3e}") for k, v in got.items()})
                if path["held"]:
                    line += "; control " + json.dumps(
                        {k: float(f"{v:.3e}") for k, v in ctl.items()})
                print(line)
        if bad:
            raise AssertionError(f"phase 25: {bad}")
        timed = _dm_local_kernels(r0["M4 pod_dml"]["local_calls"]["pair"][0],
                                  r0["M3 ssd_train"]["local_calls"]["ssd"][0])
        _pod_dryrun(card, pod)
        return launches, timed
    finally:
        if pod.poll() is None:           # a failure before its read
            pod.kill()
            pod.wait()


def _dm_local_kernels(pair_call, ssd_call) -> dict:
    """The rectangular pair kernels and the SSD scan at the local shapes
    phase 25's M4 and M3 gave them (``pair_call``: live, fixed and the
    weights' (shape, dtype); ``ssd_call``: x, dt, A, B, C's), on fresh
    draws: each checked against its plain version, then timed with CUDA
    events beside its bound and the plain version's time
    (``_pair_times``, ``_ssd_times``).  Returns {kernel name: {"call",
    "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err"}}."""
    from repro_torch.kernels import kl_mutual, ref, ssd_scan
    gen = torch.Generator(device="cuda").manual_seed(25)
    out = {}
    (live_s, dt), (fixed_s, _), (w_s, _) = pair_call
    dtype = getattr(torch, dt)
    k_loc, Bp, V = live_s
    fixed = (2 * torch.randn(fixed_s, device="cuda", generator=gen)).to(dtype)
    live = (2 * torch.randn(live_s, device="cuda", generator=gen)).to(dtype)
    # a rank's rows of the pair mask: zero on its own client's column
    w = torch.ones(w_s, device="cuda") / max(1, w_s[1] - 1)
    w[:, :k_loc] = 0.0
    gbar = torch.randn(k_loc, Bp, device="cuda", generator=gen)
    res, zl, zf, _ = kl_mutual._forward(live, fixed, w, 1.0)
    dl = kl_mutual._backward(live, fixed, w, res, zl, zf, gbar, 1.0,
                             False)[0].float()
    a = live.detach().requires_grad_(True)
    want = ref.mutual_kl_pair(a, fixed, w)
    (want_dl,) = torch.autograd.grad(want, a, gbar)
    want, want_dl = want.detach(), want_dl.float()
    errs = ((res - want).abs().max().item(), (dl - want_dl).abs().max().item())
    rel = ((dl - want_dl).norm() / want_dl.norm()).item()
    if not (torch.allclose(res, want, atol=1e-3, rtol=1e-4) and rel <= 2e-2):
        raise AssertionError(f"the pair kernels at M4's local call disagree:"
                             f" forward {errs[0]:.3g}, dlive relative "
                             f"{rel:.3g}")
    del res, zl, zf, dl, a, want, want_dl
    ms_f, ms_b, plain_fwd, plain_bwd, fb, bb = _pair_times(live, fixed, w,
                                                           gbar)
    call = (f"phase 25 M4, a rank's call: live {tuple(live_s)} against "
            f"fixed {tuple(fixed_s)} {dt}")
    rows = (("kl_mutual_pair_fwd", ms_f, plain_fwd, fb, errs[0], ""),
            ("kl_mutual_pair_bwd", ms_b, plain_bwd, bb, errs[1], ""))
    del live, fixed, gbar
    torch.cuda.empty_cache()

    (x_s, xdt), _, _, (b_s, _), _ = ssd_call
    shape = tuple(x_s) + tuple(b_s[2:])      # (B, S, H, P, G, N)
    ins = _ssd_inputs(*shape, getattr(torch, xdt), gen)
    y_err, g_err, rel = _ssd_check((ssd_scan.ssd_scan, ref.ssd), ins, 256,
                                   2e-2, f"phase 25 M3's call {shape}",
                                   True, gen, False)
    del ins
    fwd_ms, bwd_ms, splain_f, splain_b, sfb, sbb = _ssd_times(shape, gen)
    note = (f"; worst relative error of y, state and the gradients "
            f"{rel:.3g}")
    for kname, ms, plain, (bound, by), err, extra in rows + (
            ("ssd_scan_fwd", fwd_ms, splain_f, sfb, y_err, note),
            ("ssd_scan_bwd", bwd_ms, splain_b, sbb, g_err, note)):
        where = call if kname.startswith("kl") else (
            f"phase 25 M3, a rank's call: (B, S, H, P, G, N) = {shape} "
            f"{xdt}")
        out[kname] = {"call": where, "ms": ms, "plain_ms": plain,
                      "bound_ms": bound, "bound_by": by, "max_abs_err": err}
        print(f"  {kname} at {where}: {ms:.4f} ms, plain {plain:.4f} ms; "
              f"bound {bound:.4f} ms by {by} ({bound / ms:.0%} of it)"
              f"{extra}")
    return out


def pod_dryrun() -> int:
    """``--pod-dryrun`` (phase 25's subprocess): phase 4's round and phase
    19's step counted per card on the ``pod`` mesh (data 16 x model 16 on
    the fake process group, meta tensors, impl "ref"), one JSON line each."""
    from repro_torch.api import DML
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import specs as S
    from repro_torch.optim import AdamWConfig

    cfg = get_config("qwen3-4b")
    mesh = dryrun.production_mesh("pod")
    K, B, S_, pub = 3, 4, 512, 2         # phase 4's round
    fn, args = dryrun.dml_case(
        cfg.replace(n_layers=4), K, B, pub, S_,
        opt_cfg=AdamWConfig(lr=1e-3, warmup=5, total_steps=3),
        kl_weight=DML().kl_weight)
    p = S.model_state_axes(cfg, K)
    axes = (p, S.opt_logical_axes(p), ("client", "batch", "seq"),
            ("batch", "seq"), None, None)
    cases = [("phase 4's round (K=3 x qwen3-4b at 4 layers, B 4, public "
              "2, S 512)", fn, args, axes, dryrun.mesh_rules("dml"))]
    shape = ShapeConfig("phase19", 512, 4, "train")
    fn, args = dryrun.build_case(cfg, shape, "pod", "standard")
    cases.append(("phase 19's step (qwen3-4b, 36 layers, 4 x 512)", fn, args,
                  dryrun.case_axes(cfg, shape, "standard"), {}))
    for what, fn, args, axes, rules in cases:
        t0 = time.perf_counter()
        c = dryrun.count_sharded(fn, args, axes, mesh, rules)
        print(json.dumps({"case": what, "cards": 256,
                          "flops_per_card": c.flops,
                          "bytes_per_card": c.bytes,
                          "peak_bytes_per_card": c.peak_bytes,
                          "collectives": {k: v for k, v in
                                          c.collectives.items()
                                          if k != "by_axis"},
                          "host_s": round(time.perf_counter() - t0, 1)}))
        del fn, args
    return 0


def _pod_dryrun(card: str, proc) -> None:
    """Reads ``proc``, the ``--pod-dryrun`` subprocess (the ``pod``-mesh
    dry-run of phase 4's round and phase 19's step: data 16 x model 16 on
    the fake process group, meta tensors), and prints its per-card
    counts; its failure fails the phase."""
    out, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the pod dry-run failed:\n{err[-2000:]}")
    lines = [x for x in out.splitlines() if x.startswith("{")]
    if len(lines) != 2:
        raise AssertionError(f"the pod dry-run printed {out[-2000:]}")
    for line in lines:
        print(f"  pod dry-run on {card}'s host: {line}")


# ---------------------------------------------------------------------------
# phase 26: the legacy facades and the top-level surface

def _states_equal(a: dict, b: dict) -> bool:
    """Two state_dicts, leaf by leaf, bit for bit."""
    from repro_torch.checkpoint import flatten
    fa, fb = flatten(a), flatten(b)
    return sorted(fa) == sorted(fb) and all(
        torch.equal(torch.as_tensor(fa[k]), torch.as_tensor(fb[k]))
        for k in fa)


def _logs_rel(got, want) -> float:
    """The largest relative difference of two lists of round logs'
    client_loss, kl_loss and public_ce."""
    worst = 0.0
    for g, w in zip(got, want):
        for f in ("client_loss", "kl_loss", "public_ce"):
            for a, b in zip(getattr(g, f) or (), getattr(w, f) or ()):
                if a != b:
                    worst = max(worst, abs(a - b) / max(abs(b), 1e-30))
    return worst


def _check_impl_variable() -> None:
    """(d) ``resolve_impl``'s order with ``REPRO_KERNEL_IMPL`` set: the
    explicit value first, then the variable, then the device's default."""
    from repro_torch.kernels import ops
    cuda = torch.device("cuda", torch.cuda.current_device())
    old = os.environ.get("REPRO_KERNEL_IMPL")
    try:
        os.environ.pop("REPRO_KERNEL_IMPL", None)
        got = {"unset": (ops.resolve_impl(None, cuda),
                         ops.resolve_impl("auto", cuda))}
        for value in ("ref", "cuda"):
            os.environ["REPRO_KERNEL_IMPL"] = value
            got[value] = (ops.resolve_impl(None, cuda),
                          ops.resolve_impl("auto", cuda),
                          ops.resolve_impl("ref", cuda))
        os.environ["REPRO_KERNEL_IMPL"] = "interpret"
        try:
            ops.resolve_impl(None, cuda)
            refused = None
        except ValueError as e:
            refused = str(e)
    finally:
        if old is None:
            os.environ.pop("REPRO_KERNEL_IMPL", None)
        else:
            os.environ["REPRO_KERNEL_IMPL"] = old
    want = {"unset": ("cuda", "cuda"), "ref": ("ref", "ref", "ref"),
            "cuda": ("cuda", "cuda", "ref")}
    print(f"resolve_impl on {cuda} by REPRO_KERNEL_IMPL (None, 'auto', "
          f"'ref'): {got}; 'interpret' refused: {refused}")
    if got != want or not refused or "unknown kernel impl" not in refused:
        raise AssertionError("resolve_impl does not follow explicit > "
                             "REPRO_KERNEL_IMPL > the device")


def phase_facades(card: str, hcfgs, K: int = 5, rounds: int = 12,
                  epochs: int = 3, B: int = 16, lr: float = 0.05,
                  n_train: int = 3833, n_test: int = 5988) -> dict:
    """The legacy facades on the card, reached as a user reaches them (the
    top level ``repro_torch.Federation`` etc., ``device=None``, impl
    resolved to "cuda").  (a) ``FederatedTrainer`` at phase 9's sizes
    (VisionNet at full width, K = 5, Table I's image sets, 3 local epochs
    of batch 16, lr 0.05), 2 rounds each of dml, fedavg and async, each
    bit for bit against ``Federation(VisionClients(...),
    cfg.strategy())`` from the same seed (round logs, state, dispatch
    log), on cuDNN's deterministic algorithms; a DML run on
    ``ClientMesh((cuda:0, cuda:0))`` against the same mesh through
    ``Federation``; a checkpoint after round 1 restored into a fresh
    ``Federation``, whose round 2 equals the uninterrupted one; evaluate
    on the unseen set; no kernel launch.  (b) ``HeteroTrainer`` over
    phase 17's full-width fleet, ``HeteroConfig(archs=hcfgs, ...)`` with
    phase 17's settings and pool: 2 DML rounds against phase 17's first
    two (comm bytes exact, losses within relative 1e-5), M pair launches
    each way a round and no square or sparse launch; then 1 round of a
    fresh ``sparse_k=64`` fleet through the sparse kernels only, comm
    bytes ``sparse_share_bytes``.  (c) ``HeteroTrainer`` over
    ``HeteroConfig``'s default archs at ``reduced=True`` with phase 18's
    settings: 2 DML rounds through the flash, SSD and pair kernels
    against phase 18's.  (d) ``resolve_impl`` with ``REPRO_KERNEL_IMPL``
    set.  Returns the kernels' launch counts over the phase."""
    import tempfile

    import repro_torch
    from repro_torch.configs.visionnet import CONFIG
    from repro_torch.core.federated import FederatedConfig, FederatedTrainer
    from repro_torch.core.hetero import (HeteroConfig, HeteroTrainer,
                                         make_lm_pool)
    from repro_torch.core.mutual import sparse_share_bytes

    t_phase = time.perf_counter()
    _kernel_counts(zero=True)                     # the main path starts here
    _check_impl_variable()

    # (a) the VisionNet facade
    (tx, ty), (ex, ey) = _paper_datasets(CONFIG.image_size, n_train, n_test)
    torch.cuda.reset_peak_memory_stats()
    kw = dict(n_clients=K, rounds=rounds, local_epochs=epochs, batch_size=B,
              lr=lr)

    def session(fc, mesh=None):
        pop = repro_torch.VisionClients(
            CONFIG, tx, ty, n_clients=fc.n_clients, rounds=fc.rounds,
            local_epochs=fc.local_epochs, batch_size=fc.batch_size,
            lr=fc.lr, momentum=fc.momentum, clip_norm=fc.clip_norm,
            non_iid_alpha=fc.non_iid_alpha, seed=fc.seed,
            eval_batch=fc.eval_batch, mesh=mesh)
        return repro_torch.Federation(pop, fc.strategy(),
                                      participation=fc.participation)

    def same(tr, fed) -> bool:
        return (tr.history.rounds == fed.history.rounds
                and tr.history.total_comm_bytes
                == fed.history.total_comm_bytes
                and tr.dispatch_log == fed.dispatch_log
                and _states_equal(tr.session.population.state_dict(),
                                  fed.population.state_dict()))

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        results, walls = {}, {}
        for method in ("dml", "fedavg", "async"):
            fc = FederatedConfig(method=method, **kw)
            tr = FederatedTrainer(CONFIG, fc, tx, ty)
            _, walls[method] = _timed(lambda: tr.run(until=2))
            fed = session(fc)
            fed.run(until=2)
            results[method] = same(tr, fed)
            if method == "dml":
                dml = tr
            del fed
        mesh = repro_torch.sharding.ClientMesh(("cuda:0", "cuda:0"))
        fc = FederatedConfig(method="dml", **kw)
        tr = FederatedTrainer(CONFIG, fc, tx, ty, mesh=mesh)
        _, walls["dml on the mesh"] = _timed(lambda: tr.run(until=2))
        fed = session(fc, mesh)
        fed.run(until=2)
        results["dml on the mesh"] = same(tr, fed) and tr.mesh is mesh
        del tr, fed
        half = FederatedTrainer(CONFIG, fc, tx, ty)
        half.run(until=1)
        fed = session(fc)
        with tempfile.TemporaryDirectory() as tmp:
            half.save_state(os.path.join(tmp, "state"))
            saved = sorted(os.listdir(tmp))
            fed.restore_state(os.path.join(tmp, "state"))
        fed.run(until=2)
        results["checkpoint"] = (
            saved == ["state.json", "state.npz"] and fed.round == 2
            and fed.history.rounds == dml.history.rounds
            and _states_equal(dml.session.population.state_dict(),
                              fed.population.state_dict()))
        del half, fed
    finally:
        torch.backends.cudnn.deterministic = deterministic
    h, eval_secs = _timed(lambda: dml.evaluate(ex, ey))
    accs = h.client_test_acc + [h.global_test_acc]
    vision_counts = {n: c for n, c in _kernel_counts().items() if c}
    print(f"FederatedTrainer at phase 9's sizes ({K} x VisionNet "
          f"{CONFIG.image_size}px, {len(tx)} train images), 2 rounds "
          f"each, bit for bit against Federation(VisionClients(...), "
          f"cfg.strategy()): {results}; walls (2 rounds) "
          f"{ {k: round(v, 3) for k, v in walls.items()} } s; evaluate on "
          f"{len(ex)} unseen images {eval_secs:.3f} s, accuracies "
          f"{_fmt(accs, '.4f')}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
          f"{vision_counts}")
    if not all(results.values()) or vision_counts or len(accs) != K + 1 \
            or not all(0.0 <= a <= 1.0 for a in accs):
        raise AssertionError("the VisionNet facade disagrees with its "
                             "Federation")
    del dml, h
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the full-width fleet of phase 17
    m17 = MEASURED["phase 17"]
    Kh, V = len(hcfgs), hcfgs[0].vocab_size
    pool, labels = make_lm_pool(((1 + Kh) * m17["rounds"] + 1)
                                * m17["fold"], m17["S"], V, seed=0)
    hkw = dict(archs=tuple(hcfgs), rounds=m17["rounds"],
               batch_size=m17["B"], public_batch=m17["pub"], seed=0)

    def run_rounds(tr, n_rounds, what, want_logs, launches):
        """Run ``n_rounds`` rounds, each against ``want_logs`` (comm bytes
        exact, losses within relative 1e-5) and its launches: ``launches(M)``
        gives the counts a round must add and the kernels it must not
        launch."""
        out = []
        for r in range(n_rounds):
            before = _kernel_counts()
            torch.cuda.reset_peak_memory_stats()
            _, wall = _timed(lambda: tr.run(until=r + 1))
            ran = _delta(before, _kernel_counts())
            rl = tr.history.rounds[-1]
            M = len(rl.participants)
            rel = _logs_rel([rl], want_logs[r:r + 1]) if want_logs else None
            comm = want_logs[r].comm_bytes if want_logs else None
            print(f"{what} round {r}: {wall:.3f} s wall; local loss "
                  f"{_fmt(rl.client_loss)} public_ce {_fmt(rl.public_ce)} "
                  f"kl {_fmt(rl.kl_loss)}; comm_bytes {rl.comm_bytes}; "
                  f"largest relative difference from the Federation "
                  f"phase's round: {rel}; launches {ran}; peak memory "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
            need, none = launches(M)
            if (want_logs and (rl.comm_bytes != comm or rel > 1e-5)) or \
                    any(ran.get(name) != c for name, c in need.items()) or \
                    any(ran.get(name) for name in none) or \
                    not all(np.isfinite(x).all() for x in (
                        rl.client_loss, rl.public_ce, rl.kl_loss)):
                raise AssertionError(f"{what} round {r} disagrees with the "
                                     "Federation phase or left its kernels")
            out.append(rl)
        return out

    square = ("kl_mutual_square_fwd", "kl_mutual_square_bwd")
    pair = ("kl_mutual_pair_fwd", "kl_mutual_pair_bwd")
    sparse = ("sparse_kl_fwd", "sparse_kl_bwd")

    tr, secs = _timed(lambda: HeteroTrainer(HeteroConfig(**hkw), pool,
                                            labels))
    names = ", ".join(c.name for c in hcfgs)
    print(f"HeteroTrainer over phase 17's fleet ({names}; {tr.n_params} "
          f"params) built in {secs:.1f} s, kernels impl="
          f"{tr.session.population.impl}")
    before = _kernel_counts()
    run_rounds(tr, 2, "HeteroTrainer (phase 17's fleet) DML", m17["logs"],
               lambda M: ({"kl_mutual_pair_fwd": M,
                           "kl_mutual_pair_bwd": M}, square + sparse))
    ran = _delta(before, _kernel_counts())
    if not all(ran.get(n) for n in ("flash_attention_fwd",
                                     "flash_attention_bwd")):
        raise AssertionError(f"the fleet's rounds left the flash kernels: "
                             f"{ran}")
    n_pub = tr.session.population._pub_n * m17["S"]
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    k = 64
    tr = HeteroTrainer(HeteroConfig(**hkw, sparse_k=k), pool, labels)
    (rl,) = run_rounds(tr, 1, f"HeteroTrainer (phase 17's fleet) "
                       f"sparse_k={k}", None,
                       lambda M: ({"sparse_kl_fwd": M, "sparse_kl_bwd": M},
                                  square + pair))
    want = sparse_share_bytes(Kh, n_pub, k)
    print(f"  comm_bytes {rl.comm_bytes} (sparse_share_bytes {want})")
    if rl.comm_bytes != want or tr.session.strategy.name != "sparse-dml":
        raise AssertionError("the sparse HeteroTrainer's bytes")
    del tr, pool, labels
    gc.collect()
    torch.cuda.empty_cache()

    # (c) HeteroConfig's default archs, reduced, with phase 18's settings
    m18 = MEASURED["phase 18"]
    cfg = HeteroConfig(rounds=m18["rounds"], batch_size=m18["B"],
                       public_batch=2, seed=0)
    if cfg.archs != m18["archs"]:
        raise AssertionError(f"HeteroConfig's archs {cfg.archs} are not "
                             f"phase 18's {m18['archs']}")
    pool, labels = make_lm_pool(((1 + cfg.n_clients) * cfg.rounds + 1)
                                * m18["fold"], m18["S"], m18["V"], seed=0)
    tr = HeteroTrainer(cfg, pool, labels, reduced=True)
    before = _kernel_counts()
    run_rounds(tr, cfg.rounds, "HeteroTrainer (reduced default archs) DML",
               m18["logs"], lambda M: ({"kl_mutual_pair_fwd": M,
                                        "kl_mutual_pair_bwd": M},
                                       square + sparse))
    ran = _delta(before, _kernel_counts())
    if not all(ran.get(n) for n in ("flash_attention_fwd",
                                     "flash_attention_bwd", "ssd_scan_fwd",
                                     "ssd_scan_bwd")):
        raise AssertionError(f"the reduced fleet left the flash or SSD "
                             f"kernels: {ran}")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    counts = _kernel_counts()                     # ... and ends here
    print(f"phase 26 on {card}: {time.perf_counter() - t_phase:.1f} s; "
          f"launches "
          f"{ {n: c for n, c in counts.items() if c} }")
    return counts


def run_cards(card: str, n: int) -> int:
    """``--cards N``: phases 22 and 23 alone over a client mesh of N
    distinct cards (``launch.mesh.make_client_mesh``, one entry a card):
    qwen3-4b at phase 22's width and depth with K = 4 (K_loc 2: a client
    and a dummy slot a card), and the VisionNet protocol with K = 5; then
    phase 25, whose four ranks take a card each over NCCL when four are
    visible."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_client_mesh
    devices = make_client_mesh(n).devices     # raises past the visible
    scfg = get_config("qwen3-4b").replace(n_layers=2)
    paths = []
    for phase in (lambda: phase_sharded_train(card, scfg, 4, 4, 512,
                                              devices=devices),
                  lambda: phase_vision_mesh(card, devices=devices),
                  lambda: phase_data_model(card, scfg)[0]):
        gc.collect()
        torch.cuda.empty_cache()
        _reset_peaks(devices)
        paths.append(phase())
    print(f"launches on each path (qwen3-4b sharded DML at K = 4, "
          f"VisionNet, phase 25's programs on the (data 2, model 2) and "
          f"(pod 2, data 1, model 2) meshes) over {n} cards: "
          + json.dumps(paths))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=0,
                    help="run only the mesh phases (22, 23, 25) over this "
                         "many distinct cards")
    ap.add_argument("--pod-dryrun", action="store_true",
                    help=argparse.SUPPRESS)   # phase 25's subprocess
    args = ap.parse_args()
    impl = os.environ.get("REPRO_KERNEL_IMPL")
    if impl and impl != "cuda":
        print(f"chip_smoke: REPRO_KERNEL_IMPL={impl!r} would send every "
              "entry point that resolves its impl to that path; unset it "
              "(or set it to 'cuda') to run the kernels", file=sys.stderr)
        raise SystemExit(2)
    check_cuda()
    if args.pod_dryrun:
        return pod_dryrun()
    env = phase_env()
    if args.cards:
        return run_cards(env["card"], args.cards)
    from repro_torch.api import SparseDML
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sparse_kl, ssd_scan
    from repro_torch.launch.serve import _random_prefix
    cfg = get_config("qwen3-4b")
    tcfg = cfg.replace(n_layers=4)     # full width; depth cut to fit K=3
    K, B, S0 = 2, 2, 512
    TK, TB, TS = 3, 4, 512             # the qwen3-4b training run
    train_shapes = [(TK * TB, TS), (TK * max(1, TB // 2), TS)]
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_)
    reqs = make_requests(cfg)
    mcfg = get_config("mamba2-780m")   # full width and depth
    MK, MB, MS0 = 2, 2, 1024           # mamba2 serving: 4 chunks a prompt
    MTK, MTB, MTS = 3, 4, 1024         # the mamba2 training run,
    mtcfg = mcfg.replace(n_layers=3)   # at 3 of 48 layers (time)
    mscfg = mcfg.replace(n_layers=6)   # serving at 6 of 48 (time)
    mreqs = make_requests(mcfg)
    qcfg = get_config("qwen2-moe-a2.7b")   # full width and depth: serving
    QK, QB, QS0 = 2, 2, 512
    qtcfg = qcfg.replace(n_layers=1)   # training: K = 3 fits at 1 of 24
    QTK, QTB, QTS = 3, 4, 512
    qreqs = make_requests(qcfg)
    # dbrx: two clients of 4 of its 40 layers hold 57 GB in bf16
    dcfg = get_config("dbrx-132b").replace(n_layers=4)
    dreqs = make_requests(dcfg)
    # llava-next: serving at full width, 4 of 32 layers (time), on prompts
    # of 1536 behind the 2880-position image prefix, past the 4096 window;
    # training at 4 of 32 layers (K = 3), seq 1280: P + S = 4160 > 4096
    lcfg = get_config("llava-next-mistral-7b")
    LK, LB, LS0 = 2, 2, 1536
    ltcfg = lcfg.replace(n_layers=4)
    LTK, LTB, LTS = 3, 4, 1280
    lcheck = (1, 2, 1)                 # its round-1 parity: 1 layer, K 2, B 1
    lreqs = make_requests(lcfg)
    # musicgen-medium: full width, serving (K = 2) and training (K = 3) at
    # 3 of 48 layers (time), behind the 64-position conditioning prefix
    gcfg = get_config("musicgen-medium")
    GK, GB, GS0 = 2, 2, 512
    GTK, GTB, GTS = 3, 4, 512
    gtcfg = gcfg.replace(n_layers=3)
    greqs = make_requests(gcfg)
    # phase 22's sharded fleet and phase 25's mesh: full width at 2 of 36
    # layers, so that four clients' params, moments, one entry's gradients
    # and the round's activations stay under ~70 GB
    scfg = cfg.replace(n_layers=2)
    # the mixed fleet of phase 17 (one vocabulary, 151,936): full width,
    # depth cut so that three clients' params and moments fit (~40 GB);
    # phase 21's fleet of four adds a second qwen3-4b client (~52 GB);
    # qwen3-4b at 2 layers (time)
    hcfgs = (scfg, qtcfg, get_config("qwen3-8b").replace(n_layers=2))
    pcfgs = hcfgs + (scfg,)
    HB, HS, HPUB = 4, 512, 2

    def shapes(c):
        return (c.n_heads, c.n_kv_heads, c.head_dim_)

    def serve_flash(c, k, b, s0, rq):
        """The flash forward's shapes on a serving path: the generate and
        route prefill, and each admitted request's."""
        P, w = c.prefix_tokens, c.sliding_window
        return ([(k * b, shapes(c), P + s0, w)]
                + [(k, shapes(c), P + n, w) for n in {len(p) for p, _, _ in
                                                      rq}])

    def train_flash(c, k, b, s):
        """The flash pair's shapes on a training path: private, public."""
        return [(k * n, shapes(c), c.prefix_tokens + s, c.sliding_window)
                for n in (b, max(1, b // 2))]

    qtrain = train_flash(qcfg, QTK, QTB, QTS)
    ltrain = (train_flash(lcfg, LTK, LTB, LTS)
              + train_flash(lcfg, lcheck[1], lcheck[2], LTS))
    gtrain = train_flash(gcfg, GTK, GTB, GTS)
    more_fwd = (serve_flash(qcfg, QK, QB, QS0, qreqs) + qtrain
                + serve_flash(dcfg, 2, 2, 512, dreqs)
                + serve_flash(lcfg, LK, LB, LS0, lreqs) + ltrain
                + serve_flash(gcfg, GK, GB, GS0, greqs) + gtrain)
    timed_fwd = (serve_flash(lcfg, LK, LB, LS0, lreqs)[:1] + ltrain[:1]
                 + serve_flash(gcfg, GK, GB, GS0, greqs)[:1] + gtrain[:1])
    s = mcfg.ssm
    nh, P, G, N = s.n_heads(mcfg.d_model), s.head_dim, s.n_groups, s.d_state
    # the scan sees the K clients as K * nh heads in K * G groups
    ssd_train = [(b, MTS, MTK * nh, P, MTK * G, N)
                 for b in (MTB, max(1, MTB // 2))]
    ssd_serve = [(MB, MS0, MK * nh, P, MK * G, N)]
    ssd_serve += [(1, n, MK * nh, P, MK * G, N)
                  for n in sorted({len(p) for p, _, _ in mreqs})]

    kernels = [phase_flash_fwd((K * B, S0) + heads, K,
                               sorted({len(p) for p, _, _ in reqs}),
                               train_shapes, more_fwd, timed_fwd),
               phase_flash_bwd(train_shapes[0] + heads, train_shapes,
                               qtrain + ltrain + gtrain,
                               ltrain[:1] + gtrain[:1])]
    kernels += phase_kl(TK, max(1, TB // 2) * TS, cfg.vocab_size)
    # the pair kernels' rows at the hetero fleet's call (phase 17): one
    # live row against J = 2 received; phase_kl's (K = 3, x rolled) printed
    received = phase_kl_received(HPUB * HS, cfg.vocab_size, len(hcfgs) - 1,
                                 64)
    # ... and against J = 3, phase 21's DP-DML call, where the pair rows of
    # the kernels line are timed
    received += phase_kl_received(HPUB * HS, cfg.vocab_size,
                                  len(pcfgs) - 1, 64, sparse=False)
    # ... and at phase 22's sharded calls, Kl = 2 against J = 4 with zero
    # self weights (K = 3 adds a pad column of zero weight), where the pair
    # rows of the kernels line are now timed, at K = 4 (every column
    # weighted); the J = 3 call's numbers ride along under "also"
    sharded = phase_kl_sharded(HPUB * HS, cfg.vocab_size)
    for row, prev in zip(sharded, received[2:]):
        row["also"] = {"call": "Kl=1 against J=3 received (phase 21)",
                       **{k: prev[k] for k in ("ms", "plain_ms", "bound_ms",
                                               "max_abs_err")}}
    kernels = [r for r in kernels if r["name"] not in
               {x["name"] for x in received}] + sharded
    # the mamba2 round's Eq.-2 term: checked, its rows kept at qwen3-4b's
    phase_kl(MTK, max(1, MTB // 2) * MTS, mcfg.vocab_size)
    # the prefix archs' rounds' Eq.-2 terms (token positions only)
    phase_kl(LTK, max(1, LTB // 2) * LTS, lcfg.vocab_size)
    phase_kl(GTK, max(1, GTB // 2) * GTS, gcfg.vocab_size)
    phase_kl_blocks(256, mcfg.vocab_size)
    kernels += phase_ssd(ssd_train, ssd_serve)
    # the SparseDML rounds' Eq.-2 term at qwen3-4b's and mamba2's shapes
    kernels += phase_sparse_kl([(max(1, TB // 2) * TS, cfg.vocab_size),
                                (max(1, MTB // 2) * MTS, mcfg.vocab_size)],
                               TK)
    # the optimizer step of the benchmark's qwen3-4b cell: its tree ties
    # the head to the embedding, as the published config does
    kernels += phase_adamw(tcfg.replace(tie_embeddings=True), TK)
    flash = ("flash_attention_fwd", "flash_attention_bwd", fa)
    flash_fwd = ("flash_attention_fwd", fa)
    local: dict = {}

    def data_model(card, c):
        # phase 25: its launches, and the rows it timed at its ranks'
        # local calls (the rectangular pair kernels, the sharded SSD scan)
        launches, timed = phase_data_model(card, c)
        local.update(timed)
        return launches
    paths = []
    for phase in (
            lambda: phase_serve(env["card"], cfg, reqs, flash_fwd, K, B, S0),
            lambda: phase_train(env["card"], tcfg, flash, TK, TB, TS),
            lambda: phase_serve(env["card"], mscfg, mreqs,
                                ("ssd_scan_fwd", ssd_scan), MK, MB, MS0, 32,
                                None),
            lambda: phase_train(env["card"], mtcfg,
                                ("ssd_scan_fwd", "ssd_scan_bwd", ssd_scan),
                                MTK, MTB, MTS, 3, None),
            lambda: phase_train(env["card"], tcfg, flash, TK, TB, TS,
                                strategy=SparseDML(k=64),
                                eq2=("sparse_kl_fwd", "sparse_kl_bwd",
                                     sparse_kl)),
            lambda: phase_weights(env["card"], tcfg, flash, TK, TB, TS),
            lambda: phase_vision(env["card"]),
            lambda: phase_serve(env["card"], qcfg.replace(n_layers=6), qreqs,
                                flash_fwd, QK, QB, QS0, 32, None,
                                parity_layers=4),
            lambda: phase_train(env["card"], qtcfg, flash, QTK, QTB, QTS, 3,
                                None),
            lambda: phase_serve(env["card"], dcfg, dreqs, flash_fwd, 2, 2,
                                512, 32, None, parity_layers=1),
            lambda: phase_serve(env["card"], lcfg.replace(n_layers=4), lreqs,
                                flash_fwd, LK, LB, LS0, 32, 2e-2,
                                parity_layers=4,
                                prefix=_random_prefix(lcfg, LB, 0)),
            lambda: phase_train(env["card"], ltcfg, flash, LTK, LTB, LTS, 3,
                                2e-2, check=lcheck),
            lambda: phase_serve(env["card"], gtcfg, greqs, flash_fwd, GK, GB,
                                GS0, 32, None,
                                prefix=_random_prefix(gcfg, GB, 0)),
            lambda: phase_train(env["card"], gtcfg, flash, GTK, GTB, GTS, 3,
                                None),
            lambda: phase_hetero(env["card"], hcfgs, HB, HS, HPUB),
            lambda: phase_hetero_small(env["card"], tcfg),
            lambda: phase_single(env["card"], cfg),
            lambda: phase_vision_privacy(env["card"]),
            lambda: phase_hetero_privacy(env["card"], pcfgs, HB, HS, HPUB),
            lambda: phase_hetero_small_privacy(env["card"]),
            lambda: phase_sharded_train(env["card"], scfg, 4, HB, HS),
            lambda: phase_sharded_train(env["card"], scfg, 3, HB, HS),
            lambda: phase_vision_mesh(env["card"]),
            lambda: phase_tooling(env["card"], tcfg, TK, TB, TS),
            lambda: data_model(env["card"], scfg),
            lambda: phase_facades(env["card"], hcfgs)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_path = time.perf_counter()
        paths.append(phase())
        print(f"path {len(paths)} of the launch line: "
              f"{time.perf_counter() - t_path:.1f} s")
    print("launches on each path (qwen3-4b serving, qwen3-4b DML training, "
          "mamba2-780m serving, mamba2-780m training, qwen3-4b SparseDML "
          "training, qwen3-4b FedAvg + AsyncWeights, VisionNet DML + FedAvg + "
          "AsyncWeights, qwen2-moe-a2.7b serving, qwen2-moe-a2.7b DML "
          "training, dbrx-132b serving, llava-next-mistral-7b serving, "
          "llava-next-mistral-7b DML training, musicgen-medium serving, "
          "musicgen-medium DML training, the full-width hetero fleet, the "
          "reduced hetero fleet + one-arch weight rounds, qwen3-4b "
          "single-model training + decode, VisionNet DP-DML + robust + "
          "attack experiments, the full-width privacy fleet, the reduced "
          "privacy fleet, qwen3-4b sharded DML at K = 4 and K = 3, "
          "VisionNet on a client mesh, the quickstart and serve_lm examples, "
          "qwen3-4b train + DML + SparseDML and M1-M4 (qwen2-moe-a2.7b "
          "train in fp32 and DML, mamba2-780m train, qwen3-4b DML with the "
          "clients on pod) on the data x model meshes, the legacy facades "
          "(FederatedTrainer, HeteroTrainer over the full-width and the "
          "reduced fleet)): "
          + json.dumps(paths))
    for row in kernels:
        row["launches"] = sum(p.get(row["name"], 0) for p in paths)
        if row["name"] in local:
            row["phase25"] = local[row["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
