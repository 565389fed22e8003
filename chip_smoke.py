"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. environment and kernel build: the card's name and power limit, torch
     and CUDA versions, and the seconds the CUDA kernels took to build from
     the sources in this checkout;
  2. every kernel against its plain PyTorch version on the card, at the
     serving path's shapes and around them, with the kernel's time beside
     its bound, the plain version's time and a library yardstick;
  3. the serving path at the full width of qwen3-4b: a K=2 client ensemble
     from seeded random weights serves ``generate``, continuous batching
     and route mode, and the kernels' launch counts show that it ran
     through them.
The line before the last is one JSON object with the per-kernel numbers;
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device
it exits non-zero and prints no result.  It imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# fails here, before anything runs, without the port beside this file
from repro_torch.kernels import _build  # noqa: E402

# H100 SXM published peaks (dense): bf16 tensor cores, fp32 without them,
# and HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12


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
    for name in ("flash_attention_fwd",):
        t0 = time.perf_counter()
        _build.load(name)
        log = _build.library_path(name).with_suffix(".log").read_text()
        print(f"build {name}: {time.perf_counter() - t0:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
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


def attention_bound_ms(B, S, Hq, Hkv, hd, dtype) -> tuple:
    """The two lower bounds on causal self-attention over these inputs, in
    ms: 4*hd flops per unmasked (query, key) pair, S*(S+1)/2 pairs per
    sequence and head, at the peak rate for the dtype; and q, k, v read once
    and out, lse written once at HBM bandwidth."""
    flops = 4.0 * hd * B * Hq * S * (S + 1) / 2
    elt = torch.finfo(dtype).bits // 8
    nbytes = (2 * B * S * Hq * hd + 2 * B * S * Hkv * hd) * elt \
        + B * Hq * S * 4
    return flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3


def _check(flash_attention, ref, q, k, v, causal, window, tol, what):
    """Kernel vs ``ref.attention_lse`` on the same inputs; raises outside
    the tolerance, else returns (max |out err|, max |lse err|)."""
    out, lse = flash_attention(q, k, v, causal=causal, window=window)
    want, want_lse = ref.attention_lse(q, k, v, causal=causal, window=window)
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


def phase_kernels(main_shape, admit_batch, admit_lens) -> dict:
    """Flash forward against ``ref.attention_lse`` on the card: a sweep of
    heads, lengths, windows and dtypes, and every shape the serving run of
    phase 3 gives the kernel -- K*B sequences of the generate and route
    prompts (``main_shape``) and ``admit_batch`` = K sequences of each
    admitted request length (``admit_lens``), bf16, causal."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
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
    worst = {}
    for b, (hq, hkv, d), S, window, dtype, causal in cases + path:
        q, k, v = _qkv(b, S, hq, hkv, d, dtype, gen)
        errs = _check(flash_attention, ref, q, k, v, causal, window,
                      tol[dtype], f"B={b} Hq={hq} Hkv={hkv} hd={d} S={S} "
                      f"window={window} {dtype} causal={causal}")
        n, e, el = worst.get(dtype, (0, 0.0, 0.0))
        worst[dtype] = (n + 1, max(e, errs[0]), max(el, errs[1]))
        if (b, S) == (B, S0):
            max_err = errs[0]
    for dtype, (n, e, el) in worst.items():
        t = tol[dtype]
        print(f"flash_attention vs ref, {n} cases {str(dtype)[6:]}: max |out "
              f"err| {e:.3g} (atol {t['out']}, rtol {t['rtol']}), max |lse "
              f"err| {el:.3g} (limit {t['lse']})")
    print(f"  of them at the serving path's shapes: B={B} S={S0}, and "
          f"B={admit_batch} S in {list(admit_lens)}")

    # time at the serving path's generate/route prefill shape
    q, k, v = _qkv(B, S0, Hq, Hkv, hd, bf16, gen)
    ms = time_ms(lambda: flash_attention(q, k, v))
    plain_ms = time_ms(lambda: ref.attention_lse(q, k, v), iters=5)
    G = Hq // Hkv
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
    ops_ms, bytes_ms = attention_bound_ms(B, S0, Hq, Hkv, hd, bf16)
    bound_ms, bound_by = max((ops_ms, "operations"), (bytes_ms, "bytes"))
    print(f"flash_attention at (B={B}, S={S0}, Hq={Hq}, Hkv={Hkv}, hd={hd}) "
          f"bf16: {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa (library) "
          f"{library_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} "
          f"(causal flops / 989 TFLOP/s {ops_ms:.4f} ms, bytes / 3.35 TB/s "
          f"{bytes_ms:.4f} ms); max |err| {max_err:.3g}")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:34",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


# ---------------------------------------------------------------------------
# phase 3

def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def profile_decode(eng, prompts, step_secs: float, steps: int = 8) -> None:
    """Device time of the decode loop under ``torch.profiler``: the kernels
    of ``steps`` decode steps (a generate of ``steps`` minus one of a single
    step), their busy time per step against the unprofiled wall time per
    step ``step_secs``, and the kernels that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def kernels(n, sign, acc):
        """Add sign * (microseconds, count) of each kernel name to acc."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.generate(prompts, n)
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                us, cnt = acc.get(e.name, (0.0, 0))
                acc[e.name] = (us + sign * e.time_range.elapsed_us(),
                               cnt + sign)

    by_name: dict = {}
    kernels(1 + steps, 1, by_name)
    kernels(1, -1, by_name)
    busy_us = sum(us for us, _ in by_name.values()) / steps
    n_kernels = sum(cnt for _, cnt in by_name.values()) / steps
    print(f"decode step: {step_secs * 1e3:.1f} ms wall (unprofiled), "
          f"{busy_us / 1e3:.2f} ms device busy in {n_kernels:.0f} kernels "
          f"(profiled) -> device idle {1 - busy_us / 1e6 / step_secs:.1%}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    for name, (us, cnt) in top:
        print(f"  {us / steps / 1e3:7.3f} ms/step {cnt / steps:5.0f} x  "
              f"{name[:90]}")


def make_requests(vocab_size: int, n: int = 6, seed: int = 0) -> list:
    """``n`` (prompt, max_new) requests of 64-1024 prompt tokens and 16-64
    new ones, for continuous batching."""
    import numpy as np
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        s0 = int(rng.integers(64, 1025))
        reqs.append((rng.integers(0, vocab_size, (s0,)).astype(np.int32),
                     int(rng.integers(16, 65))))
    return reqs


def phase_serve(card: str, cfg, reqs, K: int = 2, B: int = 2, S0: int = 512,
                gen: int = 32) -> dict:
    """The port's serving path at the full width of ``cfg``.  Returns the
    kernels' launch counts over the served requests."""
    import numpy as np
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.kernels import flash_attention as fa
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
    max_seq = 1152
    kw = dict(slots=4, max_seq=max_seq)
    avg = ServeEngine(cfg, params, mode="average", **kw)
    route = ServeEngine(cfg, params, mode="route", **kw)
    prompts = make_token_stream(B, S0, cfg.vocab_size, seed=0)

    fa.launches = 0                    # the main path starts here
    (toks, lg), warm = _timed(lambda: avg.generate(prompts, gen,
                                                   return_logits=True))
    steady_toks, steady = _timed(lambda: avg.generate(prompts, gen))
    _, ttft = _timed(lambda: avg.generate(prompts, 1))
    rids = [avg.submit(p, n_new) for p, n_new in reqs]
    done, cb_secs = _timed(avg.run)
    rtoks, route_secs = _timed(lambda: route.generate(prompts, 16))
    launches = fa.launches             # ... and ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    calls = {}
    for eng in (avg, route):
        for name, c in eng.dispatch_counts().items():
            calls[name] = calls.get(name, 0) + c
    need = cfg.n_layers * (calls["prefill"] + calls["router"])
    print(f"program calls {calls}; flash_attention launches {launches} "
          f"(need >= {need} = {cfg.n_layers} layers x (prefill + router))")
    if launches < need:
        raise AssertionError("a prefill or router call did not run "
                             "through the flash kernel")
    outs = [toks, steady_toks, rtoks] + [done[r] for r in rids]
    if not all(((o >= 0) & (o < cfg.vocab_size)).all() for o in outs):
        raise AssertionError("token id out of range")
    if not np.isfinite(lg).all():
        raise AssertionError("non-finite logits")
    if not np.array_equal(toks, steady_toks):
        raise AssertionError("greedy generate is not repeatable")
    if sorted(len(done[r]) for r in rids) != sorted(n for _, n in reqs):
        raise AssertionError("continuous batching lost tokens")

    # the engine's prefill program against an engine at the plain version
    # on the same weights
    plain = ServeEngine(cfg, params, mode="average", impl="ref", **kw)
    ids = torch.as_tensor(prompts, dtype=torch.long, device="cuda")
    a, _ = avg._prefill(ids)
    b, _ = plain._prefill(ids)
    rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
    print(f"prefill last-token logits, engine impl={avg.impl} vs engine "
          f"impl={plain.impl}: rel err {rel:.3g} (limit 2e-2)")
    if not rel <= 2e-2:
        raise AssertionError("prefill logits disagree with the plain path")

    step = (steady - ttft) / (gen - 1)
    profile_decode(avg, prompts, step)
    n_cb = sum(len(done[r]) for r in rids)
    print(f"serve on {card}: average K={K} B={B} prompt {S0}: warmup "
          f"{warm:.3f} s, steady {steady:.3f} s = {B * gen / steady:.1f} "
          f"tok/s; time to first token {ttft * 1e3:.1f} ms (generate with "
          f"gen_len=1: prefill + first token); continuous "
          f"batching {len(reqs)} requests / 4 slots: {n_cb} tokens in "
          f"{cb_secs:.3f} s = {n_cb / cb_secs:.1f} tok/s; decode step "
          f"{step * 1e3:.1f} ms; route generate "
          f"{route_secs:.3f} s; peak memory {peak_gb:.1f} GB")
    return {"flash_attention_fwd": launches}


def main() -> int:
    check_cuda()
    env = phase_env()
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-4b")
    K, B, S0 = 2, 2, 512
    reqs = make_requests(cfg.vocab_size)
    kernel = phase_kernels(
        (K * B, S0, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_), K,
        sorted({len(p) for p, _ in reqs}))
    launches = phase_serve(env["card"], cfg, reqs, K=K, B=B, S0=S0)
    kernel["launches"] = launches[kernel["name"]]
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
