"""Operations and bytes of the work a round needs, from shapes alone.

The kernel formulas are frozen copies of ``chip_smoke.py`` at the parent
of the benchmark's first commit: ``causal_pairs``, ``attention_bound_ms``
and ``_bwd_bound`` (flash attention), ``_ssd_ops`` and ``_ssd_bytes`` (the
SSD scan), ``_kl_ops`` and ``_kl_bwd_ops`` with the planes
``phase_kl`` / ``phase_kl_received`` count (Eq. 2).  Bytes count each
input read once and each output written once, whatever a kernel reads
again.  ``model_flops`` is the benchmark's own count for MFU.
"""
from __future__ import annotations

from portbench.yard import peaks


def causal_pairs(S: int, window=None) -> float:
    """Unmasked (query, key) pairs of causal self-attention over S
    positions: S(S+1)/2, and with a window w each query sees at most w
    keys (itself and the w - 1 before it)."""
    if window is None or window >= S:
        return S * (S + 1) / 2
    return window * (window + 1) / 2 + (S - window) * window


# ---------------------------------------------------------------------------
# flash attention (bf16 tensor cores)

def attention_fwd(B, S, Hq, Hkv, hd, elt: int = 2) -> tuple:
    """(flops, bytes) of one causal self-attention forward: 4 hd flops per
    unmasked pair per sequence and head; q, k, v read and out, lse (fp32)
    written once."""
    flops = 4.0 * hd * B * Hq * causal_pairs(S)
    nbytes = (2 * B * S * Hq * hd + 2 * B * S * Hkv * hd) * elt \
        + B * Hq * S * 4
    return flops, nbytes


def attention_bwd(B, S, Hq, Hkv, hd, elt: int = 2) -> tuple:
    """(flops, bytes) of its backward: 10 hd flops per unmasked pair (the
    scores again, then dP, dV, dQ, dK); q, k, v, out, dout, lse read and
    dq, dk, dv written."""
    flops = 10.0 * hd * B * Hq * causal_pairs(S)
    nbytes = (4 * B * S * Hq * hd + 4 * B * S * Hkv * hd) * elt \
        + B * Hq * S * 4
    return flops, nbytes


def attention_bound_s(B, S, Hq, Hkv, hd) -> float:
    """Forward and backward bound of one call at the bf16 peak."""
    return sum(peaks.bound_s(*f(B, S, Hq, Hkv, hd), peaks.BF16_FLOPS)
               for f in (attention_fwd, attention_bwd))


# ---------------------------------------------------------------------------
# the SSD scan (bf16 tensor cores)

def ssd_ops(B, S, H, P, G, N, chunk, backward: bool) -> float:
    """Multiply-add operations (x2) the scan needs on these inputs: per
    chunk of l positions and l(l+1)/2 causal pairs, the scores C.B^T once
    per group, and per head the weighted product with x, the inter-chunk
    C.state and the state update.  The backward needs the scores again
    (per group); per head over the pairs dM = dy.x^T and dx = M^T.dy; per
    group over the pairs dB and dC; and per head four (l, P, N) products.
    Elementwise work is not counted."""
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


def ssd_bytes(B, S, H, P, G, N, chunk, elt: int, backward: bool) -> float:
    """Each input read once and each output written once: x, dt, B, C in;
    y, the final state and the fp32 entry states out (forward); x, dt, B,
    C, dy and the entry states in, dx, ddt, dB, dC out (backward)."""
    nc = -(-S // chunk)
    xs, bcs, dts = B * S * H * P * elt, 2 * B * S * G * N * elt, B * S * H * 4
    states = B * H * nc * P * N * 4
    if backward:
        return 2 * xs + bcs + dts + states + xs + dts + bcs
    return xs + bcs + dts + xs + B * H * P * N * 4 + states


def ssd_bound_s(B, S, H, P, G, N, chunk, elt: int = 2) -> float:
    """Forward and backward bound of one scan at the bf16 peak."""
    return sum(peaks.bound_s(ssd_ops(B, S, H, P, G, N, chunk, bwd),
                             ssd_bytes(B, S, H, P, G, N, chunk, elt, bwd),
                             peaks.BF16_FLOPS)
               for bwd in (False, True))


# ---------------------------------------------------------------------------
# Eq. 2, the pair KL (fp32 arithmetic outside the tensor cores)

def kl_fwd_ops(Kl, Kg, B, V, square: bool) -> float:
    """fp32 operations of the pair-KL forward: per (b, v) two per (i, j)
    cross term and about four (max, exp, sum) per client on each side; the
    square case has K (K - 1) cross terms and one side."""
    if square:
        return float(B) * V * (2 * Kl * (Kl - 1) + 4 * Kl)
    return float(B) * V * (2 * Kl * Kg + 4 * (Kl + Kg))


def kl_bwd_ops(Kl, Kg, B, V, square: bool) -> float:
    """fp32 operations of the pair-KL backward (dlive only): per (b, v) and
    live client two for the exponential, two per weighted term and the x
    term, and two multiplies."""
    terms = Kl * (Kl - 1) if square else Kl * Kg
    return float(B) * V * (2 * terms + 6 * Kl)


def kl_bound_s(Kl, Kg, B, V, square: bool, elt: int = 2) -> float:
    """Forward and backward bound of one Eq.-2 call on (Kl, B, V) live
    logits against (Kg, B, V) fixed ones.  Square (fixed is live): one
    plane read and the (Kl, B) fp32 out written; its backward reads the
    plane and the cotangent and writes dlive.  Pair: the live and fixed
    planes read, then live and fixed read and dlive written."""
    plane = B * V * elt                   # one client's (B, V) logits
    vec = B * 4
    if square:
        fwd_b = Kl * plane + Kl * vec
        bwd_b = 2 * Kl * plane + Kl * vec
    else:
        fwd_b = (Kl + Kg) * plane + Kl * vec
        bwd_b = (2 * Kl + Kg) * plane + Kl * vec
    return (peaks.bound_s(kl_fwd_ops(Kl, Kg, B, V, square), fwd_b,
                          peaks.FP32_FLOPS)
            + peaks.bound_s(kl_bwd_ops(Kl, Kg, B, V, square), bwd_b,
                            peaks.FP32_FLOPS))


# ---------------------------------------------------------------------------
# the whole step's model FLOPs (MFU)

def matmul_params(cfg: dict) -> int:
    """Parameters one token meets in a matrix product, from the
    configuration's shapes: each layer's projections and the head (the
    embedding's lookup is no product; with tied embeddings the table
    counts once, as the head).  Norms, biases, the depthwise conv and the
    SSD's per-head scalars are elementwise."""
    d, V = cfg["d_model"], cfg["vocab_size"]
    n = d * V
    for spec in cfg["period"]:
        per = 0
        if spec["mixer"] == "attn":
            hd = cfg["head_dim"]
            per += d * (cfg["n_heads"] + 2 * cfg["n_kv_heads"]) * hd
            per += cfg["n_heads"] * hd * d
        else:
            s = cfg["ssm"]
            di = s["expand"] * d
            nh = di // s["head_dim"]
            per += d * (2 * di + 2 * s["n_groups"] * s["d_state"] + nh)
            per += di * d
        if spec["ffn"] == "mlp":
            per += 3 * d * cfg["d_ff"]
        n += per * (cfg["n_layers"] // len(cfg["period"]))
    return n


def model_flops(cfg: dict, n_seqs: int, S: int) -> float:
    """Model FLOPs of one training pass (forward and backward) over
    ``n_seqs`` sequences of S tokens: 6 x matmul parameters x tokens, plus
    each attention layer's 12 hd flops per causal pair and query head
    (4 forward, 8 backward), plus each SSD layer's forward scan work three
    times (forward and a backward of twice it).  Recompute is not
    counted."""
    flops = 6.0 * matmul_params(cfg) * n_seqs * S
    n_per = cfg["n_layers"] // len(cfg["period"])
    for spec in cfg["period"]:
        if spec["mixer"] == "attn":
            flops += n_per * 12.0 * cfg["head_dim"] * cfg["n_heads"] \
                * causal_pairs(S) * n_seqs
        else:
            s = cfg["ssm"]
            nh = s["expand"] * cfg["d_model"] // s["head_dim"]
            flops += n_per * 3.0 * ssd_ops(n_seqs, S, nh, s["head_dim"],
                                           s["n_groups"], s["d_state"],
                                           s["chunk"], False)
    return flops
