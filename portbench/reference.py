"""The plain reference: K federated DML clients in plain PyTorch, fp32.

It imports nothing of the port (nor of the JAX package) and calls no
kernel: attention is a softmax over the causal scores, the SSD scan the
chunked quadratic form of Mamba2's paper, Eq. 2 the KL written out.  It
takes the weights the benchmark made (``weights.make_weights``) and the
batches of its own token streams (``yard.tokens``), and computes every
round as the configuration states it:

  - each client's loss is private CE + public CE + kl_weight * Eq. 2
    against the other clients' public predictions, held fixed;
  - one AdamW step (cosine schedule with warmup, decoupled weight decay
    on matrices) after the gradient is clipped by the global norm over
    every client's gradient, or by each client's own norm on a client
    mesh;
  - the parameters are stored in the configuration's param dtype after
    each step (bf16 rounds the fp32 update), Mamba2's per-head leaves in
    fp32.

Arithmetic is fp32 with TF32 off.  ``precision="fp8"`` is the control:
every matrix product's operands rounded to float8 e4m3 with one scale per
tensor (the rounding passes the gradient straight through).  Clients sit
on ``devices`` round-robin; a client's layers are separate tensors, each
recomputed in the backward (a checkpoint per layer) so that 48 layers fit.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.weights import leaves

STORE = {"bfloat16": torch.bfloat16, "float32": torch.float32}
FP8_MAX = 448.0
_NO_DECAY = ("norm", "bias", "b_qkv", "A_log", "D", "dt_bias", "conv_b", "b")


def _decays(path) -> bool:
    """Weight decay on matrices only: no leaf whose path names a norm, a
    bias or one of Mamba2's per-head scalars."""
    return not any(n in _NO_DECAY or "norm" in n for n in path)


class Precision:
    """fp32 products, or (the control) products of fp8-rounded operands."""

    def __init__(self, name: str):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.fp8 = name == "fp8"

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return t
        scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        r = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return t + (r - t.detach())

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.q(a), self.q(b))


def rms(x, w, eps: float):
    """RMSNorm scaled by 1 + w (the parameterisation of the weights)."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1 + w)


def rope(x, theta: float):
    """Split-halves rotary embedding over positions 0..S-1; x (B, S, H, hd)."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device,
                                         dtype=torch.float32) / hd)
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q, k, v, prec: Precision):
    """Softmax(q k^T / sqrt(hd)) v over keys at or before each query; k, v
    (B, S, Hkv, hd) serve H / Hkv query heads each."""
    B, S, H, hd = q.shape
    g = H // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    scores = prec.mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) * hd ** -0.5
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return prec.mm(p, v.transpose(1, 2)).transpose(1, 2)


def attn_layer(p: dict, x, cfg: dict, prec: Precision):
    eps = cfg["rms_eps"]
    H, Hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    B, S, d = x.shape
    h = rms(x, p["norm1"], eps)
    qkv = prec.mm(h, p["mixer.w_qkv"].reshape(d, -1)).reshape(B, S, -1, hd)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + Hkv], qkv[:, :, H + Hkv:]
    if cfg.get("qk_norm"):
        q = rms(q, p["mixer.q_norm"], eps)
        k = rms(k, p["mixer.k_norm"], eps)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    o = causal_attention(q, k, v, prec).reshape(B, S, H * hd)
    return x + prec.mm(o, p["mixer.w_o"].reshape(H * hd, d))


def ssd_scan(x, dt, A, Bm, Cm, chunk: int, prec: Precision):
    """y_t = sum_{s <= t} C_t . B_s exp(sum_{s < u <= t} dt_u A) dt_s x_s,
    computed a chunk at a time: the quadratic form inside a chunk, the
    state (H, P, N) carried between chunks.  x (B, S, H, P), dt (B, S, H),
    A (H,), B/C (B, S, G, N) with H / G heads to a group."""
    b, S, H, P = x.shape
    rep = H // Bm.shape[2]
    Bh = Bm.repeat_interleave(rep, dim=2)
    Ch = Cm.repeat_interleave(rep, dim=2)
    pad = (-S) % chunk
    if pad:
        padf = lambda t: F.pad(t, [0, 0] * (t.dim() - 2) + [0, pad])  # noqa
        x, dt, Bh, Ch = map(padf, (x, dt, Bh, Ch))
    nc, L = (S + pad) // chunk, chunk
    X = (x * dt[..., None]).reshape(b, nc, L, H, P)
    Bc = Bh.reshape(b, nc, L, H, -1)
    Cc = Ch.reshape(b, nc, L, H, -1)
    cs = torch.cumsum((dt * A).reshape(b, nc, L, H), dim=2)  # (b,c,l,h)
    csh = cs.permute(0, 1, 3, 2)                              # (b,c,h,l)
    tri = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp((csh[..., :, None] - csh[..., None, :])
                      .masked_fill(~tri, float("-inf")))      # (b,c,h,l,s)
    scores = prec.mm(Cc.permute(0, 1, 3, 2, 4), Bc.permute(0, 1, 3, 4, 2))
    y = prec.mm(scores * decay, X.permute(0, 1, 3, 2, 4))     # (b,c,h,l,p)
    # each chunk's contribution to the state at its end
    tail = torch.exp(csh[..., -1:] - csh)                     # (b,c,h,l)
    states = prec.mm((X.permute(0, 1, 3, 4, 2) * tail[..., None, :]),
                     Bc.permute(0, 1, 3, 2, 4))               # (b,c,h,p,n)
    carry = torch.zeros_like(states[:, 0])
    entry = []
    for c in range(nc):
        entry.append(carry)
        carry = torch.exp(csh[:, c, :, -1])[..., None, None] * carry \
            + states[:, c]
    entry = torch.stack(entry, dim=1)                         # (b,c,h,p,n)
    y = y + prec.mm(Cc.permute(0, 1, 3, 2, 4), entry.transpose(-1, -2)) \
        * torch.exp(csh)[..., None]
    return y.permute(0, 1, 3, 2, 4).reshape(b, nc * L, H, P)[:, :S]


def mamba_layer(p: dict, x, cfg: dict, prec: Precision):
    s, eps = cfg["ssm"], cfg["rms_eps"]
    B, S, d = x.shape
    di = s["expand"] * d
    nh, P = di // s["head_dim"], s["head_dim"]
    gn = s["n_groups"] * s["d_state"]
    h = rms(x, p["norm1"], eps)
    zxbcdt = prec.mm(h, p["mixer.in_proj"])
    z, xbc, dtr = zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * gn], \
        zxbcdt[..., 2 * di + 2 * gn:]
    w, kc = p["mixer.conv_w"], s["d_conv"]
    xp = F.pad(xbc, (0, 0, kc - 1, 0))
    conv = sum(xp[:, i:i + S] * w[i] for i in range(kc)) + p["mixer.conv_b"]
    act = F.silu(conv)
    xs = act[..., :di].reshape(B, S, nh, P)
    Bm = act[..., di:di + gn].reshape(B, S, s["n_groups"], s["d_state"])
    Cm = act[..., di + gn:].reshape(B, S, s["n_groups"], s["d_state"])
    dt = F.softplus(dtr + p["mixer.dt_bias"])
    A = -torch.exp(p["mixer.A_log"])
    y = ssd_scan(xs, dt, A, Bm, Cm, s["chunk"], prec)
    y = (y + p["mixer.D"][:, None] * xs).reshape(B, S, di)
    y = rms(y * F.silu(z), p["mixer.norm"], eps)
    return x + prec.mm(y, p["mixer.out_proj"])


def ffn(p: dict, x, cfg: dict, prec: Precision):
    h = rms(x, p["norm2"], cfg["rms_eps"])
    a = F.silu(prec.mm(h, p["ffn.w_gate"])) * prec.mm(h, p["ffn.w_up"])
    return x + prec.mm(a, p["ffn.w_down"])


def layer(p: dict, x, cfg: dict, slot: int, prec: Precision):
    spec = cfg["period"][slot]
    x = (attn_layer if spec["mixer"] == "attn" else mamba_layer)(
        p, x, cfg, prec)
    return ffn(p, x, cfg, prec) if spec["ffn"] == "mlp" else x


def logits(params: dict, cfg: dict, tokens, prec: Precision, remat: bool):
    """(B, S, V) fp32 logits of one client on tokens (B, S)."""
    x = params["embed"][tokens]
    n = len(cfg["period"])
    for i, lp in enumerate(params["layers"]):
        if remat:
            x = checkpoint(layer, lp, x, cfg, i % n, prec,
                           use_reentrant=False)
        else:
            x = layer(lp, x, cfg, i % n, prec)
    x = rms(x, params["final_norm"], cfg["rms_eps"])
    head = params["embed"].t() if cfg.get("tie_embeddings") \
        else params["lm_head"]
    return prec.mm(x, head)


def next_token_ce(lg, tokens):
    """Mean CE of rows 0..S-2 predicting tokens 1..S-1."""
    lp = torch.log_softmax(lg[:, :-1], dim=-1)
    return -torch.gather(lp, -1, tokens[:, 1:, None]).mean()


# ---------------------------------------------------------------------------
# the fleet


def _split(stacked: dict, cfg: dict, c: int, device) -> dict:
    """Client ``c``'s weights from the stacked tree: fp32 leaves, one
    dict of "<mixer|ffn>.<name>" / "norm1" / "norm2" leaves per layer."""
    n = len(cfg["period"])
    out = {"layers": [dict() for _ in range(cfg["n_layers"])]}
    for path, t in leaves(stacked):
        x = t[c].to(device=device, dtype=torch.float32)
        if path[0] != "periods":
            out[path[0]] = x
            continue
        slot = int(path[1][4:])
        name = ".".join(path[2:])
        for j in range(x.shape[0]):
            out["layers"][j * n + slot][name] = x[j].clone()
    return out


def _param_paths(params: dict, cfg: dict):
    """(key in the client's dict, program path, param dtype, tensor) of
    every leaf; per-layer leaves map to the program's stacked path."""
    n = len(cfg["period"])
    fp32 = {"mixer.A_log", "mixer.D", "mixer.dt_bias"}
    for k in ("embed", "final_norm", "lm_head"):
        if k in params:
            yield (k,), (k,), cfg["param_dtype"], params[k]
    for i, lp in enumerate(params["layers"]):
        for name, t in lp.items():
            path = ("periods", f"slot{i % n}") + tuple(name.split("."))
            yield (i, name), path, \
                "float32" if name in fp32 else cfg["param_dtype"], t


class RefFleet:
    """K clients of the plain model, stepped as the configuration states."""

    def __init__(self, stacked: dict, cfg: dict, traffic: dict,
                 devices: Sequence, precision: str = "fp32"):
        self.cfg, self.tr = cfg, traffic
        self.K = traffic["clients"]
        self.devices = [torch.device(d) for d in devices]
        self.prec = Precision(precision)
        self.params = [_split(stacked, cfg, c, self.dev(c))
                       for c in range(self.K)]
        self.mu = [self._zeros(p) for p in self.params]
        self.nu = [self._zeros(p) for p in self.params]
        self.step = 0

    def dev(self, c: int) -> torch.device:
        return self.devices[c % len(self.devices)]

    def _zeros(self, params):
        return {key: torch.zeros_like(t)
                for key, _, _, t in _param_paths(params, self.cfg)}

    def lr(self, step: int) -> float:
        base, warm, total = self.tr["lr"], self.tr["warmup"], \
            self.tr["rounds"]
        if step < warm:
            return base * step / max(warm, 1)
        prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
        return base * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))

    def round(self, priv: np.ndarray, pub: np.ndarray,
              fault: Optional[str] = None) -> Dict:
        """One fused DML round on private tokens (K, B, S) and public
        tokens (B_pub, S).  ``fault`` plants a fault for the check's
        readings: "half_batch" (the private loss over half the batch),
        "no_exchange" (Eq. 2 only among the clients of one card of a
        client mesh).  Returns the round's per-client losses and the
        norms of each client's clipped gradient by program path."""
        K, cfg, prec = self.K, self.cfg, self.prec
        kw = self.tr["kl_weight"]
        with torch.no_grad():
            fixed = [torch.log_softmax(logits(
                self.params[c], cfg, torch.as_tensor(pub, device=self.dev(c),
                                                     dtype=torch.long),
                prec, False).reshape(-1, cfg["vocab_size"]), dim=-1)
                for c in range(K)]
        grads, out = [], {"private_ce": [], "public_ce": [], "kl": []}
        n_dev = self.tr.get("cards", 1)
        for c in range(K):
            dev = self.dev(c)
            peers = [j for j in range(K) if j != c and
                     (fault != "no_exchange" or j % n_dev == c % n_dev)]
            keys = [(key, t) for key, _, _, t in
                    _param_paths(self.params[c], cfg)]
            for _, t in keys:
                t.requires_grad_(True)
            p_tok = torch.as_tensor(priv[c], device=dev, dtype=torch.long)
            if fault == "half_batch":
                p_tok = p_tok[:p_tok.shape[0] // 2]
            q_tok = torch.as_tensor(pub, device=dev, dtype=torch.long)
            with torch.enable_grad():
                lg = logits(self.params[c], cfg,
                            torch.cat([p_tok, q_tok]), prec, remat=True)
                ce_p = next_token_ce(lg[:p_tok.shape[0]], p_tok)
                pub_lg = lg[p_tok.shape[0]:]
                ce_q = next_token_ce(pub_lg, q_tok)
                del lg
                lp = torch.log_softmax(
                    pub_lg.reshape(-1, cfg["vocab_size"]), dim=-1)
                if peers:
                    other = sum(fixed[j].to(dev) for j in peers) / len(peers)
                    kl = (lp.exp() * (lp - other)).sum(-1).mean()
                else:
                    kl = torch.zeros((), device=dev)
                total = ce_p + ce_q + kw * kl
                g = torch.autograd.grad(total, [t for _, t in keys])
            for _, t in keys:
                t.requires_grad_(False)
            grads.append(dict(zip([k for k, _ in keys], g)))
            # read on the host after the loop: no sync between clients, so
            # the cards of a mesh overlap
            out["private_ce"].append(ce_p.detach())
            out["public_ce"].append(ce_q.detach())
            out["kl"].append(kl.detach())
            del total, g, pub_lg, lp
        for k in ("private_ce", "public_ce", "kl"):
            out[k] = [float(v) for v in out[k]]
        self._update(grads)
        out["grad_norms"] = [self._norms(g, c) for c, g in enumerate(grads)]
        return out

    def _norms(self, tree: dict, c: int) -> Dict[tuple, float]:
        """Norm of each program path's leaf of client ``c`` (a stacked
        leaf's layers together)."""
        sq: Dict[tuple, torch.Tensor] = {}
        for key, path, _, _ in _param_paths(self.params[c], self.cfg):
            s = tree[key].double().square().sum()
            sq[path] = sq[path] + s.to(sq[path].device) if path in sq else s
        return {p: float(v.sqrt()) for p, v in sq.items()}

    def _update(self, grads: List[dict]) -> None:
        tr = self.tr
        clip = tr.get("clip_norm", 1.0)
        sq = [sum(g.double().square().sum().to(self.devices[0])
                  for g in gs.values()) for gs in grads]
        if tr.get("cards", 1) > 1:            # each client by its own norm
            norms = [torch.sqrt(s) for s in sq]
        else:                                 # one norm over the fleet
            norms = [torch.sqrt(sum(sq))] * len(grads)
        self.step += 1
        lr, b1, b2, eps, wd = self.lr(self.step), 0.9, 0.95, 1e-8, 0.1
        bc1, bc2 = 1 - b1 ** self.step, 1 - b2 ** self.step
        for c, gs in enumerate(grads):
            scale = float(torch.clamp(clip / torch.clamp(norms[c], min=1e-9),
                                      max=1.0))
            for key, path, dtype, p in _param_paths(self.params[c], self.cfg):
                g = gs[key] * scale
                gs[key] = g
                mu, nu = self.mu[c][key], self.nu[c][key]
                mu.mul_(b1).add_(g, alpha=1 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
                if _decays(path):
                    u = u + wd * p
                p.copy_((p - lr * u).to(STORE[dtype]).float())
