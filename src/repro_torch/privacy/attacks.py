"""Attack probes (``repro/privacy/attacks.py``) -- the empirical side of the
privacy battery.

The accountant (``privacy.accountant``) upper-bounds what DP-DML can leak;
these probes measure what the protocols DO leak, so the ordering the
paper's bandwidth argument implies can be checked:

    MIA advantage:  DP-DML  <=  DML payloads  <  FedAvg weight uploads

* **Membership inference** (``mia_advantage`` + the two probes): the
  adversary scores examples and thresholds "member / not member".  Under
  FedAvg it holds the client's uploaded weights and scores each example by
  its loss under them (``weight_upload_mia``).  Under DML it only ever
  sees the (public fold, prediction) payload stream, so it first distills
  a surrogate of the client from that stream (``distill_surrogate``) and
  loss-thresholds under the surrogate (``payload_mia``).  The advantage is
  the threshold-free max_t (TPR - FPR); 0 = chance, 1 = perfect.

* **Gradient inversion / representation leakage**: a parameter gradient
  (what a weight upload reveals) leaks the private example's penultimate
  representation IN CLOSED FORM -- the sigmoid head gives grad_W_head =
  h * (p - y) and grad_b_head = (p - y), so ``features_from_grad`` recovers
  h by one division.  ``gradient_inversion`` is the optimisation attack on
  top (a probe image fitted to the observed gradient by cosine distance,
  Adam; it differentiates a parameter gradient with respect to the input,
  a double backward through the grouped convolutions and max-pools);
  ``payload_reconstruction`` is the matched baseline for prediction
  sharing.

Every model here is one VisionNet client, run through the port's stacked
``visionnet_forward`` as a one-client stack, in full fp32 (``strict_fp32``)
on the device its params live on.  The ``key`` arguments are an int seed
or a CPU ``torch.Generator``: those draws are the port's own.  Everything
is observation-side only: the probes consume the payload tap
(``payload_log``), fold indices (``fold_log``) and parameter trees.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.stacking import expand_stack
from repro_torch.models.visionnet import (_conv, bce_loss, init_visionnet,
                                          strict_fp32, visionnet_forward)
from repro_torch.tree import tree_leaves, tree_map

# ---------------------------------------------------------------------------
# helpers


def _device(params) -> torch.device:
    return tree_leaves(params)[0].device


def _tensor(x, device) -> torch.Tensor:
    """An fp32 tensor on ``device`` from a tensor or an array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().to(device)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _normal(key, shape, device) -> torch.Tensor:
    """Standard-normal fp32 draws from a seed or a CPU generator, made on
    the CPU (the same whatever the device) and moved to ``device``."""
    gen = key if isinstance(key, torch.Generator) else \
        torch.Generator().manual_seed(int(key))
    return torch.randn(tuple(shape), generator=gen).to(device)


def _ravel(tree) -> torch.Tensor:
    """Every leaf flattened into one fp32 vector, dicts in sorted key
    order (``jax.flatten_util.ravel_pytree``'s order), so trees built in
    either package flatten alike."""
    if isinstance(tree, dict):
        return torch.cat([_ravel(tree[k]) for k in sorted(tree)])
    if isinstance(tree, (list, tuple)):
        return torch.cat([_ravel(v) for v in tree])
    return torch.as_tensor(tree).float().reshape(-1)


def _forward(params, vn_cfg, x) -> torch.Tensor:
    """One client's dropout-free probabilities (B,)."""
    return visionnet_forward(expand_stack(params), vn_cfg, x)[0]


def _grad(params, loss_of: Callable, create_graph: bool = False):
    """The gradient of ``loss_of(params)`` with respect to every leaf, as a
    tree like ``params`` (with ``create_graph``, differentiable again)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    grads = iter(torch.autograd.grad(loss_of(live), leaves,
                                     create_graph=create_graph))
    return tree_map(lambda _: next(grads), params)


def _bce_of(vn_cfg, x, y) -> Callable:
    """params -> BCE(f_params(x), y) of one client."""
    return lambda q: bce_loss(_forward(q, vn_cfg, x), y)


# ---------------------------------------------------------------------------
# scoring


def mia_advantage(member_scores, non_member_scores) -> float:
    """max_t (TPR - FPR) of the rule "score >= t -> member".

    Threshold-free: sweeps every achievable threshold (the KS statistic
    of the two score samples).  Scores must be oriented so members are
    expected HIGHER (e.g. pass negated losses).  Returns a float in
    [0, 1]; chance = 0 even when the two samples differ in size.
    """
    m = np.sort(np.asarray(member_scores, np.float64))
    n = np.sort(np.asarray(non_member_scores, np.float64))
    if len(m) == 0 or len(n) == 0:
        raise ValueError("need at least one member and one non-member score")
    thr = np.concatenate([m, n])
    tpr = 1.0 - np.searchsorted(m, thr, side="left") / len(m)
    fpr = 1.0 - np.searchsorted(n, thr, side="left") / len(n)
    return float(np.max(tpr - fpr))


def per_example_bce(probs, labels, eps: float = 1e-7) -> np.ndarray:
    """Elementwise Bernoulli cross-entropy (``models.visionnet.bce_loss``
    is the batch MEAN; the attacks need the per-example vector)."""
    p = np.clip(np.asarray(probs, np.float64), eps, 1.0 - eps)
    y = np.asarray(labels, np.float64)
    return -(y * np.log(p) + (1.0 - y) * np.log(1.0 - p))


# ---------------------------------------------------------------------------
# membership inference


def weight_upload_mia(params, vn_cfg, images, labels, member_idx,
                      non_member_idx, batch: int = 256) -> float:
    """MIA against a WEIGHT upload: the adversary runs the uploaded client
    model and loss-thresholds.  ``params`` is one client's (unstacked)
    tree; returns the advantage."""
    losses = model_example_losses(params, vn_cfg, images, labels, batch)
    return mia_advantage(-losses[np.asarray(member_idx)],
                         -losses[np.asarray(non_member_idx)])


@torch.no_grad()
def model_example_losses(params, vn_cfg, images, labels,
                         batch: int = 256) -> np.ndarray:
    """Per-example BCE of a VisionNet under ``params`` over a pool (numpy
    images and labels)."""
    dev = _device(params)
    out = []
    with strict_fp32():
        for i in range(0, len(images), batch):
            probs = _forward(params, vn_cfg,
                             _tensor(images[i:i + batch], dev))
            out.append(per_example_bce(probs.cpu().numpy(),
                                       labels[i:i + batch]))
    return np.concatenate(out)


def _adam_scan(obj: Callable, x0: torch.Tensor, steps: int,
               lr: float) -> torch.Tensor:
    """Minimise ``obj`` over a tensor with Adam (the JAX package's inlined
    scan, as a loop) -- the attack optimiser."""
    x = x0.detach().float()
    m = torch.zeros_like(x)
    v = torch.zeros_like(x)
    b1 = torch.tensor(0.9, device=x.device)
    b2 = torch.tensor(0.999, device=x.device)
    for i in range(steps):
        xr = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(obj(xr), xr)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        t = torch.tensor(i + 1.0, device=x.device)
        mh = m / (1 - b1 ** t)
        vh = v / (1 - b2 ** t)
        x = x - lr * mh / (torch.sqrt(vh) + 1e-8)
    return x.detach()


def distill_surrogate(vn_cfg, pub_images, target_probs, key,
                      steps: int = 200, lr: float = 0.05, device=None):
    """Train a surrogate VisionNet to mimic an observed payload stream.

    ``pub_images`` (N, H, W, C) public examples and ``target_probs`` (N,)
    the probabilities the victim shared on them -- the ONLY things a
    DML-payload adversary holds.  Full-batch BCE-to-soft-targets descent
    with momentum 0.9 from ``init_visionnet(key)`` on ``device`` (None =
    the CUDA device); returns the surrogate params.
    """
    params = init_visionnet(key, vn_cfg, device)
    dev = _device(params)
    imgs = _tensor(pub_images, dev)
    tgt = _tensor(target_probs, dev)
    def soft_bce(q):
        pr = torch.clamp(_forward(q, vn_cfg, imgs), 1e-7, 1 - 1e-7)
        return -torch.mean(tgt * torch.log(pr) + (1 - tgt) * torch.log(1 - pr))

    vel = tree_map(torch.zeros_like, params)
    with strict_fp32():
        for _ in range(steps):
            g = _grad(params, soft_bce)
            vel = tree_map(lambda v_, gg: 0.9 * v_ + gg, vel, g)
            params = tree_map(lambda q, v_: (q - lr * v_).detach(), params,
                              vel)
    return params


def payload_mia(vn_cfg, pub_images, target_probs, images, labels,
                member_idx, non_member_idx, key, steps: int = 200,
                lr: float = 0.05, device=None) -> float:
    """MIA against a PREDICTION payload stream: distill a surrogate from
    the observed (public image, shared probability) pairs, then
    loss-threshold under the surrogate.  The same probe measures plain DML
    (raw payloads) and DP-DML (noised payloads)."""
    surrogate = distill_surrogate(vn_cfg, pub_images, target_probs, key,
                                  steps=steps, lr=lr, device=device)
    return weight_upload_mia(surrogate, vn_cfg, images, labels,
                             member_idx, non_member_idx)


def collect_client_payloads(payload_log, images, client: int):
    """Flatten a ``VisionClients.payload_log`` into the (public images,
    shared probs) pairs an eavesdropper observed from ``client``: returns
    (imgs (N, H, W, C), probs (N,)) over all rounds and epochs."""
    im, pr = [], []
    for rec in payload_log:
        pay = rec["payloads"]                      # (E, K, B)
        pub = rec["public"]
        for e in range(pay.shape[0]):
            im.append(images[pub])
            pr.append(pay[e, client])
    if not im:
        raise ValueError("payload_log is empty -- construct the population "
                         "with record_payloads=True and run rounds first")
    return np.concatenate(im), np.concatenate(pr)


# ---------------------------------------------------------------------------
# gradient inversion


def example_gradient(params, vn_cfg, x, y):
    """The parameter-space gradient a weight-sharing round reveals for a
    (batch of) private example(s): grad_theta BCE(f_theta(x), y), a tree
    like ``params`` (one client, no leading axis)."""
    dev = _device(params)
    with strict_fp32():
        return _grad(params, _bce_of(vn_cfg, _tensor(x, dev),
                                     _tensor(y, dev)))


@torch.no_grad()
def dense_features(params, vn_cfg, images) -> torch.Tensor:
    """The penultimate (post-dense, pre-head) representation h: (B, D).
    ``visionnet_forward`` dropout-free up to the head."""
    dev = _device(params)
    x = _tensor(images, dev).permute(0, 3, 1, 2)
    with strict_fp32():
        for i, cp in enumerate(params["conv"]):
            x = F.relu(_conv(x, expand_stack(cp), 1))
            if i < 2:
                x = F.max_pool2d(x, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return F.relu(x @ params["dense"]["w"] + params["dense"]["b"])


def features_from_grad(grad) -> np.ndarray:
    """EXACT representation recovery from one example's gradient.

    The sigmoid head is linear in h: grad_W_head = h * (p - y) and
    grad_b_head = (p - y), so h = grad_W_head[:, 0] / grad_b_head[0].
    Takes one client's gradient tree, or a stacked one of a single client
    (a leading axis of 1).  Undefined when p == y exactly.
    """
    gw = np.asarray(torch.as_tensor(grad["head"]["w"]).detach().cpu(),
                    np.float64)
    gb = np.asarray(torch.as_tensor(grad["head"]["b"]).detach().cpu(),
                    np.float64)
    if gw.ndim == 3:                       # a one-client stack
        gw, gb = gw[0], gb[0]
    gb0 = float(gb[0])
    if abs(gb0) < 1e-12:
        raise ValueError("grad_b_head == 0 (p == y exactly); the head "
                         "gradient carries no scale to divide out")
    return gw[:, 0] / gb0


def cosine_similarity(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.dot(a, b) /
                 (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def gradient_inversion(params, vn_cfg, target_grad, x_shape, y, key,
                       steps: int = 800, lr: float = 0.1):
    """The inverting-gradients attack: optimise a probe batch x (Adam) to
    minimise the cosine distance between grad_theta BCE(f_theta(x), y) and
    the observed ``target_grad`` (a tree of either package).  Returns
    (reconstruction (numpy), final cosine distance)."""
    dev = _device(params)
    flat_tgt = _ravel(target_grad).to(dev)
    yy = _tensor(y, dev)

    def cosine_obj(x):
        fg = _ravel(_grad(params, _bce_of(vn_cfg, x, yy), create_graph=True))
        denom = torch.linalg.vector_norm(fg) * \
            torch.linalg.vector_norm(flat_tgt) + 1e-12
        return 1.0 - torch.dot(fg, flat_tgt) / denom

    with strict_fp32():
        x = _adam_scan(cosine_obj, 0.1 * _normal(key, x_shape, dev), steps,
                       lr)
        dist = float(cosine_obj(x).detach())
    return x.cpu().numpy(), dist


def payload_reconstruction(vn_cfg, surrogate_params, prob, x_shape, key,
                           steps: int = 800, lr: float = 0.1):
    """The matched payload-only baseline: all a prediction payload pins
    down is a few output probabilities, so the best reconstruction
    objective available is "find x whose prediction matches the shared
    prob", which constrains neither the pixels nor the representation.
    Returns the (chance-level) reconstruction (numpy)."""
    dev = _device(surrogate_params)
    p_tgt = _tensor(prob, dev)

    def obj(x):
        pr = _forward(surrogate_params, vn_cfg, x)
        return torch.mean((pr - p_tgt) ** 2)

    with strict_fp32():
        x = _adam_scan(obj, 0.1 * _normal(key, x_shape, dev), steps, lr)
    return x.cpu().numpy()


def reconstruction_error(x_rec, x_true) -> float:
    """Scale-invariant per-pixel error: MSE after matching mean/std (an
    inversion that recovers structure up to affine intensity still
    counts; pure noise does not)."""
    a = np.asarray(x_rec, np.float64).ravel()
    b = np.asarray(x_true, np.float64).ravel()
    a = (a - a.mean()) / (a.std() + 1e-12)
    b = (b - b.mean()) / (b.std() + 1e-12)
    # sign-invariant too: cosine objectives can invert contrast
    return float(min(np.mean((a - b) ** 2), np.mean((a + b) ** 2)))
