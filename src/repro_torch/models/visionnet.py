"""VisionNet -- the paper's CNN (Fig. 2), the port of
``repro/models/visionnet.py``.

Three 3x3 conv layers (first two followed by 2x2 max-pool), dropout,
dense-64, dropout, single sigmoid output (binary face-mask head).  The
paper's asynchronous-FL baseline needs a shallow/deep split: conv stack =
"shallow", dense head = "deep".

The params keep the JAX layouts -- conv ``w`` HWIO (kh, kw, cin, cout),
``dense.w`` (h*w*c, 64) over an (h, w, c) flatten, ``head.w`` (64, 1) --
so weights cross through ``interop`` as a copy.  The forward takes
client-STACKED params (a leading axis K on every leaf) and runs all K
clients at once: K is folded into the channel axis and each conv is one
grouped ``conv2d(groups=K)`` (the first conv of a batch shared by every
client is one plain conv with the K clients' filters side by side); the
dense layers are ``torch.bmm`` over K.  The JAX package's custom-VJP conv
(``conv_impl``) has no counterpart: it works around XLA on the CPU, and
torch's conv backward is already per group.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.visionnet import VisionNetConfig
from repro_torch.kernels import ops
from repro_torch.tree import tree_map


def _generator(seed_or_generator) -> torch.Generator:
    if isinstance(seed_or_generator, torch.Generator):
        return seed_or_generator
    return torch.Generator().manual_seed(int(seed_or_generator))


def _trunc_normal(shape, scale: float, gen: torch.Generator) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t * scale


def init_visionnet(seed_or_generator, cfg: VisionNetConfig,
                   device=None) -> Dict:
    """One client's params: truncated normals on [-2, 2] scaled by the JAX
    package's fans, zero biases.  Drawn on the CPU from a seed or a CPU
    ``torch.Generator`` (the same draws whatever the device), then moved to
    ``device`` (``None`` = CUDA, raising without one).  Not JAX's bits:
    weights that must match cross through ``interop``."""
    device = ops.resolve_device(device)
    gen = _generator(seed_or_generator)
    params: Dict = {"conv": []}
    c_in = cfg.channels
    size = cfg.image_size
    k = cfg.kernel_size
    for i, c_out in enumerate(cfg.conv_features):
        fan_in = k * k * c_in
        params["conv"].append({
            "w": _trunc_normal((k, k, c_in, c_out), (2.0 / fan_in) ** 0.5,
                               gen),
            "b": torch.zeros((c_out,), dtype=torch.float32)})
        c_in = c_out
        if i < 2:                                    # first two convs pooled
            size //= 2
    flat = size * size * c_in
    params["dense"] = {
        "w": _trunc_normal((flat, cfg.dense_features), (2.0 / flat) ** 0.5,
                           gen),
        "b": torch.zeros((cfg.dense_features,), dtype=torch.float32)}
    params["head"] = {
        "w": _trunc_normal((cfg.dense_features, cfg.n_classes),
                           (1.0 / cfg.dense_features) ** 0.5, gen),
        "b": torch.zeros((cfg.n_classes,), dtype=torch.float32)}
    return tree_map(lambda t: t.to(device), params)


def shallow_deep_split(params: Dict) -> Dict:
    """Bool masks for the async-FL baseline: conv = shallow, rest = deep."""
    return {"conv": [{k: True for k in layer} for layer in params["conv"]],
            **{name: {k: False for k in params[name]}
               for name in params if name != "conv"}}


@contextlib.contextmanager
def strict_fp32():
    """cuDNN convolutions and CUDA matmuls in full fp32 for the span: the
    JAX reference is fp32, and PyTorch lets cuDNN use TF32 by default.
    Wrap the forward AND the backward (autograd reads the flags when the
    backward runs); the previous flags come back on exit, so other paths
    are unaffected."""
    conv, mm = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def _conv(x, layer, groups: int):
    """x (B, groups*cin, H, W) through the K stacked HWIO filters of
    ``layer`` (w (K, kh, kw, cin, cout)): SAME padding, stride 1 -> (B,
    K*cout, H, W).  groups = 1 feeds one image batch to every client."""
    w = layer["w"]
    K, kh, kw, cin, cout = w.shape
    w = w.permute(0, 4, 3, 1, 2).reshape(K * cout, cin, kh, kw)
    return F.conv2d(x, w, layer["b"].reshape(K * cout), padding=kh // 2,
                    groups=groups)


class FleetDraws:
    """The dropout draws of a natural-order fleet of ``n_clients``: the
    n-th draw of a forward is made once, at the whole fleet's shape, from
    ``generator``, and a forward of some of its clients (a mesh entry's)
    takes their rows.  So a sharded fleet draws the masks an unsharded one
    does, and the population's two engines share one draw path.  Call
    ``step()`` before each forward of the fleet and pass ``rows(ids)``
    (``rows()``: every client) to each forward as its ``generator``."""

    def __init__(self, generator: torch.Generator, n_clients: int):
        self.generator, self.n_clients = generator, n_clients
        self._draws = []

    def step(self) -> None:
        self._draws = []

    def rows(self, ids=None) -> "_FleetRows":
        return _FleetRows(self, None if ids is None else torch.as_tensor(ids))


class _FleetRows:
    def __init__(self, fleet: FleetDraws, ids):
        self.fleet, self.ids, self.calls = fleet, ids, 0

    def rand(self, shape, device) -> torch.Tensor:
        f = self.fleet
        if self.calls == len(f._draws):
            f._draws.append(torch.rand(
                (f.n_clients,) + tuple(shape[1:]), generator=f.generator,
                device=f.generator.device))
        u = f._draws[self.calls]
        self.calls += 1
        if self.ids is not None:
            u = u.index_select(0, self.ids.to(u.device))
        return u.to(device)


def dropout(x, rate: float, generator):
    """``x * bernoulli(1 - rate) / (1 - rate)`` with the mask drawn from
    ``generator`` (on ``x``'s device), as the JAX forward computes it;
    ``generator`` may be a ``FleetDraws.rows`` view."""
    keep = 1.0 - rate
    if isinstance(generator, torch.Generator):
        u = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        u = generator.rand(x.shape, x.device)
    return x * (u < keep) / keep


def visionnet_forward(params: Dict, cfg: VisionNetConfig, images, *,
                      train: bool = False,
                      generator=None):
    """Client-stacked forward.  ``images``: (B, H, W, C) in [0, 1] shared by
    all K clients, or (K, B, H, W, C), one batch per client.  Returns the
    sigmoid probabilities (K, B) in fp32.  Dropout runs when ``train`` and
    a ``generator`` (a ``torch.Generator`` or a ``FleetDraws.rows`` view)
    are given (one independent mask per client)."""
    K = params["conv"][0]["w"].shape[0]
    x = images.float()
    if x.dim() == 4:                   # shared: one plain conv for all K
        x = x.permute(0, 3, 1, 2)
        groups = 1
    else:
        _, B, H, W, C = x.shape
        x = x.permute(1, 0, 4, 2, 3).reshape(B, K * C, H, W)
        groups = K
    for i, layer in enumerate(params["conv"]):
        x = F.relu(_conv(x, layer, groups))
        groups = K
        if i < 2:
            x = F.max_pool2d(x, 2)
    B, _, h, w = x.shape
    # back to channels-last before the flatten: dense.w's rows are (h, w, c)
    x = x.reshape(B, K, -1, h, w).permute(1, 0, 3, 4, 2).reshape(K, B, -1)
    drop = train and generator is not None
    if drop:
        x = dropout(x, cfg.dropout_rate, generator)
    x = F.relu(torch.bmm(x, params["dense"]["w"])
               + params["dense"]["b"][:, None, :])
    if drop:
        x = dropout(x, cfg.dropout_rate, generator)
    logits = torch.bmm(x, params["head"]["w"]) + params["head"]["b"][:, None, :]
    return torch.sigmoid(logits[..., 0])


def bce_loss(probs, labels, eps: float = 1e-7):
    """Binary cross-entropy on sigmoid outputs (paper's Model_loss), the
    mean over the last axis: (K, B) -> (K,), (B,) -> a scalar."""
    p = torch.clamp(probs.float(), eps, 1 - eps)
    y = labels.float()
    return -torch.mean(y * torch.log(p) + (1 - y) * torch.log(1 - p), dim=-1)
