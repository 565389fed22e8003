"""The batched serving engine: continuous batching and multi-step decode
over trained DML populations, on the card.

One ``ServeEngine`` owns a fixed-shape cache arena (``serve.cache``), a
host-side slot scheduler (``serve.scheduler``) and four programs, each
logged by name in ``dispatch_log`` once per call:

  prefill      prompt ingestion for all clients (self-attention through the
               engine's kernel impl; the flash kernel on the card)
  router       route mode only: per-client prompt CE -> argmin client
  first_token  sample the first emission from the prefill logits
  decode       a whole multi-step decode: a loop of decode steps with
               in-place ring-cache updates; in ensemble modes each step runs
               the K stacked clients and samples from the combined logits

so the number of program calls for a generation is CONSTANT in
``gen_len`` (``generate``: prefill + first_token + one decode), and the
continuous-batching loop (``submit``/``run``) calls the SAME decode program
on the whole arena between admissions.

Sampling: ``temperature``/``top_k`` are engine-level constants (greedy ==
``temperature=0``, an exact argmax); random draws come from a
``torch.Generator`` seeded with ``seed``, one draw per step, so a fixed
seed makes every schedule deterministic and chunked decodes chain
identically with one longer decode.

The engine runs on the card: ``device=None`` means CUDA and raises without
it; ``device="cpu"`` (the tests) runs the plain PyTorch versions.  The
kernel impl is resolved once here (``kernels.ops.resolve_impl``) and passed
to every call that can reach a kernel.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import resolve_device, resolve_impl
from repro_torch.launch.steps import sample_token
from repro_torch.models import transformer as tfm
from repro_torch.serve import cache as cache_mod
from repro_torch.serve.ensemble import (combine_logits, load_serving_params,
                                        make_router)
from repro_torch.serve.scheduler import SlotScheduler
from repro_torch.tree import tree_leaves, tree_map

MODES = ("single", "average", "route")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class ServeEngine:
    """Serve one model or a stacked K-client ensemble.

    ``params``: a plain model tree (``mode='single'``) or the stacked
    (K, ...) client tree of a trained LM population (ensemble modes), on
    the engine's device.  ``slots`` x ``max_seq`` fixes the arena shape --
    every admitted request must satisfy ``P + len(prompt) + max_new <=
    max_seq``, P the arch's prefix tokens (0 without a prefix frontend).
    A prefix-token arch takes each request's frontend embedding: (B, P,
    prefix_dim) for ``generate``, (P, prefix_dim) for ``submit``.
    """

    def __init__(self, cfg: ModelConfig, params, *, mode: str = "single",
                 slots: int = 4, max_seq: int = 128,
                 window: Optional[int] = None, temperature: float = 0.0,
                 top_k: int = 0, chunk: int = 8, seed: int = 0,
                 impl: Optional[str] = None, device=None):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        self.device = resolve_device(device)
        self.impl = resolve_impl(impl, self.device)
        leaves = tree_leaves(params)
        wrong = {str(t.device) for t in leaves if t.device != self.device}
        if wrong:
            raise ValueError(f"params on {sorted(wrong)}, engine on "
                             f"{self.device}: move them first")
        stacked = mode != "single"
        if stacked:
            ks = {int(t.shape[0]) for t in leaves}
            if len(ks) != 1:
                raise ValueError(
                    f"ensemble mode {mode!r} needs params stacked on a "
                    f"uniform leading client axis, got sizes {sorted(ks)}")
        self.cfg = cfg
        self.params = params
        # the programs always see a client axis: a single model is K = 1
        self._sparams = (params if stacked
                         else tree_map(lambda t: t[None], params))
        self.mode = mode
        self.n_models = int(leaves[0].shape[0]) if stacked else 1
        self.slots = slots
        self.max_seq = max_seq
        self.window = window
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.chunk = int(chunk)
        self.seed = seed
        self.scheduler = SlotScheduler(slots)
        self.dispatch_log: List[str] = []     # one entry per program call
        self._arena = None
        self._tok = self._pos = self._cidx = self._gen = None

    @classmethod
    def from_checkpoint(cls, path: str, *, mode: str = "average",
                        client: int = 0, device=None,
                        **kw) -> "ServeEngine":
        """Build an engine from a checkpoint written by the JAX package
        (see ``load_serving_params``).  ``mode='single'`` serves ``client``
        of the stacked population."""
        device = resolve_device(device)
        cfg, params, n_clients = load_serving_params(path, device=device)
        if mode == "single":            # a copy: the other clients are freed
            params = tree_map(lambda t: t[client].clone(), params)
        eng = cls(cfg, params, mode=mode, device=device, **kw)
        eng.n_checkpoint_clients = n_clients
        return eng

    # -- programs ---------------------------------------------------------
    def _call(self, name, fn, *args, **kw):
        self.dispatch_log.append(name)
        return fn(*args, **kw)

    def _combine(self, logits, client_idx):
        """(K, B, V) -> (B, V) served logits."""
        if self.mode == "single":
            return logits[0]
        return combine_logits(
            logits, "average" if self.mode == "average" else "route",
            client_idx)

    @property
    def _prefix_P(self) -> int:
        return self.cfg.prefix_tokens

    def _prefill(self, prompts, prefix=None):
        return tfm.prefill_clients(self._sparams, self.cfg, prompts, prefix,
                                   max_seq=self.max_seq, window=self.window,
                                   impl=self.impl)

    def _router(self, prompts, prefix=None):
        return make_router(self.cfg, self.impl)(self._sparams, prompts,
                                                prefix)

    def _first_token(self, logits, client_idx, gen):
        comb = self._combine(logits, client_idx)
        return sample_token(comb, gen, self.temperature, self.top_k), comb

    def _raw_decode(self, tok, cache, pos):
        """One decode step of every client -> ((K, B, V) logits, cache)."""
        return tfm.decode_step_clients(self._sparams, self.cfg, tok, cache,
                                       pos, window=self.window)

    def _decode(self, n_steps: int, tok, cache, pos, gen, client_idx, *,
                keep_logits: bool = False, carry: bool = True):
        """``n_steps`` decode steps.  ``tok`` (B, 1) is the next token to
        EMIT; returns (tokens (B, n), logits (B, n, V) or None, cache, next
        token, next pos).  Logits are stacked only with ``keep_logits``.
        With neither ``keep_logits`` nor ``carry`` the last step's forward,
        whose sample no caller emits, is not run; the returned cache, token
        and pos then stop one step short."""
        toks, logits = [], []
        for i in range(n_steps):
            toks.append(tok[:, 0])
            if i == n_steps - 1 and not (keep_logits or carry):
                break
            lo, cache = self._raw_decode(tok, cache, pos)
            comb = self._combine(lo, client_idx)
            if keep_logits:
                logits.append(comb)
            tok = sample_token(comb, gen, self.temperature,
                               self.top_k)[:, None]
            pos = pos + 1
        return (torch.stack(toks, dim=1),
                torch.stack(logits, dim=1) if keep_logits else None, cache,
                tok, pos)

    def oracle_step(self, tok, cache, pos, client_idx=None):
        """The one-step reference: the same per-client decode and
        ``combine_logits`` expression, called on its own.  ``cache`` is the
        client-stacked tree (updated in place)."""
        logits, cache = self._raw_decode(tok, cache, pos)
        return self._combine(logits, client_idx), cache

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                               device=self.device)

    def _prefix(self, prefix):
        """A request's frontend embedding as an fp32 tensor on the device
        (None stays None)."""
        if prefix is None:
            return None
        return torch.as_tensor(np.asarray(prefix, np.float32),
                               device=self.device)

    # -- one-shot batch API (O(1) program calls in gen_len) ---------------
    def generate(self, prompts, gen_len: int, prefix=None,
                 seed: Optional[int] = None, return_logits: bool = False):
        """Generate ``gen_len`` tokens for a fixed prompt batch (B, S0).

        Exactly prefill + first_token + one multi-step decode (+ router in
        route mode): the call count does not depend on ``gen_len``.  The
        decode runs ``gen_len - 1`` forward steps, and one more only with
        ``return_logits``, whose last row is the next token's logits.
        Returns int32 tokens (B, gen_len) and, with ``return_logits``, the
        fp32 logits (B, gen_len, V) each emission after the first was
        sampled from.  ``prefix`` (B, P, prefix_dim) for a prefix-token
        arch; decoding starts at position P + S0.
        """
        prompts = self._tokens(prompts)
        prefix = self._prefix(prefix)
        B, S0 = prompts.shape
        P = self._prefix_P
        if P + S0 + gen_len > self.max_seq:
            raise ValueError(f"prefix {P} + prompt {S0} + gen {gen_len} "
                             f"exceeds max_seq {self.max_seq}")
        gen = torch.Generator(device=self.device).manual_seed(
            self.seed if seed is None else seed)
        cidx = torch.zeros((B,), dtype=torch.long, device=self.device)
        if self.mode == "route":
            cidx, _ = self._call("router", self._router, prompts, prefix)
        logits, cache = self._call("prefill", self._prefill, prompts, prefix)
        tok0, _ = self._call("first_token", self._first_token, logits, cidx,
                             gen)
        toks, lg, *_ = self._call("decode", self._decode, gen_len,
                                  tok0[:, None], cache, P + S0, gen, cidx,
                                  keep_logits=return_logits, carry=False)
        toks = _host(toks.to(torch.int32))
        if return_logits:
            return toks, _host(lg.float())
        return toks

    # -- continuous batching ----------------------------------------------
    def submit(self, tokens, max_new: int, prefix=None) -> int:
        """Queue one request (``prefix`` (P, prefix_dim) for a prefix-token
        arch); returns its request id."""
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim != 1 or not len(tokens):
            raise ValueError("submit takes a single 1-D prompt")
        P = self._prefix_P
        if P + len(tokens) + max_new > self.max_seq:
            raise ValueError(f"prefix {P} + prompt {len(tokens)} + max_new "
                             f"{max_new} exceeds max_seq {self.max_seq}")
        if P and prefix is None:
            raise ValueError(f"{self.cfg.name} needs a (P, prefix_dim) "
                             "prefix embedding per request")
        return self.scheduler.submit(tokens, max_new, prefix)

    def _ensure_arena(self):
        if self._arena is None:
            self._arena = cache_mod.init_arena(
                self.cfg, self.slots, self.max_seq, window=self.window,
                n_models=self.n_models, device=self.device)
            zeros = dict(dtype=torch.long, device=self.device)
            self._tok = torch.zeros((self.slots, 1), **zeros)
            self._pos = torch.zeros((self.slots,), **zeros)
            self._cidx = torch.zeros((self.slots,), **zeros)
            self._gen = torch.Generator(device=self.device).manual_seed(
                self.seed)

    def _admit(self, slot: int) -> None:
        req = self.scheduler.admit(slot)
        prompts = self._tokens(req.tokens)[None]
        prefix = None if req.prefix is None else self._prefix(req.prefix)[None]
        ci = torch.zeros((1,), dtype=torch.long, device=self.device)
        if self.mode == "route":
            ci, _ = self._call("router", self._router, prompts, prefix)
        logits, one = self._call("prefill", self._prefill, prompts, prefix)
        tok0, _ = self._call("first_token", self._first_token, logits, ci,
                             self._gen)
        cache_mod.write_slot(self._arena, one, slot,
                             axis=cache_mod.batch_axis(self.n_models))
        self._tok[slot, 0] = tok0[0]
        self._pos[slot] = self._prefix_P + len(req.tokens)
        self._cidx[slot] = ci[0]

    def run(self) -> Dict[int, np.ndarray]:
        """Drain the queue with continuous batching: admit into free
        slots, decode the whole arena for ``chunk`` steps in one call,
        credit/retire, repeat.  Returns {rid: (n,) int32 tokens}."""
        self._ensure_arena()
        sched = self.scheduler
        while not sched.idle:
            for b in sched.free_slots():
                if sched.next_request() is None:
                    break
                self._admit(b)
            active = sched.active_slots()
            toks, _, self._arena, self._tok, self._pos = self._call(
                "decode", self._decode, self.chunk, self._tok, self._arena,
                self._pos, self._gen, self._cidx)
            toks = _host(toks.to(torch.int32))
            for b in active:
                sched.record(b, toks[b])
        out, sched.done = dict(sched.done), {}
        return out

    # -- introspection ----------------------------------------------------
    def dispatch_counts(self) -> Dict[str, int]:
        return {n: self.dispatch_log.count(n)
                for n in sorted(set(self.dispatch_log))}
