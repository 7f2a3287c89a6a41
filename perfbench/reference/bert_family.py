"""Plain float32 reference of the bert family's training step: the encoder
(or causal decoder), the tied head, the softmax cross-entropy and AdamW.

Written from the published descriptions (BERT, arXiv:1810.04805; GPT-2;
AdamW, arXiv:1711.05101) and from the mathematics the port's model file
documents. It imports nothing of the program and takes nothing the program
made: the benchmark hands it the same weights and rows it hands the
program, and it works the rest out again. Departures from the published
models, all as the port's model runs them:

- pre-LayerNorm layers (BERT is post-LN; GPT-2 is pre-LN), LayerNorm
  epsilon 1e-6, a final LayerNorm before the head;
- GELU in its tanh form (GPT-2's ``gelu_new``; BERT's exact erf form
  differs by under 1e-3);
- no token-type embeddings, no pooler, no next-sentence head, no MLM
  transform: the head is the token embedding tied, plus a bias;
- dropout on the embeddings and on each layer's attention and MLP outputs,
  none on the attention probabilities;
- the loss averages every position (the program's loss has no ignore
  index);
- weight decay multiplied by the learning rate (torch's and optax's AdamW).

Dropout: flax's rule, keep with probability ``1 - rate`` and scale by
``1 / (1 - rate)``. The masks are drawn as the model file documents: site
``i`` of a forward with seed ``r`` draws ``torch.rand`` over the site's
``[B, S, H]`` activation from a ``torch.Generator`` on the device seeded
with ``fold_in(r, i)`` (the embeddings site 0, layer ``i`` site ``i + 1``,
whose attention output takes ``fold_in(., 0)`` and MLP output
``fold_in(., 1)``); step ``t`` of a run with seed ``s`` uses
``fold_in(s, t)``, and data-parallel rank ``k > 0`` ``fold_in(., k)``. The
reference must run on the device type the program ran on for the masks to
be the same.

``precision="fp8"`` is the control: every matrix product's operands are
rounded to float8 (e4m3, scaled per tensor) in the forward and its incoming
gradient to float8 (e5m2, scaled per tensor) in the backward, the rest in
float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data`` (the rule the model
    file documents for its dropout seeds)."""
    return _splitmix64(_splitmix64(seed & _MASK64) ^ (data & _MASK64)) >> 1


def forward_seed(seed: int, step: int, rank: int) -> int:
    """The dropout seed of step ``step`` (from 0) on data-parallel rank
    ``rank``."""
    s = fold_in(seed, step)
    return fold_in(s, rank) if rank else s


def dropout_masks(cfg: dict, rows: int, seq: int, rng: int, device) -> dict:
    """Keep masks ``[rows, seq, hidden]`` of every dropout site of one
    forward, by site."""
    keep = 1.0 - cfg["hidden_dropout_prob"]
    shape = (rows, seq, cfg["hidden_size"])

    def draw(seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        return torch.rand(shape, generator=gen, device=device) < keep

    masks = {"embed": draw(fold_in(rng, 0))}
    for i in range(cfg["num_hidden_layers"]):
        layer = fold_in(rng, i + 1)
        masks[f"{i}.attn"] = draw(fold_in(layer, 0))
        masks[f"{i}.mlp"] = draw(fold_in(layer, 1))
    return masks


class _Fp8(torch.autograd.Function):
    """Round to float8 e4m3 (scaled so the largest magnitude is the
    format's largest) forward; round the gradient to e5m2 the same way."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def _round(x, fmt):
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = torch.finfo(fmt).max / amax
    return (x * scale).to(fmt).to(torch.float32) / scale


class BertFamily:
    """The reference of one configuration ``cfg`` (the configuration file's
    keys) in ``precision`` ``"float32"`` or ``"fp8"``."""

    def __init__(self, cfg: dict, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.cfg = cfg
        self.fp8 = precision == "fp8"

    def _q(self, x):
        return _Fp8.apply(x) if self.fp8 else x

    def _linear(self, x, w, b):
        return F.linear(self._q(x), self._q(w), b)

    def forward(self, w: dict, ids, masks: dict | None):
        """Float32 logits ``[B, S, V]`` of ``ids [B, S]``; ``masks`` the keep
        masks of this forward's rows (None: no dropout)."""
        cfg = self.cfg
        B, S = ids.shape
        H = cfg["num_attention_heads"]
        D = cfg["hidden_size"] // H
        eps = cfg["layer_norm_eps"]
        keep = 1.0 - cfg["hidden_dropout_prob"]

        def drop(x, site):
            return x if masks is None else torch.where(masks[site], x / keep, 0.0)

        x = w["token_embed.weight"][ids.long()] + w["pos_embed"][0, :S]
        x = drop(x, "embed")
        causal = None
        if cfg["causal"]:
            causal = torch.ones(S, S, dtype=torch.bool, device=ids.device).tril()
        for i in range(cfg["num_hidden_layers"]):
            p = f"layer_{i}."
            h = F.layer_norm(x, (x.shape[-1],), w[p + "ln_attn.weight"], w[p + "ln_attn.bias"],
                             eps)
            q, k, v = (self._linear(h, w[p + f"attention.{n}.weight"],
                                    w[p + f"attention.{n}.bias"]).view(B, S, H, D)
                       .transpose(1, 2) for n in ("query", "key", "value"))
            scores = self._q(q) @ self._q(k).transpose(-1, -2) / math.sqrt(D)
            if causal is not None:
                scores = scores.masked_fill(~causal, float("-inf"))
            att = self._q(torch.softmax(scores, dim=-1)) @ self._q(v)
            att = att.transpose(1, 2).reshape(B, S, H * D)
            y = self._linear(att, w[p + "attention.out.weight"], w[p + "attention.out.bias"])
            x = x + drop(y, f"{i}.attn")
            h = F.layer_norm(x, (x.shape[-1],), w[p + "ln_mlp.weight"], w[p + "ln_mlp.bias"],
                             eps)
            y = F.gelu(self._linear(h, w[p + "mlp_in.weight"], w[p + "mlp_in.bias"]),
                       approximate="tanh")
            y = self._linear(y, w[p + "mlp_out.weight"], w[p + "mlp_out.bias"])
            x = x + drop(y, f"{i}.mlp")
        x = F.layer_norm(x, (x.shape[-1],), w["ln_final.weight"], w["ln_final.bias"], eps)
        return self._linear(x, w["token_embed.weight"], w["mlm_bias"])

    def chunk_rows(self, seq: int) -> int:
        """Rows a block of the forward and backward takes: the block's
        logits within about 1 GB."""
        per_row = seq * self.cfg["vocab_size"] * 4
        return max(1, 2 ** int(math.log2(max(1, 1e9 // per_row))))

    def train(self, weights: dict, steps: list, seed: int, opt: dict,
              rows_of=None) -> dict:
        """Run ``len(steps)`` AdamW steps from ``weights`` (float32, on the
        device; not changed). ``steps[t]`` is the list of every rank's
        ``(features, label)`` rows of step ``t``; the loss is the mean over
        all of them. ``rows_of(rank, n)``, when given, picks the rows of a
        rank's ``n`` that the step uses (a planted fault).

        Returns each step's loss, each leaf's gradient norm at the first
        step, and each leaf's change from ``weights`` after the last step."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        params = {k: v.detach().clone().requires_grad_() for k, v in weights.items()}
        m = {k: torch.zeros_like(v) for k, v in params.items()}
        s = {k: torch.zeros_like(v) for k, v in params.items()}
        lr, wd, eps = opt["learning_rate"], opt["weight_decay"], opt["eps"]
        b1, b2 = opt["betas"]
        losses, grad_norms = [], None
        for t, ranks in enumerate(steps):
            picked = []
            for rank, (ids, labels) in enumerate(ranks):
                idx = torch.arange(ids.shape[0], device=ids.device)
                if rows_of is not None:
                    idx = rows_of(rank, ids.shape[0]).to(ids.device)
                if idx.numel():
                    picked.append((rank, ids, labels, idx))
            tokens = sum(idx.numel() * ids.shape[1] for _, ids, _, idx in picked)
            total = 0.0
            for rank, ids, labels, idx in picked:
                B, S = ids.shape
                masks = None
                if self.cfg["hidden_dropout_prob"] > 0:
                    masks = dropout_masks(self.cfg, B, S, forward_seed(seed, t, rank),
                                          ids.device)
                block = self.chunk_rows(S)
                for lo in range(0, idx.numel(), block):
                    rows = idx[lo:lo + block]
                    part = None if masks is None else {k: v[rows] for k, v in masks.items()}
                    logits = self.forward(params, ids[rows], part)
                    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                           labels[rows].reshape(-1).long(), reduction="sum")
                    (loss / tokens).backward()
                    total += float(loss.detach())
                    del logits, loss
            losses.append(total / tokens)
            with torch.no_grad():
                if grad_norms is None:
                    grad_norms = {k: float(torch.linalg.vector_norm(p.grad.double()))
                                  for k, p in params.items()}
                step = t + 1
                for k, p in params.items():
                    g = p.grad
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    s[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    m_hat = m[k] / (1 - b1 ** step)
                    s_hat = s[k] / (1 - b2 ** step)
                    p.sub_(lr * (m_hat / (s_hat.sqrt() + eps) + wd * p))
                    p.grad = None
        with torch.no_grad():
            change = {k: float(torch.linalg.vector_norm((p - weights[k]).double()))
                      for k, p in params.items()}
        return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def make(cfg: dict, precision: str = "float32") -> BertFamily:
    """The reference of ``cfg`` in ``precision``."""
    return BertFamily(cfg, precision)
