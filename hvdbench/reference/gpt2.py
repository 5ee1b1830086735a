"""GPT-2 small in plain float32 PyTorch, with the departures the
configuration lists: learned positions, pre-LN, tanh GELU, no q/k/v/out
biases, LayerNorm eps from the file, an untied LM head.

The weights are a dict of the harness's names (``block_{i}.attention.query.kernel``,
kernels ``[in, out]``); the loss is the mean next-token cross entropy over
every row of the batch, summed block of rows by block of rows, so that the
whole batch of every rank fits beside nothing else on one card.
"""

from __future__ import annotations

import math

import torch


def _layer_norm(x, w, name: str, eps: float):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w[name + ".scale"] + w[name + ".bias"]


def _gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def forward(w, tokens, config: dict, prods):
    """Logits ``[B, T, vocab]`` of ``tokens`` ``[B, T]``."""
    B, T = tokens.shape
    H, eps = config["n_head"], config["as_run"]["layer_norm_epsilon"]
    x = w["embeddings.embedding"][tokens] + w["pos_embeddings.embedding"][:T][None]
    C = x.shape[-1]
    D = C // H
    causal = torch.ones(T, T, dtype=torch.bool, device=tokens.device).tril()
    for i in range(config["n_layer"]):
        b = f"block_{i}."
        h = _layer_norm(x, w, b + "ln_1", eps)
        q, k, v = (prods.mm(h, w[b + f"attention.{n}.kernel"]).view(B, T, H, D).transpose(1, 2)
                   for n in ("query", "key", "value"))
        s = prods.mm(q, k.transpose(-1, -2)) * D ** -0.5
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        a = prods.mm(p, v).transpose(1, 2).reshape(B, T, C)
        x = x + prods.mm(a, w[b + "attention.out.kernel"])
        h = _layer_norm(x, w, b + "ln_2", eps)
        u = _gelu_tanh(prods.mm(h, w[b + "mlp.up.kernel"]) + w[b + "mlp.up.bias"])
        x = x + prods.mm(u, w[b + "mlp.down.kernel"]) + w[b + "mlp.down.bias"]
    x = _layer_norm(x, w, "ln_f", eps)
    return prods.mm(x, w["lm_head.kernel"], wide=True)


def loss_and_backward(params, buffers, batch, config: dict, prods, block_rows: int = 2) -> float:
    """The batch's mean cross entropy; its gradient accumulated into the
    parameters, ``block_rows`` rows at a time."""
    tokens, labels = batch
    count = labels.numel()
    total = 0.0
    for r in range(0, tokens.shape[0], block_rows):
        logits = forward(params, tokens[r:r + block_rows], config, prods)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, labels[r:r + block_rows, :, None]).sum() / count
        nll.backward()
        total += float(nll.detach())
    return total
