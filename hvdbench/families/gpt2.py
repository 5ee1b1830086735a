"""GPT-2 through the port's ``models/transformer.TransformerLM``.

The leaves carry the program's parameter names. Weights follow GPT-2's
initialisation: normal 0.02 (positions 0.01), the two residual projections
0.02 / sqrt(2 · n_layer), biases 0, LayerNorm scales 1. A row is
``seq_len + 1`` token ids drawn uniformly over the vocabulary: the first
``seq_len`` are the input, the last ``seq_len`` the labels.
"""

from __future__ import annotations

import math

import torch

from ..common import derived_seed

ITEM = "token"


def leaves(config: dict):
    d, V, L = config["n_embd"], config["vocab_size"], config["n_layer"]
    f = config.get("n_inner") or 4 * d
    std = config["initializer_range"]
    proj = std / math.sqrt(2 * L)
    one, zero = ("const", 1.0), ("const", 0.0)
    out = [("embeddings.embedding", (V, d), ("normal", std), "param"),
           ("pos_embeddings.embedding", (config["n_positions"], d), ("normal", 0.01), "param")]
    for i in range(L):
        b = f"block_{i}."
        out += [(b + "ln_1.scale", (d,), one, "param"), (b + "ln_1.bias", (d,), zero, "param")]
        out += [(b + f"attention.{n}.kernel", (d, d), ("normal", std), "param")
                for n in ("query", "key", "value")]
        out += [(b + "attention.out.kernel", (d, d), ("normal", proj), "param"),
                (b + "ln_2.scale", (d,), one, "param"), (b + "ln_2.bias", (d,), zero, "param"),
                (b + "mlp.up.kernel", (d, f), ("normal", std), "param"),
                (b + "mlp.up.bias", (f,), zero, "param"),
                (b + "mlp.down.kernel", (f, d), ("normal", proj), "param"),
                (b + "mlp.down.bias", (d,), zero, "param")]
    out += [("ln_f.scale", (d,), one, "param"), ("ln_f.bias", (d,), zero, "param"),
            ("lm_head.kernel", (d, V), ("normal", std), "param")]
    return out


def items_per_row(config: dict, traffic: dict) -> int:
    """Tokens a row trains."""
    return int(traffic["seq_len"])


def make_batch(config: dict, traffic: dict, seed: int, device, rank=None, world: int = 1):
    """(tokens, labels) of rank ``rank``'s rows, or of every rank's rows
    with ``rank=None``; the same rows on every device kind for a seed and
    device."""
    B, T = int(traffic["batch_per_card"]), int(traffic["seq_len"])
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, 1))
    ids = torch.randint(0, config["vocab_size"], (world * B, T + 1), generator=gen,
                        device=device)
    if rank is not None:
        ids = ids[rank * B:(rank + 1) * B]
    return ids[:, :-1].contiguous(), ids[:, 1:].contiguous()


def build_program(config: dict, device):
    """The program's model, its parameters not yet written."""
    from horovod_tpu_torch.models.transformer import TransformerLM

    if config["compute_dtype"] != "bfloat16" or config["as_run"]["layer_norm_epsilon"] != 1e-6:
        raise ValueError("TransformerLM computes in bfloat16 with LayerNorm eps 1e-6")
    model = TransformerLM(config["vocab_size"], config["n_embd"], config["n_head"],
                          config["n_layer"], max_len=config["n_positions"],
                          dtype=torch.bfloat16, device="meta")
    return model.to_empty(device=device)


def program_loss(model, batch):
    from horovod_tpu_torch.models.transformer import lm_loss

    return lm_loss(model(batch[0]), batch[1])


def matmul_params(config: dict) -> int:
    """Parameters that enter a product: the blocks' kernels and the LM head
    (not the embedding tables, which are looked up, nor biases or norms)."""
    d, L, V = config["n_embd"], config["n_layer"], config["vocab_size"]
    f = config.get("n_inner") or 4 * d
    return L * (4 * d * d + 2 * d * f) + d * V


def attention_flops_per_token(config: dict, seq_len: int, causal: bool = True) -> int:
    """The forward's two products over the keys a token sees, QKᵀ and PV:
    4 · T · d a layer, halved when causal."""
    f = 4 * seq_len * config["n_embd"] * config["n_layer"]
    return f // 2 if causal else f


def train_flops_per_item(config: dict, traffic: dict) -> int:
    """Model FLOPs to train one token: 3 × the forward's (the backward
    twice the forward), 2 a product's parameter and the causal attention."""
    return 3 * (2 * matmul_params(config)
                + attention_flops_per_token(config, int(traffic["seq_len"])))


def attention_shape(config: dict, traffic: dict):
    """(layers, B, T, H, D) of the causal attention on one card."""
    H = config["n_head"]
    return (config["n_layer"], int(traffic["batch_per_card"]), int(traffic["seq_len"]), H,
            config["n_embd"] // H)
