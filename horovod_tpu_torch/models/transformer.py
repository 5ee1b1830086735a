"""Decoder-only Transformer LM: one forward, in two forms of the parameters.

The counterpart of ``horovod_tpu/models/transformer.py``:

- :class:`TransformerLM`, an ``nn.Module`` that holds the parameters under
  the flax names (``embeddings``, ``pos_embeddings``, ``block_{i}/ln_1``,
  ``block_{i}/attention/{query,key,value,out}``, ``block_{i}/ln_2``,
  ``block_{i}/mlp/{up,down}``, ``ln_f``, ``lm_head``), so every parameter
  name maps one to one onto the flax tree (``.`` for ``/``);
- :func:`tp_apply`, the forward over the same tree as a nested dict of
  tensors, with :func:`lm_loss` and :func:`make_gpt_loss_fn`.

Both forms run the same blocks (:func:`_forward`) and differ where their
JAX counterparts differ, in the input embedding: the flax module looks each
table up through ``nn.Embed(dtype=dtype)`` and adds the two lookups in
``dtype``; the JAX ``tp_apply`` adds in f32 and casts once. The module
also takes the flax module's ``attn_fn`` (ring or Ulysses attention for
sequence parallelism) and ``remat`` (each block recomputed in the backward,
``nn.remat(Block)``).

The forward computes in ``dtype`` (bf16 by default) with an f32
``lm_head``, and attention goes through the flash kernels
(``ops/flash_attention.py``). Dense kernels keep the flax layout ``[in, out]`` and compute ``x @ w``;
layer norm uses eps 1e-6 with f32 statistics; gelu is the tanh form, as
``jax.nn.gelu`` is by default.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..common.basics import resolve_device
from ..ops.flash_attention import flash_attention_bthd
from ..utils.convert import param_tree
from .layers import Dense


def _layer_norm(x, p, dtype):
    """nn.LayerNorm parity (eps 1e-6, f32 statistics) on a raw
    {"scale","bias"} param dict."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + 1e-6)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(dtype)


class Embed(nn.Module):
    """flax ``nn.Embed``'s parameter: an f32 table."""

    def __init__(self, num_embeddings: int, features: int, *, device=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # flax's default embedding init: normal, std 1/sqrt(features).
        with torch.no_grad():
            self.embedding.normal_(0.0, self.embedding.shape[1] ** -0.5,
                                   generator=generator)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``'s parameters: scale and bias."""

    def __init__(self, features: int, *, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))


def _block(d_model: int, mlp_ratio: int = 4, *, device) -> nn.ModuleDict:
    """The parameters of one ``block_{i}``, under the flax names."""
    return nn.ModuleDict({
        "ln_1": LayerNorm(d_model, device=device),
        "attention": nn.ModuleDict({
            name: Dense(d_model, d_model, use_bias=False, device=device)
            for name in ("query", "key", "value", "out")
        }),
        "ln_2": LayerNorm(d_model, device=device),
        "mlp": nn.ModuleDict({
            "up": Dense(d_model, mlp_ratio * d_model, device=device),
            "down": Dense(mlp_ratio * d_model, d_model, device=device),
        }),
    })


class TransformerLM(nn.Module):
    """GPT decoder. ``forward(tokens [B, T], positions=None)`` returns f32
    logits ``[B, T, vocab]``. Weights are drawn from ``seed`` with flax's
    default initialisers; ``device=None`` means the card.

    ``attn_fn(q, k, v)`` takes and returns ``[B, T, H, D]``; None means
    causal flash attention. ``remat=True`` recomputes each block's
    activations in the backward instead of keeping them."""

    def __init__(self, vocab_size: int, d_model: int = 256, n_heads: int = 8,
                 n_layers: int = 4, max_len: int = 2048, *,
                 dtype=torch.bfloat16, device=None, seed: int = 0,
                 attn_fn: Optional[Callable] = None, remat: bool = False):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} not divisible by n_heads {n_heads}")
        device = resolve_device(device)
        self.n_heads = n_heads
        self.dtype = dtype
        self.attn_fn = attn_fn
        self.remat = remat
        self.embeddings = Embed(vocab_size, d_model, device=device)
        self.pos_embeddings = Embed(max_len, d_model, device=device)
        for i in range(n_layers):
            self.add_module(f"block_{i}", _block(d_model, device=device))
        self.ln_f = LayerNorm(d_model, device=device)
        self.lm_head = Dense(d_model, vocab_size, use_bias=False, device=device)
        if device.type != "meta":
            generator = torch.Generator(device=device).manual_seed(seed)
            for module in self.modules():
                if isinstance(module, (Dense, Embed)):
                    module.reset_parameters(generator)

    def forward(self, tokens, positions=None):
        B, T = tokens.shape
        if positions is None:
            positions = torch.arange(T, device=tokens.device).expand(B, T)
        # nn.Embed(dtype=dtype): each lookup in dtype, added in dtype.
        x = (F.embedding(tokens, self.embeddings.embedding).to(self.dtype)
             + F.embedding(positions, self.pos_embeddings.embedding).to(self.dtype))
        attn = self.attn_fn or partial(flash_attention_bthd, causal=True)
        return _forward(param_tree(self), x, n_heads=self.n_heads, dtype=self.dtype,
                        attn=attn, remat=self.remat)


# --- the forward, over a nested dict of parameters --------------------------


def transformer_n_layers(params) -> int:
    return sum(1 for k in params if str(k).startswith("block_"))


def _dense_row(y, w, b=None):
    out = y @ w
    return out if b is None else out + b


def _check_heads(width: int, head_dim: int) -> int:
    if width % head_dim:
        raise ValueError(
            f"local q/k/v width {width} is not whole heads of dim {head_dim} — "
            f"n_heads must divide by the model-axis size"
        )
    return width // head_dim


def _apply_block(bp, x, *, head_dim: int, dtype, attn: Callable,
                 f: Callable = lambda y: y, row: Callable = _dense_row):
    """One block. ``f`` marks the replicated input of the column-parallel
    products and ``row`` is the row-parallel product (identity and ``y @ w
    + b`` on whole weights; Megatron's conjugate and ``row_parallel`` on
    shards)."""
    B, T, _ = x.shape
    h = f(_layer_norm(x, bp["ln_1"], dtype))
    att = bp["attention"]
    q = h @ att["query"]["kernel"].to(dtype)
    k = h @ att["key"]["kernel"].to(dtype)
    v = h @ att["value"]["kernel"].to(dtype)
    hl = _check_heads(q.shape[-1], head_dim)
    shape = (B, T, hl, head_dim)
    a = attn(q.reshape(shape), k.reshape(shape), v.reshape(shape))
    x = x + row(a.reshape(B, T, hl * head_dim), att["out"]["kernel"].to(dtype))
    h = f(_layer_norm(x, bp["ln_2"], dtype))
    mlp = bp["mlp"]
    u = F.gelu(h @ mlp["up"]["kernel"].to(dtype) + mlp["up"]["bias"].to(dtype),
               approximate="tanh")
    return x + row(u, mlp["down"]["kernel"].to(dtype), mlp["down"]["bias"].to(dtype))


def _head(params, x, dtype):
    """``ln_f`` and the f32 ``lm_head``."""
    x = _layer_norm(x, params["ln_f"], dtype)
    return x.float() @ params["lm_head"]["kernel"].float()


def _forward(params, x, *, n_heads: int, dtype, attn: Callable, remat: bool = False,
             f: Callable = lambda y: y, row: Callable = _dense_row):
    """The blocks, ``ln_f`` and the f32 ``lm_head`` over the embedded
    input ``x`` [B, T, C]."""
    C = x.shape[-1]
    if C % n_heads:
        raise ValueError(f"d_model {C} not divisible by n_heads {n_heads}")
    for i in range(transformer_n_layers(params)):
        block = partial(_apply_block, params[f"block_{i}"], head_dim=C // n_heads,
                        dtype=dtype, attn=attn, f=f, row=row)
        x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
    return _head(params, x, dtype)


def tp_apply(
    params: Dict[str, Any],
    tokens: torch.Tensor,
    *,
    n_heads: int,
    model_axis=None,
    positions: Optional[torch.Tensor] = None,
    dtype=torch.bfloat16,
    causal: bool = True,
    tp_overlap: Optional[bool] = None,
) -> torch.Tensor:
    """Functional forward of the :class:`TransformerLM` parameter tree (a
    nested dict of tensors, flax names) on whole weights or on this rank's
    tensor-parallel shards.

    ``n_heads`` is the GLOBAL head count (the head dim derives from the
    replicated ``d_model``). ``model_axis`` is None (whole weights: the
    dense single-card form), the model axis's process group, or an axis
    name of the mesh in scope (``parallel.tp.mesh_scope``, which the
    composed ``make_train_step`` opens). With a model axis each rank runs
    its local H/n heads and F/n MLP columns through ``parallel/tp.py``:
    q/k/v and the MLP up-projection column-parallel, attention-out and
    MLP-down row-parallel (one all-reduce each, the MLP-down bias
    scattered inside it).

    ``tp_overlap`` selects the fused collective-matmul path (kernels B3 and
    B4): the residual stream rides token-sharded between blocks, q/k/v ride
    one all-gather-matmul, attention-out and MLP-down become
    matmul-reduce-scatters. ``None`` defers to
    ``parallel.tp.tp_overlap_enabled()``. With one rank on the axis the
    classic path runs, as in the reference.

    The embedding lookups are added in f32 and cast once, as the JAX
    ``tp_apply`` does."""
    B, T = tokens.shape
    if positions is None:
        positions = torch.arange(T, device=tokens.device).expand(B, T)
    emb = params["embeddings"]["embedding"]
    pos = params["pos_embeddings"]["embedding"]
    x = (F.embedding(tokens, emb) + F.embedding(positions, pos)).to(dtype)
    attn = partial(flash_attention_bthd, causal=causal)
    if model_axis is None:
        return _forward(params, x, n_heads=n_heads, dtype=dtype, attn=attn)

    from ..parallel import tp

    C = emb.shape[-1]
    if C % n_heads:
        raise ValueError(f"d_model {C} not divisible by n_heads {n_heads}")
    group = tp.resolve_group(model_axis)
    n = tp.axis_size(group)
    if tp.tp_overlap_enabled(tp_overlap) and n > 1:
        if T % n:
            raise ValueError(
                f"tp_overlap needs the sequence length ({T}) divisible by the "
                f"model-axis size ({n}) — the fused path token-shards the "
                f"residual stream"
            )
        return _tp_apply_fused(params, x, group=group, head_dim=C // n_heads,
                               dtype=dtype, attn=attn)
    return _forward(params, x, n_heads=n_heads, dtype=dtype, attn=attn,
                    f=partial(tp.tp_block_input, axis_name=group),
                    row=partial(tp.row_parallel, axis_name=group))


def _tp_apply_fused(params, x, *, group, head_dim: int, dtype, attn: Callable):
    """The collective-matmul forward (``_tp_apply_fused`` of the JAX
    package): token-sharded residual stream.

    Per block: LN on the token shard, q/k/v through ONE all-gather-matmul
    over the concatenated kernels, flash attention on all tokens and the
    local heads, attention-out through a matmul-reduce-scatter, LN, MLP up
    (all-gather-matmul, gelu), MLP down (matmul-reduce-scatter). Tokens
    scatter once at entry and gather once before ``ln_f``, so the lm head
    sees the classic path's replicated activation. The block layer norms'
    parameters go through ``tp_replicated_params``: on the sharded stream
    their gradients cover one token chunk per rank."""
    from ..parallel import tp

    B, T, _ = x.shape
    x = tp.tp_scatter_tokens(x, axis_name=group)            # [B, T/n, C]
    for i in range(transformer_n_layers(params)):
        bp = params[f"block_{i}"]
        h = _layer_norm(x, tp.tp_replicated_params(bp["ln_1"], axis_name=group), dtype)
        att = bp["attention"]
        wqkv = torch.cat([att[name]["kernel"].to(dtype) for name in ("query", "key", "value")],
                         dim=-1)
        qkv = tp.column_parallel_fused(h, wqkv, axis_name=group)
        q, k, v = qkv.chunk(3, dim=-1)
        hl = _check_heads(q.shape[-1], head_dim)
        shape = (B, T, hl, head_dim)
        a = attn(q.reshape(shape), k.reshape(shape), v.reshape(shape))
        x = x + tp.row_parallel_fused(a.reshape(B, T, hl * head_dim),
                                      att["out"]["kernel"].to(dtype), axis_name=group)
        h = _layer_norm(x, tp.tp_replicated_params(bp["ln_2"], axis_name=group), dtype)
        mlp = bp["mlp"]
        u = F.gelu(tp.column_parallel_fused(h, mlp["up"]["kernel"].to(dtype),
                                            mlp["up"]["bias"].to(dtype), axis_name=group),
                   approximate="tanh")
        x = x + tp.row_parallel_fused(u, mlp["down"]["kernel"].to(dtype),
                                      mlp["down"]["bias"].to(dtype), axis_name=group)
    x = tp.tp_gather_tokens(x, axis_name=group)             # [B, T, C] replicated
    return _head(params, x, dtype)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[..., None].long()).mean()


def make_gpt_loss_fn(
    n_heads: int,
    *,
    model_axis=None,
    dtype=torch.bfloat16,
    tp_overlap: Optional[bool] = None,
) -> Callable:
    """``loss_fn(params, (tokens, labels))`` over :func:`tp_apply`.
    ``model_axis`` and ``tp_overlap`` are :func:`tp_apply`'s; with the
    composed ``make_train_step(rules=...)``, ``model_axis="model"``
    resolves in the step's mesh and ``tp_overlap=None`` follows the step's
    ``tp_overlap``."""

    def loss_fn(params, batch):
        tokens, labels = batch
        logits = tp_apply(params, tokens, n_heads=n_heads, model_axis=model_axis,
                          dtype=dtype, tp_overlap=tp_overlap)
        return lm_loss(logits, labels)

    return loss_fn
