"""The references against the port at tiny widths on the CPU, both in
float32: the same architecture, so the same logits and gradients to
round-off. The CPU tests may import the program; the references never do."""

import ast
import os

import pytest
import torch
import torch.nn.functional as F

from hvdbench import common
from hvdbench.reference import gpt2 as ref_gpt2
from hvdbench.reference import lowp
from hvdbench.reference import resnet as ref_resnet
from hvdbench.weights import draw, write_into

from .conftest import smoke_cell


def _drawn(cell, seed=7):
    spec = common.family(cell["config"]).leaves(cell["config"])
    w = draw(spec, seed, "cpu")
    buffers = {n for n, _, _, role in spec if role == "buffer"}
    return w, buffers


def test_gpt2_reference_matches_the_port_in_float32():
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss

    cell = smoke_cell("gpt2s.graph.1")
    cfg = cell["config"]
    w, _ = _drawn(cell)
    model = TransformerLM(cfg["vocab_size"], cfg["n_embd"], cfg["n_head"], cfg["n_layer"],
                          max_len=cfg["n_positions"], dtype=torch.float32, device="cpu")
    write_into(dict(model.named_parameters()), w)
    tokens, labels = common.family(cfg).make_batch(cfg, cell["traffic"], 7, "cpu", rank=0)
    lowp.set_fp32_math()
    want = ref_gpt2.forward(w, tokens, cfg, lowp.Products())
    got = model(tokens)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    lm_loss(got, labels).backward()
    params = {k: v.clone().requires_grad_() for k, v in w.items()}
    ref_gpt2.loss_and_backward(params, {}, (tokens, labels), cfg, lowp.Products())
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.grad, params[name].grad, rtol=1e-3, atol=1e-6)


def test_resnet_reference_matches_the_port_in_float32():
    from horovod_tpu_torch.models.resnet import BottleneckBlock, ResNet

    cell = smoke_cell("resnet50.graph.1")
    cfg = cell["config"]
    w, buffers = _drawn(cell)
    model = ResNet(cfg["layers"], num_classes=cfg["num_classes"], num_filters=cfg["width"],
                   dtype=torch.float32, block=BottleneckBlock, device="cpu")
    write_into({**dict(model.named_parameters()), **dict(model.named_buffers())}, w)
    images, labels = common.family(cfg).make_batch(cfg, cell["traffic"], 7, "cpu", rank=0)
    F.cross_entropy(model(images), labels).backward()
    params = {k: v.clone().requires_grad_() for k, v in w.items() if k not in buffers}
    bufs = {k: w[k].clone() for k in buffers}
    ref_resnet.loss_and_backward(params, bufs, (images, labels), cfg, lowp.Products())
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.grad, params[name].grad, rtol=1e-3, atol=1e-6)
    for name, b in model.named_buffers():
        torch.testing.assert_close(b, bufs[name], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("module", sorted(os.listdir(os.path.join(common.HERE, "reference"))))
def test_the_references_import_nothing_of_the_program(module):
    if not module.endswith(".py"):
        return
    with open(os.path.join(common.HERE, "reference", module)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        for n in names:
            assert n.split(".")[0] not in ("horovod_tpu_torch", "jax", "horovod_tpu"), n
