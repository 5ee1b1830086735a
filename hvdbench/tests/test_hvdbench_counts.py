"""The benchmark's own counts: FLOPs against PyTorch's FlopCounterMode on
the plain reference at small sizes, and attention's work and bytes."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from hvdbench import common, peaks
from hvdbench.families import gpt2, resnet
from hvdbench.reference import gpt2 as ref_gpt2
from hvdbench.reference import lowp
from hvdbench.reference import resnet as ref_resnet
from hvdbench.weights import draw

from .conftest import smoke_cell


def _params(cell, seed=3):
    spec = common.family(cell["config"]).leaves(cell["config"])
    w = draw(spec, seed, "cpu")
    buffers = [n for n, _, _, role in spec if role == "buffer"]
    params = {k: v.requires_grad_() for k, v in w.items() if k not in buffers}
    return params, {k: w[k] for k in buffers}


def test_gpt2_flops_match_the_flop_counter():
    cell = smoke_cell("gpt2s.graph.1")
    cfg, traffic = cell["config"], cell["traffic"]
    params, _ = _params(cell)
    tokens, labels = gpt2.make_batch(cfg, traffic, 5, "cpu", rank=0)
    n_tokens = tokens.numel()
    T = traffic["seq_len"]
    # The reference computes attention dense, under a mask: count it whole.
    forward = 2 * gpt2.matmul_params(cfg) + gpt2.attention_flops_per_token(cfg, T, causal=False)
    with FlopCounterMode(display=False) as counter:
        logits = ref_gpt2.forward(params, tokens, cfg, lowp.Products())
    assert counter.get_total_flops() == forward * n_tokens
    with FlopCounterMode(display=False) as counter:
        ref_gpt2.loss_and_backward(params, {}, (tokens, labels), cfg, lowp.Products(),
                                   block_rows=tokens.shape[0])
    assert counter.get_total_flops() == 3 * forward * n_tokens
    causal = gpt2.train_flops_per_item(cfg, traffic)
    assert causal == 3 * (2 * gpt2.matmul_params(cfg)
                          + gpt2.attention_flops_per_token(cfg, T, causal=False) // 2)
    assert logits.shape[-1] == cfg["vocab_size"]


def test_gpt2_small_counts_at_published_widths():
    cfg = common.cell("gpt2s.graph.1")["config"]
    assert gpt2.matmul_params(cfg) == 12 * (4 * 768 ** 2 + 2 * 768 * 3072) + 768 * 50257
    assert gpt2.train_flops_per_item(cfg, {"seq_len": 1024}) == 797815296


def test_resnet_flops_match_the_flop_counter():
    cell = smoke_cell("resnet50.graph.1")
    cfg, traffic = cell["config"], cell["traffic"]
    params, buffers = _params(cell)
    images, _ = resnet.make_batch(cfg, traffic, 5, "cpu", rank=0)
    with FlopCounterMode(display=False) as counter:
        ref_resnet.forward(params, buffers, images, cfg, lowp.Products())
    assert counter.get_total_flops() == 2 * resnet.macs_per_image(cfg) * images.shape[0]
    assert resnet.train_flops_per_item(cfg, traffic) == 6 * resnet.macs_per_image(cfg)


def test_resnet50_macs_at_published_sizes():
    cfg = common.cell("resnet50.graph.1")["config"]
    assert resnet.macs_per_image(cfg) == 4089184256


def test_attention_work_and_its_least_time():
    flash = common.load_file("metrics", "flash.roofline_pct")
    (ff, fb), (bf, bb) = flash.attention_work(2, 128, 4, 64)
    product = 2 * 2 * 4 * 128 * 128 * 64 // 2
    tensor = 2 * 128 * 4 * 64 * 2
    assert (ff, bf) == (2 * product, 5 * product)
    assert (fb, bb) == (4 * tensor + 2 * 4 * 128 * 4, 8 * tensor + 2 * 4 * 128 * 4)
    least = flash.least_seconds(2, 128, 4, 64)
    assert least == pytest.approx(max(ff / peaks.BF16_FLOPS, fb / peaks.HBM_BYTES)
                                  + max(bf / peaks.BF16_FLOPS, bb / peaks.HBM_BYTES))


def test_flash_roofline_reads_the_kernels_its_patterns_match():
    flash = common.load_file("metrics", "flash.roofline_pct")
    cfg = common.cell("gpt2s.graph.1")["config"]
    traffic = common.cell("gpt2s.graph.1")["traffic"]
    bound = flash.least_seconds(12, 1024, 12, 64) * 12
    ops = {"void flash_fwd_mma_kernel<64, 2, 64, 0>(...)": 4 * bound,
           "void flash_bwd_dq_mma_kernel<64, 0>(...)": 3 * bound,
           "void flash_bwd_dkdv_mma_kernel<64, 32, 0>(...)": 3 * bound,
           "sm90_xmma_gemm_bf16bf16_bf16f32": 50 * bound}
    ctx = {"family": gpt2, "config": cfg, "traffic": traffic,
           "ranks": [{"trace": {"ops": {k: 2 * v for k, v in ops.items()}, "steps": 2}}]}
    assert flash.read(ctx) == pytest.approx(10.0)
    ctx["ranks"] = [{"trace": {"ops": {"gemm": 1.0}, "steps": 1}}]
    assert flash.read(ctx) is None
    ctx["ranks"] = [{}]
    assert flash.read(ctx) is None


def test_the_control_rounds_as_its_formats_do():
    x = torch.tensor([1.0, 1.0 + 2 ** -12, 3.0, -448.0])
    assert torch.equal(lowp.tf32_round(x), torch.tensor([1.0, 1.0, 3.0, -448.0]))
    y = lowp.fp8_round(torch.tensor([448.0, 17.0, 0.0]), torch.float8_e4m3fn)
    assert torch.equal(y, torch.tensor([448.0, 16.0, 0.0]))
