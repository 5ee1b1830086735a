"""The port's streamed (overlap) reduction against the JAX package's.

- The group plan: ``plan_layer_groups`` over the GPT tree's top-level
  children, with each group's leaves in the order the JAX package's
  registered subtree ``{str(i): children[i]}`` flattens, equal to JAX's at
  three threshold/first-bucket settings (a 12-layer tree, so that "10"
  sorts before "2").
- Overlap is post hoc, bitwise, inside the port at 2 gloo ranks (at 2
  ranks every element's sum has one order), and the hooks launch every
  group inside every backward.
- Three steps against JAX's ``make_train_step(overlap=True)`` at the plain
  step's tolerances (tests/test_torch_train.py: losses rtol 1e-5, the
  parameters by ``assert_params_close``).
- ``backward_passes_per_step=2``: only the last backward launches.
"""

import numpy as np
import pytest
import torch

import jax

from horovod_tpu.ops import fusion as jfusion
from horovod_tpu.parallel.rules import named_tree_paths

import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import fusion

from torch_port_harness import (GPT_FIRST_BUCKET, GPT_THRESHOLD, gpt_setup, run_jax_variant,
                                run_port_variants)

N = 2
KW = dict(fusion_threshold_bytes=GPT_THRESHOLD, first_bucket_bytes=GPT_FIRST_BUCKET)


@pytest.fixture(scope="module")
def setup():
    return gpt_setup()


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    variants = {"posthoc": {"kwargs": {"fusion_threshold_bytes": GPT_THRESHOLD}},
                "overlap": {"kwargs": dict(KW, overlap=True)}}
    return run_port_variants(tmp_path_factory.mktemp("overlap"), variants, N, setup)


@pytest.mark.parametrize("threshold,first", [(64 << 20, 1 << 20), (1 << 12, 1 << 10),
                                             (1 << 14, 1)])
def test_group_plan_matches_jax_on_the_gpt_tree(threshold, first):
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as ref
    from horovod_tpu_torch.models.transformer import TransformerLM

    dims = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=12, max_len=16)
    params = ref.TransformerLM(**dims, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    children, _, groups = jfusion.zero1_group_layout(params, threshold, first)
    # JAX's groups as full paths: each registered subtree {str(i): child}
    # flattened in JAX's order, its key replaced by the child's name.
    keys = sorted(params)
    want = []
    for g in groups:
        paths = [p for p, _ in named_tree_paths({str(i): children[i] for i in g})]
        want.append([keys[int(p.split("/", 1)[0])] + "/" + p.split("/", 1)[1] for p in paths])

    model = TransformerLM(**dims, dtype=torch.float32, device="cpu")
    names = {id(p): n.replace(".", "/") for n, p in model.named_parameters()}
    tree = fusion.named_tree(list(model.named_parameters()))
    got = [[names[id(p)] for p in g] for g in fusion.stream_groups(tree, threshold, first)]
    assert got == want
    sizes = [fusion._tree_bytes(c) for c in fusion._top_level_children(tree)]
    assert fusion.plan_layer_groups(sizes, threshold, first) == groups
    assert fusion.layer_group_bytes(sizes, threshold, first) == \
        jfusion.layer_group_bytes(sizes, threshold, first)


def test_overlap_is_posthoc_bitwise_at_two_ranks(runs):
    for r in range(N):
        ov, ph = runs["overlap"][r], runs["posthoc"][r]
        assert ov["losses"] == ph["losses"]
        for key, a in ph["arrays"].items():
            np.testing.assert_array_equal(ov["arrays"][key], a, err_msg=key)


def test_hooks_launch_every_group_inside_the_backward(runs):
    """Every group launches from a hook. In the first step the groups go in
    the plan's order, whose first group (the position embeddings, sorted
    last) completes near the backward's end, holding the others back; from
    the second step on they go in the order the first step completed them,
    so every group but the last launches while another's gradients are
    still to come."""
    for r in range(N):
        groups = runs["overlap"][r]["groups"]
        assert all(launched == total > 1 for launched, _, total in groups), groups
        assert groups[0][1] < groups[0][2] - 1, groups
        assert all(early == total - 1 for _, early, total in groups[1:]), groups
        assert runs["posthoc"][r]["groups"] == [[0, 0, 0]] * len(groups)


def test_overlap_matches_jax_overlap_step(runs, setup):
    from torch_port_harness import assert_params_close

    losses, final, _ = run_jax_variant(setup, N, overlap=True, **KW)
    for r in range(N):
        np.testing.assert_allclose(runs["overlap"][r]["losses"], losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    assert_params_close(runs["overlap"][0]["arrays"], final)
    for key, a in runs["overlap"][0]["arrays"].items():
        np.testing.assert_array_equal(runs["overlap"][1]["arrays"][key], a, err_msg=key)


@pytest.fixture
def one_rank(tmp_path):
    hvd.init(device="cpu", init_method=f"file://{tmp_path}/store")
    try:
        yield hvd
    finally:
        hvd.shutdown()


def test_only_the_last_backward_pass_launches(one_rank):
    """With ``backward_passes_per_step=2`` the hooks count a parameter on
    its second backward only; the reduced gradient is the mean of both."""
    torch.manual_seed(0)
    layers = {"a": torch.nn.Parameter(torch.randn(3, 3)), "b": torch.nn.Parameter(torch.randn(3))}
    opt = hvd.DistributedOptimizer(torch.optim.SGD(list(layers.values()), lr=0.0),
                                   named_parameters=list(layers.items()), overlap=True,
                                   backward_passes_per_step=2, first_bucket_bytes=1,
                                   fusion_threshold_bytes=1)
    x = torch.randn(4, 3)
    stream = opt._stream
    for i, half in enumerate((x[:2], x[2:])):
        ((half @ layers["a"]) + layers["b"]).pow(2).mean().backward()
        assert stream.launched_in_backward == (0 if i == 0 else len(stream.groups))
    opt.synchronize()
    full = torch.autograd.grad(((x[:2] @ layers["a"]) + layers["b"]).pow(2).mean()
                               + ((x[2:] @ layers["a"]) + layers["b"]).pow(2).mean(),
                               list(layers.values()))
    for p, g in zip(layers.values(), full):
        torch.testing.assert_close(p.grad, g / 2)
    launched, _, total = opt.streamed_groups
    assert launched == total == 2


def test_a_parameter_without_gradient_leaves_its_group_to_synchronize(one_rank):
    """A group the backward leaves incomplete is reduced by synchronize,
    its missing gradient as zeros (the JAX tree always has one)."""
    a, b = torch.nn.Parameter(torch.ones(2)), torch.nn.Parameter(torch.ones(2))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([a, b], lr=0.5),
                                   named_parameters=[("a", a), ("b", b)], overlap=True,
                                   first_bucket_bytes=1, fusion_threshold_bytes=1)
    (a * 3).sum().backward()
    opt.step()
    # b's group reduces first in the plan, so a's complete group waited
    # behind it: both went at synchronize, in plan order.
    assert opt.streamed_groups == (0, 0, 2)
    torch.testing.assert_close(a.detach(), torch.full((2,), -0.5))
    torch.testing.assert_close(b.detach(), torch.ones(2))
