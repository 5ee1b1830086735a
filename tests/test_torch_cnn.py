"""The port's CNN zoo against the JAX package's flax models.

Each case gives the flax model and the port the same weights (the flax
init, seeded, carried over through numpy by ``load_flax_params``) and the
same NHWC inputs, and compares the f32 logits, every gradient of the mean
softmax cross-entropy and, in training, the new BatchNorm running
statistics.

Tolerances. f32: logits rtol 1e-4 / atol 1e-5, running statistics the
same, gradients rtol 1e-3 / atol 1e-4 (the two sides sum convolutions in
other orders). bf16 (the models' default compute): the reference's 5e-2
(``tests/test_flash_attention.py``) on logits and statistics. bf16
gradients at these widths are far from the f32 ones on both sides (the
reference's own bf16 gradient tree is 12-13% from its f32 one, measured
over all leaves at once), so the port's bf16 gradients are held to be no
farther from the reference's f32 gradients than 1.5 times the
reference's bf16 gradients are (measured 0.9-1.1 times). Inception V3 at random init has gradients that
f32 cannot resolve at a CPU-sized input (the port's own f32 and f64
gradients differ by up to 30% on some leaves at 75-171 px), so its case runs
both sides in float64 and holds logits and statistics to 1e-5 and each
gradient to 1e-5 of its leaf's largest magnitude (the same conditioning
leaves ~2e-6 there at float64 precision).

Dropout draws from JAX's key on one side and a ``torch.Generator`` on the
other, so train mode is held by giving both the same numpy keep mask:
``flax.linen.intercept_methods`` on ``nn.Dropout`` in JAX, the port's
``Dropout.keep_mask`` in torch.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax

from horovod_tpu.models import get_model as ref_get_model
from horovod_tpu.models import inception as ref_inception
from horovod_tpu.models import mnist_cnn as ref_mnist
from horovod_tpu.models import resnet as ref_resnet
from horovod_tpu.models import vgg as ref_vgg
from horovod_tpu.parallel.rules import named_tree_paths

from horovod_tpu_torch.models import get_model, inception, mnist_cnn, resnet, vgg
from horovod_tpu_torch.models.layers import BatchNorm, Conv, Dropout, flatten_hwc
from horovod_tpu_torch.utils.convert import (
    batch_stats_to_numpy, load_flax_params, nest, params_to_numpy,
)

F32 = dict(logits=(1e-4, 1e-5), stats=(1e-4, 1e-5), grads=(1e-3, 1e-4))
BF16 = 5e-2
BF16_GRAD_FACTOR = 1.5
F64 = 1e-5


def _flat(tree):
    return {n: np.asarray(leaf) for n, leaf in named_tree_paths(tree)}


def _variables(port):
    """The port model's weights and statistics as the flax variables tree:
    both sides then start from the same numpy values, and flax's apply
    checks every name and shape."""
    variables = {"params": nest(params_to_numpy(port))}
    stats = batch_stats_to_numpy(port)
    if stats:
        variables["batch_stats"] = nest(stats)
    return jax.tree.map(jnp.asarray, variables)


def _masks(model_port, x, seed=5):
    """One numpy keep mask (rate 0.5) per dropout layer of the port model,
    at the shape of its input, found by a forward in eval mode."""
    shapes = []
    hooks = [m.register_forward_hook(lambda m, i, o: shapes.append(tuple(i[0].shape)))
             for m in model_port.modules() if isinstance(m, Dropout)]
    model_port.eval()
    with torch.no_grad():
        model_port(x)
    for h in hooks:
        h.remove()
    rng = np.random.RandomState(seed)
    return [rng.rand(*s) >= 0.5 for s in shapes]


def _flax_run(model, variables, x, y, train, masks):
    """Logits, gradients and new batch statistics of the flax model, with
    its dropout layers applying ``masks`` in call order."""
    has_bn = "batch_stats" in variables
    calls = []

    def dropout_with_mask(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            inp = args[0]
            if not train:
                return inp
            keep = jnp.asarray(masks[len(calls)])
            calls.append(1)
            return jnp.where(keep, inp / 0.5, 0).astype(inp.dtype)
        return next_fun(*args, **kwargs)

    def loss_fn(params):
        extra = {"batch_stats": variables["batch_stats"]} if has_bn else {}
        with fnn.intercept_methods(dropout_with_mask):
            out = model.apply({"params": params, **extra}, x, train=train,
                              mutable=["batch_stats"] if has_bn and train else False)
        logits, state = out if has_bn and train else (out, {})
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
        return loss, (logits, state.get("batch_stats", {}))

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, (logits, stats)), grads = grad_fn(variables["params"])
    return np.asarray(logits, np.float64), _flat(grads), _flat(stats)


def _port_run(model, x, y, train, masks):
    model.train(train)
    for d, keep in zip([m for m in model.modules() if isinstance(m, Dropout)], masks):
        d.keep_mask = lambda inp, keep=keep: torch.from_numpy(keep).to(inp.device)
    model.zero_grad(set_to_none=True)
    logits = model(x)
    F.cross_entropy(logits, y).backward()
    grads = params_to_numpy({n.replace(".", "/"): p.grad for n, p in model.named_parameters()})
    return logits.detach().double().numpy(), grads, batch_stats_to_numpy(model)


def _global_rel(a, b):
    """|a - b| / |b| over every leaf of two gradient trees at once."""
    num = sum(float(np.sum((a[n].astype(np.float64) - b[n]) ** 2)) for n in b)
    return np.sqrt(num / sum(float(np.sum(b[n].astype(np.float64) ** 2)) for n in b))


def _check(make_ref, make_port, x_np, labels, *, train, bf16=False, dtype=torch.float32):
    """Hold the port to flax in ``dtype`` (f32 or f64) at the tolerances of
    the module docstring; with ``bf16``, then both in bf16."""
    port = make_port(dtype)
    variables = _variables(port)
    init = _flat(variables.get("batch_stats", {}))
    x, y = torch.from_numpy(x_np).to(dtype), torch.from_numpy(labels).long()
    masks = _masks(port, x)
    jx, jy = jnp.asarray(x.numpy()), jnp.asarray(labels)
    lr, gr, sr = _flax_run(make_ref(jnp.float64 if dtype == torch.float64 else jnp.float32),
                           variables, jx, jy, train, masks)
    lp, gp, sp = _port_run(port, x, y, train, masks)
    assert set(gp) == set(gr) and set(sp) == set(init)
    tol = F32 if dtype == torch.float32 else dict.fromkeys(("logits", "stats"), (F64, F64))
    np.testing.assert_allclose(lp, lr, *tol["logits"], err_msg="logits")
    for name in gr:
        if dtype == torch.float32:
            np.testing.assert_allclose(gp[name], gr[name], *tol["grads"], err_msg=name)
        else:
            err = np.abs(gp[name] - gr[name]).max() / max(np.abs(gr[name]).max(), 1e-30)
            assert err <= F64, f"{name}: {err:.2e} of its largest gradient"
    if not train:          # eval normalises with the running statistics, which stay
        for name in init:
            np.testing.assert_array_equal(sp[name], init[name], err_msg=name)
    elif init:
        assert set(sr) == set(init)
        assert any(not np.allclose(sr[n], init[n]) for n in sr), "statistics did not move"
        for name in sr:
            np.testing.assert_allclose(sp[name], sr[name], *tol["stats"], err_msg=name)
    if not bf16:
        return
    port16 = make_port(torch.bfloat16)     # the same seed: the same starting point
    l16r, g16r, s16r = _flax_run(make_ref(jnp.bfloat16), variables, jx, jy, train, masks)
    l16p, g16p, s16p = _port_run(port16, x, y, train, masks)
    np.testing.assert_allclose(l16p, l16r, rtol=BF16, atol=BF16, err_msg="bf16 logits")
    for name in s16r:
        np.testing.assert_allclose(s16p[name], s16r[name], rtol=BF16, atol=BF16, err_msg=name)
    drift_ref, drift_port = _global_rel(g16r, gr), _global_rel(g16p, gr)
    assert drift_port <= BF16_GRAD_FACTOR * drift_ref, (drift_port, drift_ref)


def _images(n, side, ch=3, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(n, side, side, ch).astype(np.float32), rng.randint(0, 10, n).astype(np.int32)


RESNET_BLOCKS = {"bottleneck": (ref_resnet.BottleneckBlock, resnet.BottleneckBlock),
                 "basic": (ref_resnet.BasicBlock, resnet.BasicBlock)}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("block", sorted(RESNET_BLOCKS))
def test_resnet_matches_flax(block, train):
    """``ResNet(stage_sizes=[1, 1], num_filters=8)`` at 32 px: the stem, a
    stride-1 and a stride-2 block (asymmetric SAME pads, the projection),
    the global mean and the head; in training also in bf16."""
    ref_block, port_block = RESNET_BLOCKS[block]
    x, y = _images(4, 32)
    _check(lambda dt: ref_resnet.ResNet(stage_sizes=[1, 1], num_filters=8, num_classes=10,
                                        dtype=dt, block=ref_block),
           lambda dt: resnet.ResNet([1, 1], 10, 8, dt, block=port_block, device="cpu", seed=1),
           x, y, train=train, bf16=train)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_vgg11_matches_flax(train):
    """Dropout in train mode through the injected masks; eval has none."""
    x, y = _images(2, 32)
    _check(lambda dt: ref_vgg.VGG11(num_classes=10, num_filters=8, dense_features=32, dtype=dt),
           lambda dt: vgg.VGG11(num_classes=10, num_filters=8, dense_features=32, dtype=dt,
                                image_size=32, device="cpu", seed=2),
           x, y, train=train, bf16=train)


def test_mnist_cnn_matches_flax():
    x, y = _images(2, 28, ch=1)
    _check(lambda dt: ref_mnist.MnistCNN(dtype=dt),
           lambda dt: mnist_cnn.MnistCNN(dtype=dt, device="cpu", seed=3), x, y, train=True,
           bf16=True)


def test_inception_v3_matches_flax_in_float64():
    """One forward and gradient in train mode at 75 px (the stem's least
    input), batch 2 (at batch 1 InceptionC's statistics see one value per
    channel and its output is its bias): every ConvBN, the three pools, the
    concatenations, the dropout (injected mask) and the head, eps 1e-3."""
    x, y = _images(2, 75)
    with jax.enable_x64(True):
        _check(lambda dt: ref_inception.InceptionV3(num_classes=10, dtype=dt),
               lambda dt: inception.InceptionV3(10, dt, device="cpu", seed=4).to(dt),
               x, y, train=True, dtype=torch.float64)


# --- the traps ---------------------------------------------------------------


def test_stride2_same_padding_is_asymmetric_and_torch_padding_1_fails():
    """A 3x3 stride-2 SAME conv over an even side pads (0, 1) in flax. The
    port's Conv matches it; torch's symmetric padding=1 gives the same
    output shape and other numbers."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    ref = fnn.Conv(6, (3, 3), (2, 2), use_bias=False, dtype=jnp.float32)
    variables = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(ref.apply(variables, jnp.asarray(x)))
    conv = Conv(4, 6, (3, 3), (2, 2), use_bias=False, dtype=torch.float32, device="cpu")
    load_flax_params(conv, _flat(variables["params"]))
    assert conv.pads(8, 8) == ((0, 1), (0, 1)) and conv.pads(7, 7) == ((1, 1), (1, 1))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = conv(xt).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, **dict(zip(("rtol", "atol"), F32["logits"])))
    naive = F.conv2d(xt, conv.kernel, stride=2, padding=1).permute(0, 2, 3, 1).detach().numpy()
    assert naive.shape == want.shape
    assert not np.allclose(naive, want, rtol=1e-2, atol=1e-2)


def test_running_variance_is_the_biased_one():
    """flax updates ``var`` with the biased batch variance, 0.9 ra + 0.1 v;
    torch's ``batch_norm`` would store the unbiased one."""
    rng = np.random.RandomState(1)
    x = (3.0 + 2.0 * rng.randn(2, 3, 3, 5)).astype(np.float32)   # n = 18 per channel
    ref = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    _, state = ref.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(5, dtype=torch.float32, device="cpu")
    bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    want = np.asarray(state["batch_stats"]["var"])
    np.testing.assert_allclose(bn.var.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(state["batch_stats"]["mean"]),
                               rtol=1e-5)
    biased = x.reshape(-1, 5).var(axis=0)
    np.testing.assert_allclose(want, 0.9 + 0.1 * biased, rtol=1e-5)
    rm, rv = torch.zeros(5), torch.ones(5)
    F.batch_norm(torch.from_numpy(x).permute(0, 3, 1, 2), rm, rv, training=True, momentum=0.1)
    assert not np.allclose(rv.numpy(), want, rtol=1e-3)


def test_flatten_is_in_hwc_order():
    """VGG and MnistCNN flatten NHWC activations, (H, W, C) order: the
    port's flatten of its NCHW view gives flax's row, a plain NCHW flatten
    does not."""
    x = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)    # NHWC
    want = np.asarray(jnp.asarray(x).reshape((2, -1)))
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    np.testing.assert_array_equal(flatten_hwc(nchw).numpy(), want)
    assert not np.array_equal(nchw.reshape(2, -1).numpy(), want)


def test_avg_pool_counts_the_padding_at_the_border():
    """Inception's SAME 3x3 average pool divides by 9 at the border too
    (``count_include_pad``), as flax's ``avg_pool`` does."""
    x = np.random.RandomState(2).rand(1, 5, 5, 3).astype(np.float32) + 1.0
    want = np.asarray(fnn.avg_pool(jnp.asarray(x), (3, 3), strides=(1, 1), padding="SAME"))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = inception.avg_pool_same_3x3(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    exclude = F.avg_pool2d(xt, 3, 1, 1, count_include_pad=False).permute(0, 2, 3, 1).numpy()
    assert not np.allclose(exclude[0, 0, 0], want[0, 0, 0], rtol=1e-2)
    np.testing.assert_allclose(exclude[0, 2, 2], want[0, 2, 2], rtol=1e-6)


def test_dtype_policy():
    """f32 parameters and statistics, bf16 compute, f32 logits (the
    reference's ``tests/test_models.py::test_bf16_compute_policy``)."""
    model = get_model("resnet18", num_classes=10, device="cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers())
    seen = []
    model.conv_init.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
    logits = model(torch.zeros(1, 32, 32, 3))
    assert seen == [torch.bfloat16] and logits.dtype == torch.float32


@pytest.mark.parametrize("name,kw", [
    ("ResNet-50", {}), ("resnet_18", {}), ("vgg16", dict(image_size=32)),
    ("inception_v3", {}),
])
def test_get_model_names_and_trees_match_reference(name, kw):
    """The same zoo names and normalisation; the port's parameter and
    buffer names and shapes are the flax tree's (checked on the meta device
    for the full-width models)."""
    ref = ref_get_model(name, num_classes=10)
    port = get_model(name, num_classes=10, device="meta", **kw)
    side = kw.get("image_size", 75 if "inception" in name else 32)
    variables = jax.eval_shape(lambda: ref.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, side, side, 3)), train=False))
    want = {n: tuple(s.shape) for n, s in named_tree_paths(variables["params"])}
    got = {n.replace(".", "/"): tuple(p.shape) for n, p in port.named_parameters()}
    got = {n: (s[2], s[3], s[1], s[0]) if len(s) == 4 else s for n, s in got.items()}
    assert got == want
    stats = {n: tuple(s.shape) for n, s in named_tree_paths(variables.get("batch_stats", {}))}
    assert {n.replace(".", "/"): tuple(b.shape) for n, b in port.named_buffers()} == stats
    with pytest.raises(ValueError, match="unknown model"):
        get_model("alexnet")


def test_flax_variables_round_trip():
    """``load_flax_params`` from a flax init (conv kernels HWIO -> OIHW,
    statistics into the buffers) and back, exactly; the export is a copy."""
    x, _ = _images(1, 16)
    ref = ref_resnet.ResNet(stage_sizes=[1, 1], num_filters=4, num_classes=10,
                            block=ref_resnet.BasicBlock)
    variables = jax.jit(lambda v: ref.init(jax.random.PRNGKey(3), v, train=False))(
        jnp.asarray(x))
    params, stats = _flat(variables["params"]), _flat(variables["batch_stats"])
    stats = {n: v + np.float32(0.5) for n, v in stats.items()}
    port = resnet.ResNet([1, 1], 10, 4, block=resnet.BasicBlock, device="cpu")
    load_flax_params(port, params, stats)
    assert port.conv_init.kernel.shape == (4, 3, 7, 7)
    back, back_stats = params_to_numpy(port), batch_stats_to_numpy(port)
    assert set(back) == set(params) and set(back_stats) == set(stats)
    for n in params:
        np.testing.assert_array_equal(back[n], params[n])
    for n in stats:
        np.testing.assert_array_equal(back_stats[n], stats[n])
    port.bn_init.mean.add_(1.0)
    np.testing.assert_array_equal(back_stats["bn_init/mean"], stats["bn_init/mean"])
