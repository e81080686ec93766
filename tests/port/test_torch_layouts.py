"""The NHWC and MIXED layouts, HWIO weights and the space-to-depth stem
against the JAX package, on the same weights.

Weights and BN statistics come from one seeded numpy tree
(``_jax_trees.seeded_trees``), bridged into the port with
``load_jax_params`` as stored (HWIO stays HWIO, the stem's weight stays
``(64, 3, 7, 7)``). fp32 throughout, JAX at ``highest`` precision and
compiled with ``_jax_trees.FAST_COMPILE``. Tolerances, stated per check:

- ResNet-50 logits at 32² x 2: max abs error <= 1e-4 x the largest
  logit; the loss rtol 1e-5; every gradient leaf ``assert_trees_close``
  rtol 1e-3, atol 2e-5 of the leaf's largest entry (53 convolutions,
  summation order differing at each). In evaluation mode: training-mode
  batch norm over layer4's 1x1 (2x2 at 64²) maps divides by the spread
  of 2 (16) values, which turns ulps into whole units; the two packages'
  NCHW models, the port's reference layout, differ by 16% of a gradient
  leaf there too (64² x 4), so such a check could not tell a layout
  fault from rounding;
- the stem alone: output max abs error <= 1e-5 x the largest output,
  the weight's gradient rtol 1e-4, atol 1e-5 of its largest entry;
- the layers alone (pooling, ``Transpose``, ``Padding``): 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_trees import assert_trees_close, compile_fast, seeded_trees

from bigdl_tpu import nn as jnn
from bigdl_tpu.models import resnet as jresnet
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.interop import load_jax_params, to_numpy_tree
from bigdl_tpu_torch.models import resnet


def _grads_jax(jm, params, state, x, y):
    crit = jnn.CrossEntropyCriterion()

    def f(p, s, x, y):
        def loss_fn(p):
            out, _ = jm.apply(p, x, state=s, training=False)
            return crit.forward(out.astype(jnp.float32), y), out
        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    return jax.device_get(compile_fast(f, params, state, x, y)(
        params, state, x, y))


@pytest.mark.parametrize("kw", [
    dict(data_format="NHWC"),
    dict(data_format="MIXED", kernel_format="HWIO"),
], ids=["nhwc", "mixed_hwio"])
def test_resnet50_layout_logits_and_grads_match_jax(kw):
    jm = jresnet.build_imagenet(50, **kw)
    params, state = seeded_trees(jm)
    tm = load_jax_params(resnet.build_imagenet(50, device="cpu", **kw),
                         params, state)
    rs = np.random.RandomState(4)
    x = rs.standard_normal((2, 3, 32, 32)).astype(np.float32)
    if kw["data_format"] == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    y = rs.randint(0, 1000, (2,))
    (jloss, jout), jgrads = _grads_jax(jm, params, state, x, y)

    named = dict(tm.named_parameters())
    out = tm.eval()(torch.from_numpy(x))
    loss = nn.CrossEntropyCriterion()(out.float(), torch.from_numpy(y))
    grads = dict(zip(named, torch.autograd.grad(loss,
                                                list(named.values()))))
    out = out.detach().numpy()
    assert out.shape == jout.shape == (2, 1000)
    err = np.abs(out - jout).max()
    assert err <= 1e-4 * np.abs(jout).max(), err
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    assert_trees_close(to_numpy_tree(grads), jgrads, rtol=1e-3, atol=2e-5,
                       what="grad")


def test_space_to_depth_stem_matches_jax_and_the_7x7_conv():
    js = jresnet.Conv1SpaceToDepth(64)
    w = seeded_trees(js)[0]["weight"]
    stem = resnet.Conv1SpaceToDepth(64, device="cpu")
    conv = nn.SpatialConvolution(3, 64, 7, 7, 2, 2, 3, 3, with_bias=False,
                                 device="cpu")
    with torch.no_grad():
        stem.weight.copy_(torch.from_numpy(w))
        conv.weight.copy_(torch.from_numpy(w))
    x = np.random.RandomState(5).standard_normal(
        (2, 3, 32, 32)).astype(np.float32)
    g = np.random.RandomState(6).standard_normal(
        (2, 64, 16, 16)).astype(np.float32)

    def jf(p, x):
        return jax.value_and_grad(lambda p: jnp.sum(
            js.apply(p, x)[0] * g))(p), js.apply(p, x)[0]

    (_, jgrad), jout = jax.device_get(compile_fast(jf, {"weight": w}, x)(
        {"weight": w}, x))
    scale = np.abs(jout).max()
    for m in (stem, conv):
        out = m(torch.from_numpy(x))
        (gw,) = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                    [m.weight])
        out = out.detach().numpy()
        assert out.shape == jout.shape == (2, 64, 16, 16)
        assert np.abs(out - jout).max() <= 1e-5 * scale
        assert_trees_close({"w": gw.numpy()}, {"w": jgrad["weight"]},
                           rtol=1e-4, atol=1e-5, what=type(m).__name__)


def test_stem_s2d_refuses_nhwc_in_the_jax_words():
    """NHWC refuses the stem with the JAX package's words; MIXED keeps an
    NCHW stem and takes it, in both packages."""
    for builder, kw in ((jresnet.build_imagenet, {}),
                        (resnet.build_imagenet, {"device": "cpu"})):
        with pytest.raises(ValueError) as e:
            builder(50, data_format="NHWC", stem_s2d=True, **kw)
        assert str(e.value) == "stem_s2d supports the NCHW layout only"
        builder(18, data_format="MIXED", stem_s2d=True, **kw)


def _jax_layer(jm, x):
    params, state = jm.init(jax.random.key(0))
    return np.asarray(jm.apply(params, jnp.asarray(x), state=state)[0])


@pytest.mark.parametrize("make", [
    lambda m: m.SpatialMaxPooling(3, 3, 2, 2, 1, 1, data_format="NHWC"),
    lambda m: m.SpatialAveragePooling(3, 3, 2, 2, 1, 1,
                                      data_format="NHWC"),
    lambda m: m.SpatialAveragePooling(1, 1, 2, 2, data_format="NHWC"),
    lambda m: m.GlobalAveragePooling2D(data_format="NHWC"),
    lambda m: m.Transpose((1, 2), (2, 3)),
    lambda m: m.Padding(3, 5),
], ids=["maxpool", "avgpool", "avgpool_1x1_s2", "global_avg", "transpose",
        "pad_channels"])
def test_nhwc_layers_match_jax(make):
    x = np.random.RandomState(7).standard_normal(
        (2, 9, 10, 6)).astype(np.float32)
    want = _jax_layer(make(jnn), x)
    got = make(nn)(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if make(nn).__class__.__name__ == "Transpose":
        assert got.is_contiguous()
