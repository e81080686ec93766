"""The port's ResNets against the JAX package's, on the same weights.

The weights and BN statistics come from one seeded numpy tree
(``_jax_trees.seeded_trees``), given to the JAX model as they are and to
the port's through ``load_jax_params``. Everything runs in fp32, JAX at
``highest`` matmul precision; what differs is the summation order inside
the convolutions and the BN sums (XLA's CPU kernels vs PyTorch's), a few
ulps per op. The JAX references run jitted, compiled with
``_jax_trees.FAST_COMPILE``. Tolerances, stated per check below:

- one SGD step of ``build_cifar(8)``: loss rtol 1e-5; grads, updated
  params, velocity and running statistics rtol 1e-4, atol 1e-5 of each
  leaf's largest entry (``assert_trees_close``);
- ``build_imagenet(50)`` eval logits: max abs error <= 1e-4 x the largest
  logit (53 convolutions deep; eval-mode BN does not renormalise, so the
  logits' scale depends on the weights);
- a bottleneck with HWIO weights in training mode: the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_trees import assert_trees_close, flat, run_fast, seeded_trees

from bigdl_tpu.models import resnet as jresnet
from bigdl_tpu.nn import CrossEntropyCriterion as JaxCE
from bigdl_tpu.optim.optim_method import SGD as JaxSGD
from bigdl_tpu_torch.interop import (
    export_optim_state,
    export_params,
    export_state,
    load_jax_params,
    to_numpy_tree,
)
from bigdl_tpu_torch.models import resnet
from bigdl_tpu_torch.nn import CrossEntropyCriterion
from bigdl_tpu_torch.optim import SGD


def _port(jax_model, builder, seed=0):
    params, state = seeded_trees(jax_model, seed)
    model = load_jax_params(builder(), params, state)
    return params, state, model


def test_cifar8_sgd_step_matches_jax():
    jm = jresnet.build_cifar(8)
    params, state, tm = _port(
        jm, lambda: resnet.build_cifar(8, device="cpu"))
    rs = np.random.RandomState(1)
    x = rs.standard_normal((4, 3, 32, 32)).astype(np.float32)
    y = rs.randint(0, 10, (4,))
    kw = dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)
    method, crit = JaxSGD(**kw), JaxCE()

    def jax_step(p, s, x, y):
        def loss_fn(p):
            out, ns = jm.apply(p, x, state=s, training=True)
            return crit.forward(out.astype(jnp.float32), y), ns
        (loss, ns), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        new_p, new_o = method.update(grads, p, method.init_state(p),
                                     jnp.int32(1))
        return loss, grads, new_p, new_o, ns

    jloss, jgrads, jparams, jostate, jstate = run_fast(jax_step, params,
                                                       state, x, y)

    named = dict(tm.named_parameters())
    loss = CrossEntropyCriterion()(tm(torch.from_numpy(x)).float(),
                                   torch.from_numpy(y))
    grads = dict(zip(named, torch.autograd.grad(loss,
                                                list(named.values()))))
    sgd = SGD(**kw)
    ostate = sgd.init_state(named)
    sgd.update(grads, named, ostate, 1)

    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    tol = dict(rtol=1e-4, atol=1e-5)
    assert_trees_close(to_numpy_tree(grads), jgrads, what="grad", **tol)
    assert_trees_close(export_params(tm), jparams, what="param", **tol)
    assert_trees_close(export_state(tm), jstate, what="state", **tol)
    ported = export_optim_state(ostate)
    assert ported["step"] == int(jostate["step"]) == 1
    assert_trees_close(ported["velocity"], jostate["velocity"],
                       what="velocity", **tol)


def test_imagenet50_eval_logits_match_jax():
    jm = jresnet.build_imagenet(50)
    params, state, tm = _port(
        jm, lambda: resnet.build_imagenet(50, device="cpu"))
    x = np.random.RandomState(2).standard_normal(
        (2, 3, 64, 64)).astype(np.float32)
    want, _ = run_fast(lambda p, s, x: jm.apply(p, x, state=s), params,
                       state, x)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1000)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= 1e-4 * np.abs(want).max(), (err, np.abs(want).max())


class _OnCpu:
    """The port's ``resnet`` builders with ``device="cpu"``."""

    def __getattr__(self, name):
        fn = getattr(resnet, name)
        return lambda *a, **kw: fn(*a, device="cpu", **kw)


ON_CPU = _OnCpu()


@pytest.mark.parametrize("build", [
    lambda m: m.build_cifar(8),
    lambda m: m.build_cifar(20, class_num=100),
    lambda m: m.build_imagenet(50),
    lambda m: m.build_imagenet(50, kernel_format="HWIO"),
    lambda m: m.build_imagenet(18),
    lambda m: m.basic_block(16, 32, 2, shortcut_type="A"),
    lambda m: m.shortcut(64, 256, 1, "B"),
    lambda m: m.build_imagenet(50, data_format="NHWC"),
    lambda m: m.build_imagenet(50, data_format="MIXED"),
    lambda m: m.build_imagenet(50, stem_s2d=True),
], ids=["cifar8", "cifar20_100", "imagenet50", "imagenet50_hwio",
        "imagenet18", "basic_block_A", "shortcut_B", "imagenet50_nhwc",
        "imagenet50_mixed", "imagenet50_s2d"])
def test_parameter_and_state_paths_are_jax_paths(build):
    """Every parameter and buffer of the port sits at its JAX tree path,
    with the JAX leaf's shape (HWIO weights stay HWIO)."""
    jparams, jstate = jax.eval_shape(build(jresnet).init, jax.random.key(0))
    tm = build(ON_CPU)
    for kind, jtree, tensors in (("params", jparams, tm.named_parameters()),
                                 ("state", jstate, tm.named_buffers())):
        want = {k: tuple(v.shape) for k, v in flat(jtree).items()}
        got = {k: tuple(v.shape) for k, v in tensors}
        assert got == want, kind


def test_bottleneck_hwio_training_matches_jax():
    jm = jresnet.bottleneck(32, 16, 2, kernel_format="HWIO")
    params, state, tm = _port(jm, lambda: resnet.bottleneck(
        32, 16, 2, kernel_format="HWIO", device="cpu"))
    conv = tm[0][0][0]
    np.testing.assert_array_equal(           # copied as stored: HWIO
        conv.weight.detach().numpy(), params["0"]["0"]["0"]["weight"])
    x = np.random.RandomState(3).standard_normal(
        (2, 32, 8, 8)).astype(np.float32)

    def loss_fn(p, x):
        out, ns = jm.apply(p, x, state=state, training=True)
        return jnp.sum(out * out), (out, ns)

    (jloss, (jout, jstate)), (jgp, jgx) = run_fast(
        jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True), params, x)
    xt = torch.from_numpy(x).requires_grad_()
    out = tm.train()(xt)
    named = dict(tm.named_parameters())
    grads = torch.autograd.grad((out * out).sum(),
                                [xt] + list(named.values()))
    tol = dict(rtol=1e-4, atol=1e-5)
    assert_trees_close({"out": out.detach().numpy(),
                        "dx": grads[0].numpy()},
                       {"out": jout, "dx": jgx}, what="output", **tol)
    assert_trees_close(to_numpy_tree(dict(zip(named, grads[1:]))), jgp,
                       what="grad", **tol)
    assert_trees_close(export_state(tm), jstate, what="state", **tol)


@pytest.mark.parametrize("kw", [dict(data_format="NHWC"),
                                dict(data_format="MIXED"),
                                dict(stem_s2d=True)],
                         ids=["nhwc", "mixed", "s2d"])
def test_queued_variants_raise(kw):
    """The variants once queued are built now, each in its layout: NHWC
    layers throughout, MIXED's one transpose before layer2, the
    space-to-depth stem."""
    model = resnet.build_imagenet(50, device="cpu", **kw)
    convs = [m for m in model.modules()
             if isinstance(m, resnet.nn.SpatialConvolution)]
    layouts = [c.data_format for c in convs]
    if kw.get("data_format") == "NHWC":
        assert set(layouts) == {"NHWC"}
    elif kw.get("data_format") == "MIXED":
        names = list(dict(model.named_children()))
        assert names.index("to_nhwc") == names.index("layer2_0") - 1
        assert layouts[0] == "NCHW" and layouts[-1] == "NHWC"
    else:
        assert isinstance(model.conv1, resnet.Conv1SpaceToDepth)
        assert tuple(model.conv1.weight.shape) == (64, 3, 7, 7)
