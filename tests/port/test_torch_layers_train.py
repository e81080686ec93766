"""The training slice's layers, criterions and SGD against the JAX
package's, on the same numpy inputs.

Forward values and gradients (autograd against ``jax.vjp`` with one
seeded cotangent). Tolerances: fp32 ``rtol=1e-5``, ``atol=1e-5`` of the
compared tensor's largest entry (XLA's and PyTorch's CPU kernels sum in
other orders: a few ulps). bf16, where the JAX path runs bf16 under the
mixed policy (convolution, batch norm, pooling): ``atol=2**-6`` of the
largest entry — both round every full-size op to bf16 (8 bits), at
places that may differ by one rounding. Max-pool gradients on inputs with
ties must match exactly (the all-ties rule moves whole gradients, not
ulps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_trees import run_fast

from bigdl_tpu.core import rng as jrng
from bigdl_tpu.nn import criterion as jcrit
from bigdl_tpu.nn.layers import conv as jconv
from bigdl_tpu.nn.layers import embedding as jemb
from bigdl_tpu.nn.layers import norm as jnorm
from bigdl_tpu.nn.layers import pooling as jpool
from bigdl_tpu.nn.layers import shape_ops as jshape
from bigdl_tpu.optim import optim_method as jopt
from bigdl_tpu.optim import schedules as jsched
from bigdl_tpu.optim import trigger as jtrig
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.core import DtypePolicy, EngineConfig, RandomGenerator
from bigdl_tpu_torch.core import rng as trng
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.nn import init as tinit
from bigdl_tpu_torch.nn.layers.norm import bn_train
from bigdl_tpu_torch.optim import SGD, MultiStep, TrainingState, Trigger

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (0.0, 2.0 ** -6)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def close(got, want, dtype="float32"):
    rtol, atol = TOL[dtype]
    got = np.asarray(torch.as_tensor(got).detach().float())
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def rand(rs, *shape):
    return rs.standard_normal(shape).astype(np.float32)


def jax_vjp(fn, args, ct):
    """``fn(*args)`` and its vjp at ``ct``, jitted and compiled with
    ``_jax_trees.FAST_COMPILE``."""
    def both(args, ct):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(ct)

    return run_fast(both, tuple(args), ct)


def torch_grads(out, inputs, ct):
    return torch.autograd.grad(out, inputs, torch.as_tensor(ct).to(out.dtype))


# ------------------------------------------------------------- conv ----


@pytest.mark.parametrize("kernel_format", ["OIHW", "HWIO"])
@pytest.mark.parametrize("stride, pad, groups", [
    (1, 0, 1), (1, 1, 1), (2, 1, 1), (2, -1, 1), (1, 1, 2)])
def test_conv_matches_jax(kernel_format, stride, pad, groups):
    rs = np.random.RandomState(0)
    jl = jconv.SpatialConvolution(4, 6, 3, 3, stride, stride, pad, pad,
                                  n_group=groups, kernel_format=kernel_format)
    w = rand(rs, 6, 4 // groups, 3, 3)
    if kernel_format == "HWIO":
        w = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
    params = {"weight": w, "bias": rand(rs, 6)}
    x = rand(rs, 2, 4, 9, 9)
    tl = nn.SpatialConvolution(4, 6, 3, 3, stride, stride, pad, pad,
                               n_group=groups, kernel_format=kernel_format,
                               device="cpu")
    load_jax_params(tl, params)
    xt = torch.from_numpy(x).requires_grad_()
    out = tl(xt)
    ct = rand(rs, *out.shape)
    want, (gp, gx) = jax_vjp(lambda p, x: jl.apply(p, x)[0], (params, x), ct)
    close(out, want)
    dx, dw, db = torch_grads(out, [xt, tl.weight, tl.bias], ct)
    close(dx, gx)
    close(dw, gp["weight"])
    close(db, gp["bias"])


def test_conv_bf16_forward_matches_jax():
    rs = np.random.RandomState(1)
    params = {"weight": rand(rs, 8, 4, 3, 3) * 0.3}
    jl = jconv.SpatialConvolution(4, 8, 3, 3, 2, 2, 1, 1, with_bias=False)
    tl = nn.SpatialConvolution(4, 8, 3, 3, 2, 2, 1, 1, with_bias=False,
                               device="cpu")
    load_jax_params(tl, params)
    x = rand(rs, 2, 4, 8, 8)
    want, _ = jl.apply(params, jnp.asarray(x, jnp.bfloat16))
    out = tl(torch.from_numpy(x).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    close(out, want, "bfloat16")


# -------------------------------------------------------- batch norm ----


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 3, 5, 5), (6, 5)], ids=["nchw", "nc"])
def test_bn_train_matches_jax_custom_vjp(dtype, shape):
    rs = np.random.RandomState(2)
    x = rand(rs, *shape) * 2.0 + 0.5
    c = shape[1]
    gamma, beta = 1.0 + rand(rs, c) * 0.2, rand(rs, c) * 0.1
    axes = tuple(i for i in range(len(shape)) if i != 1)
    xj = jnp.asarray(x, dtype)
    g = rand(rs, *shape)
    (y, mean, var), vjp = jax.vjp(
        lambda x, a, b: jnorm.bn_train(x, a, b, axes, 1e-5), xj, gamma, beta)
    dx, dgamma, dbeta = vjp((jnp.asarray(g, dtype), jnp.zeros_like(mean),
                             jnp.zeros_like(var)))
    xt = torch.from_numpy(x).to(TORCH_DT[dtype]).requires_grad_()
    gt, bt = (torch.from_numpy(a).requires_grad_() for a in (gamma, beta))
    ty, tmean, tvar = bn_train(xt, gt, bt, axes, 1e-5)
    assert ty.dtype == TORCH_DT[dtype]
    assert tmean.dtype == tvar.dtype == torch.float32
    close(ty, y, dtype)
    close(tmean, mean)
    close(tvar, var)
    tdx, tdg, tdb = torch_grads(ty, [xt, gt, bt], g)
    assert tdx.dtype == TORCH_DT[dtype]
    close(tdx, dx, dtype)
    for got, want in ((tdg, dgamma), (tdb, dbeta)):
        # per-channel fp32 sums of bf16 products: relative to the sum
        close(got, want, "float32" if dtype == "float32" else "bfloat16")


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("momentum", [0.1, 0.5])
@pytest.mark.parametrize("affine", [True, False])
def test_spatial_bn_layer_and_running_stats_match_jax(training, momentum,
                                                      affine):
    rs = np.random.RandomState(3)
    params = {"weight": 1.0 + rand(rs, 3) * 0.2, "bias": rand(rs, 3) * 0.1}
    params = params if affine else {}
    state = {"running_mean": rand(rs, 3) * 0.1,
             "running_var": 1.0 + np.abs(rand(rs, 3)) * 0.3}
    x = rand(rs, 4, 3, 5, 5) + 0.3
    jl = jnorm.SpatialBatchNormalization(3, momentum=momentum, affine=affine)
    want, new_state = jl.apply(params, x, state=state, training=training)
    tl = nn.SpatialBatchNormalization(3, momentum=momentum, affine=affine,
                                      device="cpu")
    load_jax_params(tl, params, state)
    out = tl.train(training)(torch.from_numpy(x))
    close(out, want)
    close(tl.running_mean, new_state["running_mean"])
    close(tl.running_var, new_state["running_var"])


# ------------------------------------------------------------- pooling ----


@pytest.mark.parametrize("k, s, p, ceil", [
    (3, 2, 1, False), (2, 2, 0, False), (3, 2, 0, True), (3, 1, 1, False)])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_max_pool_matches_jax_all_ties_rule(k, s, p, ceil, ties):
    rs = np.random.RandomState(4)
    x = (rs.randint(0, 3, (2, 3, 7, 7)).astype(np.float32) if ties
         else rand(rs, 2, 3, 7, 7))
    jl = jpool.SpatialMaxPooling(k, k, s, s, p, p)
    jl.fused_backward = True        # the JAX package's all-ties backward
    tl = nn.SpatialMaxPooling(k, k, s, s, p, p)
    if ceil:
        jl.ceil()
        tl.ceil()
    xt = torch.from_numpy(x).requires_grad_()
    out = tl(xt)
    g = rand(rs, *out.shape)
    want, (gx,) = jax_vjp(lambda x: jl.apply({}, x)[0], (x,), g)
    close(out, want)
    (dx,) = torch_grads(out, [xt], g)
    if ties:   # whole gradients land on every tied position
        np.testing.assert_allclose(dx.numpy(), np.asarray(gx), rtol=1e-6,
                                   atol=1e-6)
    else:
        close(dx, gx)


def test_max_pool_bf16_matches_jax():
    rs = np.random.RandomState(5)
    x = rs.randint(0, 4, (2, 3, 8, 8)).astype(np.float32)
    jl = jpool.SpatialMaxPooling(3, 3, 2, 2, 1, 1)
    jl.fused_backward = True
    tl = nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    out = tl(xt)
    g = rand(rs, *out.shape)
    want, (gx,) = jax_vjp(lambda x: jl.apply({}, x)[0],
                          (jnp.asarray(x, jnp.bfloat16),),
                          jnp.asarray(g, jnp.bfloat16))
    close(out, want, "bfloat16")
    (dx,) = torch_grads(out, [xt], g)
    assert dx.dtype == torch.bfloat16
    close(dx, gx, "bfloat16")


@pytest.mark.parametrize("k, s, p, ceil, include", [
    (1, 2, 0, False, True), (3, 2, 1, False, True), (3, 2, 1, False, False),
    (3, 2, 1, True, True), (2, 2, 0, True, False)])
def test_average_pool_matches_jax(k, s, p, ceil, include):
    rs = np.random.RandomState(6)
    x = rand(rs, 2, 3, 7, 7)
    jl = jpool.SpatialAveragePooling(k, k, s, s, p, p,
                                     count_include_pad=include)
    tl = nn.SpatialAveragePooling(k, k, s, s, p, p, count_include_pad=include)
    if ceil:
        jl.ceil()
        tl.ceil()
    xt = torch.from_numpy(x).requires_grad_()
    out = tl(xt)
    g = rand(rs, *out.shape)
    want, (gx,) = jax_vjp(lambda x: jl.apply({}, x)[0], (x,), g)
    close(out, want)
    close(torch_grads(out, [xt], g)[0], gx)


@pytest.mark.parametrize("layer", ["gap", "pad_after", "pad_before",
                                   "pad_value"])
def test_shape_layers_match_jax(layer):
    jl, tl = {
        "gap": (jpool.GlobalAveragePooling2D(), nn.GlobalAveragePooling2D()),
        "pad_after": (jshape.Padding(1, 3), nn.Padding(1, 3)),
        "pad_before": (jshape.Padding(2, -2), nn.Padding(2, -2)),
        "pad_value": (jshape.Padding(-1, 1, 0.5), nn.Padding(-1, 1, 0.5)),
    }[layer]
    rs = np.random.RandomState(7)
    x = rand(rs, 2, 3, 4, 5)
    xt = torch.from_numpy(x).requires_grad_()
    out = tl(xt)
    g = rand(rs, *out.shape)
    want, (gx,) = jax_vjp(lambda x: jl.apply({}, x)[0], (x,), g)
    close(out, want)
    close(torch_grads(out, [xt], g)[0], gx)


def test_relu_gradient_at_zero_is_zero():
    x = torch.tensor([-1.0, 0.0, 2.0], requires_grad=True)
    (dx,) = torch.autograd.grad(nn.ReLU()(x).sum(), [x])
    want = jax.grad(lambda x: jax.nn.relu(x).sum())(jnp.array([-1.0, 0, 2]))
    np.testing.assert_array_equal(dx.numpy(), np.asarray(want))
    np.testing.assert_array_equal(dx.numpy(), [0.0, 0.0, 1.0])


# ---------------------------------------------------------- criterion ----


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("size_average", [True, False])
def test_cross_entropy_matches_jax(weighted, size_average):
    rs = np.random.RandomState(8)
    logits = rand(rs, 6, 5) * 3.0
    target = rs.randint(0, 5, (6,))
    w = (np.abs(rand(rs, 5)) + 0.1) if weighted else None
    jc = jcrit.CrossEntropyCriterion(None if w is None else jnp.asarray(w),
                                     size_average)
    tc = nn.CrossEntropyCriterion(None if w is None else torch.from_numpy(w),
                                  size_average)
    lt = torch.from_numpy(logits).requires_grad_()
    loss = tc(lt, torch.from_numpy(target))
    want, grad = jax.value_and_grad(
        lambda o: jc.forward(o, jnp.asarray(target)))(logits)
    close(loss, want)
    close(torch.autograd.grad(loss, [lt])[0], grad)


def test_class_nll_float64_weights_match_jax_bitwise():
    """Class weights given as float64 (numpy's default) are taken in fp32,
    as ``jnp.take`` takes them: the loss is fp32 and equals JAX's in every
    bit (8 picked entries, one sum of each; the division is the same fp32
    division)."""
    rs = np.random.RandomState(12)
    logp = np.log(np.abs(rand(rs, 8, 5)) + 0.1).astype(np.float32)
    target = rs.randint(0, 5, (8,))
    w = np.abs(rs.standard_normal(5)) + 0.1          # float64
    for size_average in (True, False):
        want = jax.jit(jcrit.ClassNLLCriterion(w, size_average).forward)(
            logp, jnp.asarray(target))
        got = nn.ClassNLLCriterion(w, size_average)(torch.from_numpy(logp),
                                                    torch.from_numpy(target))
        assert got.dtype == torch.float32
        assert np.float32(got.item()) == np.float32(want), (got, want)


@pytest.mark.parametrize("inner_average", [True, False])
@pytest.mark.parametrize("size_average", [True, False])
def test_time_distributed_criterion_matches_jax(inner_average, size_average):
    """The per-step criterion over (batch, time, classes), rescaled by the
    number of steps as the JAX package rescales it."""
    rs = np.random.RandomState(13)
    out = rand(rs, 3, 4, 6) * 2.0
    target = rs.randint(0, 6, (3, 4))
    jc = jcrit.TimeDistributedCriterion(
        jcrit.CrossEntropyCriterion(size_average=inner_average), size_average)
    tc = nn.TimeDistributedCriterion(
        nn.CrossEntropyCriterion(size_average=inner_average), size_average)
    ot = torch.from_numpy(out).requires_grad_()
    loss = tc(ot, torch.from_numpy(target))
    want, grad = jax.value_and_grad(
        lambda o: jc.forward(o, jnp.asarray(target)))(out)
    close(loss, want)
    close(torch.autograd.grad(loss, [ot])[0], grad)


def test_lookup_table_matches_jax():
    """``weight[ids]`` for ids of any shape, and its gradient (rows summed
    per id); the padding row starts at zero."""
    rs = np.random.RandomState(14)
    w = rand(rs, 10, 6)
    ids = rs.randint(0, 10, (3, 5))
    jm = jemb.LookupTable(10, 6)
    tm = load_jax_params(nn.LookupTable(10, 6, device="cpu"),
                         {"weight": w})
    ct = rand(rs, 3, 5, 6)
    want, (gw,) = jax_vjp(lambda p: jm.apply({"weight": p},
                                             jnp.asarray(ids))[0], (w,), ct)
    got = tm(torch.from_numpy(ids))
    assert torch.equal(got, torch.from_numpy(np.asarray(want)))
    close(torch_grads(got, [tm.weight], ct)[0], gw)
    padded = nn.LookupTable(10, 6, padding_value=3, device="cpu")
    assert padded.weight[3].abs().sum().item() == 0.0
    assert padded.weight[4].abs().sum().item() > 0.0


def test_class_nll_on_probabilities_matches_jax():
    rs = np.random.RandomState(9)
    probs = np.abs(rand(rs, 4, 3))
    probs /= probs.sum(-1, keepdims=True)
    target = np.array([0, 2, 1, 2])
    want = jcrit.ClassNLLCriterion(log_prob_as_input=False).forward(
        probs, jnp.asarray(target))
    got = nn.ClassNLLCriterion(log_prob_as_input=False)(
        torch.from_numpy(probs), torch.from_numpy(target))
    close(got, want)


# ---------------------------------------------------------------- SGD ----


@pytest.mark.parametrize("kw", [
    dict(),
    dict(momentum=0.9),
    dict(momentum=0.9, dampening=0.1),
    dict(momentum=0.9, nesterov=True),
    dict(momentum=0.9, weight_decay=1e-3),
    dict(weight_decay=1e-2),
    dict(momentum=0.5, schedule="multistep"),
], ids=["plain", "momentum", "dampening", "nesterov", "wd_momentum", "wd",
        "multistep"])
def test_sgd_matches_jax(kw):
    kw = dict(kw)
    if kw.pop("schedule", None):
        jkw = dict(kw, schedule=jsched.MultiStep([1, 2], 0.5))
        kw["schedule"] = MultiStep([1, 2], 0.5)
    else:
        jkw = kw
    rs = np.random.RandomState(10)
    params = {"a": {"weight": rand(rs, 3, 4)}, "b": {"bias": rand(rs, 4)}}
    jm, tm = jopt.SGD(0.1, **jkw), SGD(0.1, **kw)
    tparams = {"a.weight": torch.from_numpy(params["a"]["weight"].copy()),
               "b.bias": torch.from_numpy(params["b"]["bias"].copy())}
    jstate, tstate = jm.init_state(params), tm.init_state(tparams)
    for _ in range(3):
        grads = {"a": {"weight": rand(rs, 3, 4)}, "b": {"bias": rand(rs, 4)}}
        params, jstate = jm.update(grads, params, jstate)
        tm.update({"a.weight": torch.from_numpy(grads["a"]["weight"]),
                   "b.bias": torch.from_numpy(grads["b"]["bias"])},
                  tparams, tstate)
    close(tparams["a.weight"], params["a"]["weight"])
    close(tparams["b.bias"], params["b"]["bias"])
    assert tstate["step"] == int(jstate["step"]) == 3
    if "velocity" in jstate:
        close(tstate["velocity"]["a.weight"], jstate["velocity"]["a"]["weight"])
    else:
        assert "velocity" not in tstate


def test_nesterov_needs_momentum():
    with pytest.raises(ValueError, match="nesterov"):
        SGD(0.1, nesterov=True)


# --------------------------------------------------- triggers and rng ----


STATES = [dict(), dict(iteration=2), dict(iteration=3, epoch=2),
          dict(epoch_finished=True, iteration=4), dict(epoch=3, loss=0.5),
          dict(score=0.7, iteration=6, loss=2.0)]


@pytest.mark.parametrize("build", [
    lambda T: T.every_epoch(), lambda T: T.several_iteration(2),
    lambda T: T.max_epoch(2), lambda T: T.max_iteration(3),
    lambda T: T.and_(T.max_iteration(2), T.every_epoch()),
    lambda T: T.or_(T.max_epoch(2), T.several_iteration(3))],
    ids=["every_epoch", "several_iteration", "max_epoch", "max_iteration",
         "and", "or"])
def test_triggers_match_jax(build):
    jt, tt = build(jtrig.Trigger), build(Trigger)
    for kw in STATES:
        assert tt(TrainingState(**kw)) == jt(jtrig.TrainingState(**kw)), kw


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_random_generator_draws_match_jax(seed):
    jg, tg = jrng.RandomGenerator(seed), RandomGenerator(seed)
    for n in (10, 1, 513, 10):
        np.testing.assert_array_equal(tg.permutation(n), jg.permutation(n))
    for index, stream in ((0, 0), (5, 0), (3, 2)):
        assert trng.element_seed(seed, index, stream) == \
            jrng.element_seed(seed, index, stream)
        np.testing.assert_array_equal(
            trng.np_rng(seed, index, stream).random(3),
            jrng.np_rng(seed, index, stream).random(3))


# --------------------------------------------------- config and init ----


def test_dtype_policy_casts_floating_tensors_only():
    mixed = DtypePolicy.mixed()
    assert mixed.cast_compute(torch.ones(2)).dtype == torch.bfloat16
    assert mixed.cast_compute(torch.arange(3)).dtype == torch.int64
    full = DtypePolicy.full_precision()
    assert full.cast_compute(torch.ones(1, dtype=torch.bfloat16)).dtype \
        == torch.float32
    assert (mixed.param_dtype, mixed.reduce_dtype, mixed.output_dtype) \
        == (torch.float32,) * 3


def test_engine_config_reads_env_at_construction(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_SEED", "9")
    monkeypatch.setenv("BIGDL_TPU_BATCH_SIZE", "32")
    cfg = EngineConfig()
    assert (cfg.seed, cfg.default_batch_size, cfg.log_every_n_steps) \
        == (9, 32, 1)
    assert cfg.dtypes == DtypePolicy.full_precision()


@pytest.mark.parametrize("method, check", [
    (tinit.Zeros(), lambda w: (w == 0).all()),
    (tinit.Ones(), lambda w: (w == 1).all()),
    (tinit.ConstInitMethod(0.25), lambda w: (w == 0.25).all()),
    (tinit.Xavier(), lambda w: w.abs().max() <= (6.0 / (500 + 200)) ** 0.5),
    (tinit.MsraFiller(), lambda w: abs(w.std() - (2.0 / 200) ** 0.5) < 5e-3),
    (tinit.MsraFiller(True),
     lambda w: abs(w.std() - (2.0 / 350) ** 0.5) < 5e-3),
], ids=["zeros", "ones", "const", "xavier", "msra", "msra_avg"])
def test_init_methods(method, check):
    w = method(torch.Generator().manual_seed(0), (200, 500), 500, 200)
    assert w.shape == (200, 500) and w.dtype == torch.float32
    assert bool(check(w))
