"""The port's int8 module rewrite (``bigdl_tpu_torch/nn/quantized.py``:
``quantize``, ``QuantizedLinear``, ``QuantizedSpatialConvolution``,
``count_executed_gemms``, ``calibrate``) against the JAX package's
``bigdl_tpu/nn/quantized.py`` on the same weights.

Each JAX model's ``init`` weights are bridged into the port's model with
``load_jax_params``; both are quantized by their own package and run on
the same numpy inputs. JAX quantizes eagerly where the int8 weights are
held bitwise, and otherwise runs jitted (``_jax_trees.run_fast``).
Tolerances, stated per check:

- the int8 weights and their scales: bitwise (the same ops, eager);
- Linear and conv outputs: within 1e-6 of the largest output (the
  integer products are exact in both; a conv's fp32 sums of integers stay
  exact below 2**24, and what is left is the fp32 rescale);
- a quantized CIFAR ResNet (BN between the convolutions, whose sums run
  in another order in each package): within 1e-3 of the largest logit;
- the int8 dot path against the float path of the port: bitwise, every
  sum here is below 2**24;
- calibrated scales and BN statistics against JAX's ``calibrate``:
  rtol 1e-5; outputs with the static scales within 2% of the largest
  output of the dynamic ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_trees import flat, run_fast, seeded_trees

import bigdl_tpu.nn as jnn
from bigdl_tpu.models import resnet as jresnet
from bigdl_tpu.nn.quantized import calibrate as jax_calibrate
from bigdl_tpu.nn.quantized import quantize as jax_quantize
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.interop import export_params, export_state, load_jax_params
from bigdl_tpu_torch.models import resnet
from bigdl_tpu_torch.nn.quantized import (
    QuantizedLinear,
    QuantizedSpatialConvolution,
    calibrate,
    count_executed_gemms,
    quantize,
    quantized_params,
)

OUT_TOL = 1e-6
RESNET_TOL = 1e-3


def _bridged(jax_model, port_model, seed=0):
    """Seeded numpy weights (``_jax_trees.seeded_trees``) for both."""
    params, state = seeded_trees(jax_model, seed)
    load_jax_params(port_model, params, state if state else None)
    return params, state


def _jax_quantized(jm, params):
    """JAX's ``quantize(jm, params)`` run jitted: (module, numpy params).
    The rewritten module is built while the function traces."""
    box = []

    def f(p):
        q, qp = jax_quantize(jm, p)
        box.append(q)
        return qp

    qp = run_fast(f, params)
    return box[0], qp


def _jax_out(jq, qp, x, state=None):
    return run_fast(lambda p, s, x: jq.apply(p, x, state=s)[0], qp,
                    state or {}, jnp.asarray(x))


def _run(model, x):
    with torch.inference_mode():
        return model(torch.from_numpy(x)).numpy()


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _conv_net(in_ch=1, pad=0):
    jm = jnn.Sequential(jnn.SpatialConvolution(in_ch, 4, 3, 3, pad_w=pad,
                                               pad_h=pad),
                        jnn.ReLU(), jnn.Reshape([4 * 6 * 6]),
                        jnn.Linear(4 * 6 * 6, 10))
    tm = nn.Sequential(nn.SpatialConvolution(in_ch, 4, 3, 3, pad_w=pad,
                                             pad_h=pad, device="cpu"),
                       nn.ReLU(), torch.nn.Flatten(),
                       nn.Linear(4 * 6 * 6, 10, device="cpu"))
    return jm, tm


def test_quantized_linear_matches_jax_and_holds_int8():
    jm, tm = jnn.Linear(32, 16), nn.Linear(32, 16, device="cpu")
    p, s = _bridged(jm, tm)
    jq, jqp = jax_quantize(jm, p)
    tq = quantize(tm)
    assert isinstance(tq, QuantizedLinear)
    assert tq.weight_q.dtype == torch.int8
    got = export_params(tq)
    assert sorted(got) == sorted(jqp)
    for k in ("weight_q", "scale", "act_scale", "bias"):
        np.testing.assert_array_equal(got[k], np.asarray(jqp[k]), err_msg=k)
    x = np.random.RandomState(0).randn(8, 32).astype(np.float32)
    out = _jax_out(jq, jqp, x)
    ref = _jax_out(jm, p, x)
    _close(_run(tq, x), out, OUT_TOL)
    rel = np.abs(_run(tq, x) - np.asarray(ref)).max() / np.abs(ref).max()
    assert rel < 0.05      # the quantized layer tracks the float one


def test_quantized_conv_matches_jax():
    jm = jnn.SpatialConvolution(3, 8, 3, 3, pad_w=1, pad_h=1)
    tm = nn.SpatialConvolution(3, 8, 3, 3, pad_w=1, pad_h=1, device="cpu")
    p, s = _bridged(jm, tm)
    jq, jqp = jax_quantize(jm, p)
    tq = quantize(tm)
    assert isinstance(tq, QuantizedSpatialConvolution)
    assert tuple(tq.scale.shape) == (8,)
    np.testing.assert_array_equal(tq.weight_q.numpy(),
                                  np.asarray(jqp["weight_q"]))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jqp["scale"]))
    x = np.random.RandomState(1).randn(2, 3, 12, 12).astype(np.float32)
    _close(_run(tq, x), _jax_out(jq, jqp, x), OUT_TOL)


def test_quantize_rewrites_a_tree_and_leaves_the_original():
    jm, tm = _conv_net()
    p, s = _bridged(jm, tm, seed=2)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    jq, jqp = _jax_quantized(jm, p)
    tq = quantize(tm)
    assert isinstance(tm[0], nn.SpatialConvolution)
    assert isinstance(tm[3], nn.Linear)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert isinstance(tq[0], QuantizedSpatialConvolution)
    assert isinstance(tq[3], QuantizedLinear)
    got = export_params(tq)
    assert sorted(flat(got)) == sorted(flat(jax.device_get(jqp)))
    _, jstate = jq.init(jax.random.key(0))
    assert sorted(flat(export_state(tq))) == sorted(flat(jstate))
    x = np.random.RandomState(2).randn(4, 1, 8, 8).astype(np.float32)
    _close(_run(tq, x), _jax_out(jq, jqp, x), OUT_TOL)
    ref = _jax_out(jm, p, x, s)
    agree = np.mean(np.argmax(_run(tq, x), -1) == np.argmax(ref, -1))
    assert agree >= 0.75


def test_quantize_rules_exact_types_aliases_and_sharing():
    class WideLinear(nn.Linear):
        pass

    shared = nn.Linear(8, 8, device="cpu")
    m = nn.Sequential(shared, nn.ReLU(), shared,
                      WideLinear(8, 4, device="cpu"))
    m.head = m[3]        # an attribute alias of a child
    q = quantize(m)
    assert isinstance(q[0], QuantizedLinear) and q[0] is q[2]
    assert type(q[3]) is WideLinear      # a subclass is left alone
    assert q.head is q[3]
    assert count_executed_gemms(q) == 1  # the shared child counts once

    class Graph(torch.nn.Module):
        pass

    with pytest.raises(NotImplementedError, match="A.9"):
        quantize(Graph())
    hwio = nn.SpatialConvolution(2, 3, 3, 3, kernel_format="HWIO",
                                 device="cpu")
    with pytest.raises(ValueError, match="OIHW"):
        quantize(hwio)


def test_quantized_resnet_matches_jax():
    jm = jresnet.build_cifar(8, class_num=10)
    params, state = seeded_trees(jm, seed=3)
    tm = load_jax_params(resnet.build_cifar(8, device="cpu"), params, state)
    jq, jqp = _jax_quantized(jm, params)
    tq = quantize(tm)
    tq.eval()
    x = np.random.RandomState(4).rand(2, 3, 32, 32).astype(np.float32)
    out = _jax_out(jq, jqp, x, state)
    got = _run(tq, x)
    assert got.shape == (2, 10) and np.isfinite(got).all()
    _close(got, out, RESNET_TOL)


def test_quantized_model_runs_through_functional_call():
    """What a service's ``forward_fn`` may run over the served tensors:
    ``torch.func.functional_call`` over the quantized module's own
    tensors gives its forward's bits."""
    tm = nn.Sequential(nn.Linear(16, 16, device="cpu"), nn.ReLU(),
                       nn.Linear(16, 4, device="cpu"))
    tq = quantize(tm)
    x = torch.ones(2, 16)
    with torch.inference_mode():
        out = torch.func.functional_call(
            tq, (dict(tq.named_parameters()), dict(tq.named_buffers())),
            (x,))
        assert torch.equal(out, tq(x)) and out.shape == (2, 4)


def test_calibrate_matches_jax_and_static_scales_track_dynamic():
    jm = jnn.Sequential(jnn.SpatialConvolution(3, 8, 3, 3, pad_w=1, pad_h=1),
                        jnn.SpatialBatchNormalization(8), jnn.ReLU(),
                        jnn.Reshape([8 * 4 * 4]), jnn.Linear(8 * 4 * 4, 5))
    tm = nn.Sequential(
        nn.SpatialConvolution(3, 8, 3, 3, pad_w=1, pad_h=1, device="cpu"),
        nn.SpatialBatchNormalization(8, device="cpu"), nn.ReLU(),
        torch.nn.Flatten(), nn.Linear(8 * 4 * 4, 5, device="cpu"))
    params, state = _bridged(jm, tm)
    jq, jqp = jax_quantize(jm, params)
    tq = quantize(tm)
    rs = np.random.RandomState(0)
    batches = [rs.rand(4, 3, 4, 4).astype(np.float32) for _ in range(3)]
    # the port calibrates from the module's own state: JAX from the same
    cparams, cstate = run_fast(
        lambda qp, st, bs: jax_calibrate(jq, qp, bs, state=st), jqp,
        export_state(tq), [jnp.asarray(b) for b in batches])
    tq.eval()
    assert calibrate(tq, [torch.from_numpy(b) for b in batches]) is tq
    assert not tq.training
    for got, want, what in ((export_params(tq), cparams, "params"),
                            (export_state(tq), cstate, "state")):
        g, w = flat(got), flat(jax.device_get(want))
        assert sorted(g) == sorted(w), what
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-7,
                                       err_msg=f"{what} {k}")
    scales = [m.act_scale for m in tq.modules()
              if isinstance(m, (QuantizedLinear, QuantizedSpatialConvolution))]
    assert scales and all(float(s) > 0 for s in scales)
    # the static scales against the dynamic ones, both over the BN
    # statistics calibration left
    out_static = _run(tq, batches[0])
    out_dyn = _jax_out(jq, jqp, batches[0], cstate)
    np.testing.assert_allclose(out_static, out_dyn,
                               atol=2e-2 * np.abs(out_dyn).max())
    _close(out_static, _jax_out(jq, cparams, batches[0], cstate), 1e-5)


@pytest.mark.parametrize("stride,pad,k", [(1, 1, 3), (2, 1, 3), (1, 0, 1),
                                          (2, 3, 7), (1, 2, 4)])
def test_int8_dot_conv_is_the_float_path_bitwise(monkeypatch, stride, pad, k):
    """``BIGDL_INT8_CONV=dot`` (im2col in (kh, kw)-major tap order, one
    int8 GEMM over weights flattened (O, kh, kw, I), K zero-padded to a
    multiple of 8) gives the float path's integers: every sum here is
    below 2**24, where fp32 is exact. Against JAX's dot path at the first
    shape."""
    jm = jnn.SpatialConvolution(3, 8, k, k, stride_w=stride, stride_h=stride,
                                pad_w=pad, pad_h=pad)
    tm = nn.SpatialConvolution(3, 8, k, k, stride_w=stride, stride_h=stride,
                               pad_w=pad, pad_h=pad, device="cpu")
    p, _ = _bridged(jm, tm)
    tq = quantize(tm)
    x = np.random.RandomState(1).randn(2, 3, 12, 12).astype(np.float32)
    xq, _ = _quantize_rows(tq, x)
    monkeypatch.setenv("BIGDL_INT8_CONV", "float")
    with torch.inference_mode():
        ints_f = torch.nn.functional.conv2d(
            xq.float(), tq.weight_q.float(), None, tq.stride, tq.pad)
        ints_d = tq._int8_dot_path(xq)
    assert ints_d.dtype == torch.int32
    np.testing.assert_array_equal(ints_d.numpy(), ints_f.numpy())
    y_f = _run(tq, x)
    monkeypatch.setenv("BIGDL_INT8_CONV", "dot")
    y_d = _run(tq, x)
    np.testing.assert_array_equal(y_d, y_f)
    if (stride, pad, k) == (1, 1, 3):
        _close(y_d, _jax_out(*_jax_quantized(jm, p), x), OUT_TOL)


def _quantize_rows(tq, x):
    from bigdl_tpu_torch.nn.quantized import _quantize_activation

    return _quantize_activation(torch.from_numpy(x), 0.0)


def test_stem_conv_k147_pads_to_the_gemm_and_stays_exact(monkeypatch):
    """ResNet-50's stem: K = 3 * 7 * 7 = 147, which the card's int8 GEMM
    takes only padded to a multiple of 8 (zero columns: exact)."""
    tm = nn.SpatialConvolution(3, 64, 7, 7, 2, 2, 3, 3, device="cpu")
    tq = quantize(tm)
    x = np.random.RandomState(5).randn(1, 3, 32, 32).astype(np.float32)
    xq, _ = _quantize_rows(tq, x)
    with torch.inference_mode():
        ints_d = tq._int8_dot_path(xq)
        ints_f = torch.nn.functional.conv2d(xq.float(), tq.weight_q.float(),
                                            None, 2, 3)
    np.testing.assert_array_equal(ints_d.numpy(), ints_f.numpy())


def test_activation_scales_are_per_sample():
    """A row's output never depends on its batch-mates: a row alone and
    the same row beside a 100x neighbour give the same bits."""
    tq = quantize(nn.Linear(8, 4, device="cpu"))
    row = 0.5 * np.ones((1, 8), np.float32)
    big = 50.0 * np.ones((1, 8), np.float32)
    np.testing.assert_array_equal(_run(tq, row)[0],
                                  _run(tq, np.concatenate([row, big]))[0])
    qc = quantize(nn.SpatialConvolution(2, 3, 3, 3, pad_w=1, pad_h=1,
                                        device="cpu"))
    img = np.random.RandomState(0).randn(1, 2, 6, 6).astype(np.float32)
    big_c = 100.0 * np.ones((1, 2, 6, 6), np.float32)
    np.testing.assert_array_equal(_run(qc, img)[0],
                                  _run(qc, np.concatenate([img, big_c]))[0])


def test_count_executed_gemms_excludes_float_convs(monkeypatch):
    _, tm = _conv_net()
    tq = quantize(tm)
    monkeypatch.delenv("BIGDL_INT8_CONV", raising=False)
    assert count_executed_gemms(tq) == 1      # the Linear only
    monkeypatch.setenv("BIGDL_INT8_CONV", "dot")
    assert count_executed_gemms(tq) == 2      # the conv joins


def test_quantized_params_of_a_float_tree_are_the_rewrites():
    """A reload's way in: the float tree of the model, quantized against
    the rewrite, equals the rewrite's own parameters."""
    _, tm = _conv_net()
    tq = quantize(tm)
    got = quantized_params(tq, export_params(tm))
    want = dict(tq.named_parameters())
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(torch.as_tensor(got[k]), want[k].detach()), k
