"""Kernel B1's wrapper on the CPU: dispatch, the plain version, the
backward, and ``CAddTable``'s knob. The kernel itself runs only on a card
(``test_torch_gpu.py``). Every comparison here is bitwise: an add is
exact in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.pallas_add import residual_add as jax_residual_add
from bigdl_tpu_torch.nn import CAddTable
from bigdl_tpu_torch.nn.layers import table_ops
from bigdl_tpu_torch.ops import cuda_lib
from bigdl_tpu_torch.ops import residual_add as ra

BIG = (2, 8, 256, 256)        # 2**20 elements
_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "float16": torch.float16}


def _pair(shape_x, shape_y=None, dx=torch.float32, dy=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape_x, generator=g).to(dx)
    y = torch.randn(shape_y or shape_x, generator=g).to(dy or dx)
    return x, y


@pytest.mark.parametrize("case, eligible", [
    (dict(shape_x=BIG), True),
    (dict(shape_x=BIG, dx=torch.bfloat16), True),
    (dict(shape_x=BIG, dx=torch.float16), True),
    (dict(shape_x=(4, 1 << 18)), True),                      # 2-D, 2**20
    (dict(shape_x=(2, 8, 256, 255)), False),                 # < 2**20
    (dict(shape_x=(1 << 20,)), False),                       # 1-D
    (dict(shape_x=BIG, dx=torch.float64), False),            # no f64 kernel
    (dict(shape_x=BIG, dx=torch.float32, dy=torch.bfloat16), False),
    (dict(shape_x=BIG, shape_y=(1, 8, 256, 256)), False),    # broadcast
], ids=["f32", "bf16", "f16", "2d", "small", "1d", "f64", "mixed_dtype",
        "broadcast"])
def test_dispatch_table(case, eligible):
    x, y = _pair(**case)
    assert ra.kernel_eligible(x, y) == eligible


def test_non_contiguous_operands_are_eligible():
    """A strided operand qualifies (the wrapper copies it to a contiguous
    one before the launch); on the CPU it takes the plain add, bitwise."""
    x, y = _pair((2, 8, 256, 512))
    x, y = x[..., ::2], y[..., :256].contiguous()
    assert x.numel() == 1 << 20 and not x.is_contiguous()
    assert ra.kernel_eligible(x, y) and ra.kernel_eligible(y, x)
    before = ra.residual_add.launches
    assert torch.equal(ra.residual_add(x, y), x + y)
    assert ra.residual_add.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape", [BIG, (3, 5, 7), (4, 1)],
                         ids=["big", "small", "tiny"])
def test_cpu_tensors_take_the_plain_add_bitwise(dtype, shape):
    x, y = _pair(shape, dx=_DT[dtype])
    before = ra.residual_add.launches
    out = ra.residual_add(x, y)
    assert ra.residual_add.launches == before
    assert out.dtype == x.dtype
    assert torch.equal(out, x + y)
    assert torch.equal(ra.residual_add_plain(x, y), x + y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_add_matches_jax_residual_add_bitwise(dtype):
    x, y = _pair(BIG, dx=_DT[dtype])
    want = jax_residual_add(jnp.asarray(x.float().numpy(), dtype),
                            jnp.asarray(y.float().numpy(), dtype))
    got = ra.residual_add(x, y)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_broadcast_add_keeps_plain_gradients():
    x = torch.randn(2, 3, 4, requires_grad=True)
    b = torch.randn(1, 3, 1, requires_grad=True)
    gx, gb = torch.autograd.grad(ra.residual_add(x, b).sum(), [x, b])
    assert gx.shape == x.shape and gb.shape == b.shape
    assert torch.equal(gb, torch.full_like(b, 8.0))


def test_kernel_backward_passes_the_cotangent_to_both():
    g = torch.randn(3, 4)
    gx, gy = ra._ResidualAdd.backward(None, g)
    assert gx is g and gy is g


def test_kernel_library_is_declared():
    name, argtypes = cuda_lib.SIGNATURES["residual_add"]
    assert name == "bigdl_residual_add" and len(argtypes) == 6
    src = (cuda_lib.CSRC / "residual_add.cu").read_text()
    assert f'extern "C" int {name}(' in src
    assert cuda_lib._digest("residual_add") != cuda_lib._digest(
        "flash_attention")


@pytest.mark.parametrize("knob", [None, "pallas", "other"])
def test_cadd_table_reads_the_knob_on_every_call(monkeypatch, knob):
    calls = []

    def spy(x, y):
        calls.append((x, y))
        return ra.residual_add(x, y)

    monkeypatch.setattr(table_ops, "residual_add", spy)
    if knob is None:
        monkeypatch.delenv("BIGDL_RESIDUAL_ADD", raising=False)
    else:
        monkeypatch.setenv("BIGDL_RESIDUAL_ADD", knob)
    x, y = _pair((2, 3, 4, 4))
    layer = CAddTable()
    assert torch.equal(layer((x, y)), x + y)
    assert len(calls) == (knob == "pallas")
    assert torch.equal(layer((x, y, x)), x + y + x)    # 3 operands: plain
    assert len(calls) == (knob == "pallas")
    monkeypatch.setenv("BIGDL_RESIDUAL_ADD", "pallas")
    layer((x, y))
    assert len(calls) == (knob == "pallas") + 1
