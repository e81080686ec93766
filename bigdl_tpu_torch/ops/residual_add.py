"""Residual add, kernel B1, with its plain PyTorch version.

Counterpart of ``bigdl_tpu/ops/pallas_add.py``: the exact two-operand sum
``x + y`` of same-shape, same-dtype floating tensors, through a kernel
written by hand for Hopper (``csrc/residual_add.cu``) where the inputs
qualify, and a plain ``x + y`` everywhere else. The Pallas kernel tiled a
``(rows, H*W)`` view into row blocks of at most 64 that divide the row
count (a VMEM budget) and fell back to the plain add when no block larger
than one row divided it; the CUDA kernel gives each 16-byte vector of the
flat element range its own thread (a one-shot grid, as ``torch.add``
launches) with no divisibility condition, so that fall back is gone.

Dispatch (``_supported`` in the JAX package, with "CUDA tensor" in place
of "running on a TPU"): both tensors on a CUDA device, same shape, same
dtype among fp32/bf16/fp16, at least 2 dims, at least 2**20 elements.
The kernel adds the flat element range of the operands' memory, so two
dense tensors (no gaps, no overlaps) with equal strides — contiguous,
``channels_last``, or the NHWC activations of an NHWC ResNet — launch as
they are, into an output of their layout (``torch.empty_like``); only
operands whose layouts differ, or that have gaps, are first copied to
contiguous ones. Everything else is a plain
``x + y`` with PyTorch's own autograd, outside the autograd Function:
a broadcast or mixed-dtype add needs the plain add's gradients, not
``(g, g)``. A CPU tensor takes the plain add; a CUDA tensor that
qualifies launches the kernel or raises — a kernel that fails to build or
launch never gives way to the plain add. ``residual_add.launches``
counts the kernel's launches.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.ops import cuda_lib

MIN_ELEMENTS = 1 << 20   # below this a separate kernel does not pay
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def residual_add_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The plain version of B1."""
    return x + y


def kernel_eligible(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Whether ``x + y`` goes through kernel B1 when the tensors lie on a
    CUDA device (the device is checked apart)."""
    return (x.shape == y.shape and x.dtype == y.dtype
            and x.dtype in _DTYPE_CODES and x.dim() >= 2
            and x.numel() >= MIN_ELEMENTS)


def dense(t: torch.Tensor) -> bool:
    """Whether ``t``'s elements fill ``numel`` consecutive slots of its
    storage from ``data_ptr()`` on (any order of the dims)."""
    expect = 1
    for size, stride in sorted(zip(t.shape, t.stride()),
                               key=lambda d: d[1]):
        if size == 1:
            continue
        if stride != expect:
            return False
        expect *= size
    return True


def same_layout(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Whether the kernel can add ``x`` and ``y`` where they lie: both
    dense, with equal strides."""
    return x.stride() == y.stride() and dense(x) and dense(y)


def _launch(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    if x.device != y.device:
        raise ValueError(f"x on {x.device}, y on {y.device}")
    if not same_layout(x, y):
        x, y = x.contiguous(), y.contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = cuda_lib.entry("residual_add")(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(),
            _DTYPE_CODES[x.dtype], torch.cuda.current_stream().cuda_stream)
        residual_add.launches += 1
    cuda_lib.check(err, "residual_add")
    return out


class _ResidualAdd(torch.autograd.Function):
    """Forward: kernel B1. Backward: ``(g, g)``, the add's transpose for
    same-shape, same-dtype operands (the JAX package's ``_bwd``)."""

    @staticmethod
    def forward(ctx, x, y):
        return _launch(x, y)

    @staticmethod
    def backward(ctx, g):
        return g, g


def residual_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x + y``: kernel B1 for CUDA tensors that qualify (see the module
    docstring), the plain add for everything else."""
    if x.is_cuda and y.is_cuda and kernel_eligible(x, y):
        return _ResidualAdd.apply(x, y)
    return residual_add_plain(x, y)


residual_add.launches = 0
