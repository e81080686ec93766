"""Functional int8 building blocks of the quantized serving tier
(``bigdl_tpu/nn/int8.py``).

Numerics, as in the JAX package (the tests hold each function bitwise
against it on the same inputs):

- **weights**: symmetric per-output-channel int8,
  ``scale = max(max|w|, EPS) / 127`` per row of the (out, in) weight,
  ``w_q = clip(round(w / scale), -127, 127)``; ``torch.round`` rounds
  half to even, as ``jnp.round`` does;
- **activations**: symmetric int8 with one scale PER TOKEN (row),
  computed inside the step; a batch-wide scale would make one request's
  logits depend on its neighbours in the decode batch;
- **operation order**: the JAX functions' own, as written and run
  eagerly: ``/ 127`` is a true division on every device (a CUDA tensor
  divided by a Python scalar is multiplied by the reciprocal instead, so
  the port divides by a tensor), and the bias is added after the
  rescale. Inside a jitted step XLA's CPU backend multiplies by
  ``float32(1/127)`` and contracts ``acc * scale + bias`` into one FMA,
  so the JAX engine's activations can differ from these by an ulp;
- **matmul**: an exact ``s8 x s8 -> s32`` product (:func:`int8_accum`);
  the fp32 rescale ``acc * (x_scale * w_scale)`` is the only rounding;
- **KV rows**: one fp32 scale per written K (and V) row, shared across
  heads, so a recycled page carries no scale state and chunked prefill
  equals whole prefill bitwise.

The JAX package leaves the integer product to XLA's ``dot_general``,
outside any Pallas kernel; the port leaves it to ``torch._int_mm``
(cuBLASLt's int8 GEMM on the card, an integer GEMM on the CPU).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# floor for every scale: an all-zero row quantizes to 0 and dequantizes
# to 0 without a division guard
EPS = 1e-8
# torch._int_mm on CUDA refuses M <= 16 and needs K and N to be multiples
# of 8; token rows are padded up to a multiple of this above 16
_INT_MM_ROWS = 8
_INT_MM_MIN_ROWS = 17


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    """``max(absmax, EPS) / 127`` as a true division on every device."""
    return torch.clamp(absmax, min=EPS) / torch.full_like(absmax, 127.0)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) float weight -> (int8 weight, (out,) fp32 scales),
    symmetric per output channel."""
    w = w.float()
    scale = _scale(w.abs().amax(dim=1))
    wq = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
    return wq.to(torch.int8), scale


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-token int8: (M, K) float -> (int8 x, (M,)
    fp32 scales), one scale per row."""
    x = x.float()
    scale = _scale(x.abs().amax(dim=-1))
    xq = torch.clamp(torch.round(x / scale[:, None]), -127, 127)
    return xq.to(torch.int8), scale


def int8_accum(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(M, K) s8 x (N, K) s8 -> (M, N) s32, contracting K, exactly.

    ``torch._int_mm`` takes ``wq.t()`` of the contiguous (N, K) weight.
    The rows are padded with zero rows to a multiple of 8 above 16 (what
    cuBLASLt's int8 path takes on the card) and the padding is sliced
    off: a zero row changes no other row's integer sums. On a CUDA tensor
    K and N must be multiples of 8, or this raises; no other route
    computes the product."""
    m, k = xq.shape
    n = wq.shape[0]
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8_accum takes int8 operands, got {xq.dtype} "
                        f"and {wq.dtype}")
    if wq.shape[1] != k:
        raise ValueError(f"contracting dims differ: x {tuple(xq.shape)}, "
                         f"w {tuple(wq.shape)}")
    if xq.device.type == "cuda" and (k % 8 or n % 8):
        raise ValueError(f"the card's int8 GEMM needs K and N to be "
                         f"multiples of 8, got K={k}, N={n}")
    rows = max(m, _INT_MM_MIN_ROWS)
    rows = -(-rows // _INT_MM_ROWS) * _INT_MM_ROWS
    if rows != m:
        xq = torch.cat([xq, xq.new_zeros(rows - m, k)])
    return torch._int_mm(xq.contiguous(), wq.t())[:m]


def int8_linear(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantized GEMM for an (out, in) int8 weight: per-token activation
    quantization, ``s8 x s8 -> s32`` product, fp32 (row scale x channel
    scale) rescale, fp32 bias. ``x`` is (..., in); returns (..., out) in
    ``x.dtype``."""
    shape = x.shape
    xq, x_scale = quantize_rows(x.reshape(-1, shape[-1]))
    acc = int8_accum(xq, wq)
    y = acc.float() * (x_scale[:, None] * w_scale[None, :].float())
    if bias is not None:
        y = y + bias.float()
    return y.reshape(shape[:-1] + (wq.shape[0],)).to(x.dtype)


# ------------------------------------------------------------- KV rows ----


def quantize_kv_rows(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token KV quantization: ``rows`` (..., H, D) float -> (int8
    rows, (...,) fp32 scales), one scale per row across all heads."""
    rows = rows.float()
    scale = _scale(rows.abs().amax(dim=(-2, -1)))
    q = torch.clamp(torch.round(rows / scale[..., None, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_lanes(lanes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 lanes (..., H, L, D) x per-row scales (..., L) -> fp32 lanes:
    the inverse of :func:`quantize_kv_rows` after a page gather."""
    return lanes.float() * scales[..., None, :, None].float()
