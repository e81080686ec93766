"""Scaled-dot-product attention dispatch + attention-bias helpers
(``bigdl_tpu/ops/attention.py``).

Where the JAX package picks its Pallas kernels by platform, the port
picks by the tensors' device: CUDA tensors go through the hand-written
kernels (B2 :func:`~bigdl_tpu_torch.ops.flash_attention.flash_attention`,
B3 and B3-int8
:func:`~bigdl_tpu_torch.ops.flash_attention.paged_flash_attention`),
CPU tensors through their plain versions. ``use_flash=False`` /
``use_kernel=False`` stay the explicit way to ask for the plain version
on any device.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.core.threefry import Key
from bigdl_tpu_torch.ops import flash_attention as _fa

_NEG = -1e9


def attention_bias_from_padding(padding_mask: torch.Tensor) -> torch.Tensor:
    """(B, S) 1-where-padding -> additive bias (B, 1, 1, S)."""
    return (padding_mask.float() * _NEG)[:, None, None, :]


def causal_bias(length: int, device=None) -> torch.Tensor:
    """(1, 1, S, S) additive lower-triangle bias."""
    mask = torch.ones(length, length, device=device).tril()
    return ((1.0 - mask) * _NEG)[None, None, :, :]


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_map: torch.Tensor,
                    positions: torch.Tensor, *,
                    sm_scale: Optional[float] = None,
                    use_kernel: Optional[bool] = None,
                    k_scales: Optional[torch.Tensor] = None,
                    v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode-step attention over a paged KV cache. ``q`` (S, H, D);
    pools (num_pages, H, page_size, D); ``page_map`` (S, ppn) int32;
    ``positions`` (S,) int32 — key col j valid iff j <= positions[s].
    Int8 pools pass their per-token fp32 scale pools
    (``k_scales``/``v_scales``, (num_pages, page_size)); both paths
    dequantize on gather. ``use_kernel=None``/``True``: kernel B3 (B3-int8
    for int8 pools) for CUDA tensors, its plain version for CPU tensors;
    ``False``: the plain version everywhere."""
    if use_kernel is False:
        return _fa.paged_attention_reference(q, k_pages, v_pages, page_map,
                                             positions, sm_scale, k_scales,
                                             v_scales)
    return _fa.paged_flash_attention(q, k_pages, v_pages, page_map,
                                     positions, sm_scale, k_scales, v_scales)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None, *,
                          causal: bool = False,
                          sm_scale: Optional[float] = None,
                          dropout_rate: float = 0.0,
                          dropout_key: Optional[Key] = None,
                          use_flash: Optional[bool] = None) -> torch.Tensor:
    """Attention over (B, H, S, D) tensors. ``use_flash=None``/``True``:
    kernel B2 for CUDA tensors (any sequence lengths — the kernel masks
    ragged edges itself), its plain version for CPU tensors; ``False``:
    the plain version everywhere. Attention dropout (``dropout_rate`` > 0,
    training only, under ``dropout_key``) takes the plain version on every
    device, as the JAX package sends it to XLA: the mask sits inside the
    probabilities, which the fused kernel never holds."""
    if use_flash is False or dropout_rate > 0.0:
        return _fa.plain_attention(q, k, v, bias, sm_scale, causal,
                                   dropout_rate, dropout_key)
    return _fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               bias, sm_scale, causal)
