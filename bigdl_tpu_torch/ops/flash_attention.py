"""Attention kernels B2 (flash forward) and B3 / B3-int8 (paged decode over
float / int8 pools), with their plain PyTorch versions.

Counterpart of ``bigdl_tpu/ops/flash_attention.py``. Each kernel is CUDA
C++ written for Hopper (``bigdl_tpu_torch/csrc/*.cu``, built and loaded by
:mod:`~bigdl_tpu_torch.ops.cuda_lib`); beside it sits its plain version,
the JAX package's XLA math written in PyTorch. A wrapper dispatches on the
device of the tensors it is given: a CPU tensor takes the plain version,
a CUDA tensor launches the kernel (or raises — there is no fall back), any
other device raises. Each wrapper counts its kernel launches in
``<wrapper>.launches``, a plain integer incremented where the kernel is
launched and nowhere else; ``paged_flash_attention.launches`` counts B3
(float pools) and ``paged_flash_attention.int8_launches`` B3-int8.

Shapes follow (batch, heads, seq, head_dim), as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from bigdl_tpu_torch.core.threefry import Key, dropout
from bigdl_tpu_torch.ops import cuda_lib

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 3}
# (q dtype, K/V dtype) pairs the kernels take: one dtype, or bf16 K/V
# under fp32 activations (the engine with a bf16 KV cache)
_DTYPE_PAIRS = {(torch.float32, torch.float32),
                (torch.bfloat16, torch.bfloat16),
                (torch.float32, torch.bfloat16)}
MAX_HEAD_DIM = 256
# B2 cuts the key lane into splits of SPLIT_TILE-key tiles, run by blocks
# of their own and merged in split order; at most MAX_SPLITS partials per
# query row
SPLIT_TILE = 32
MAX_SPLITS = 8


# ------------------------------------------------------------ plain ----


def plain_attention(q, k, v, bias=None, sm_scale: Optional[float] = None,
                    causal: bool = False, dropout_rate: float = 0.0,
                    dropout_key: Optional[Key] = None) -> torch.Tensor:
    """The plain version of B2: ``_xla_attention`` in PyTorch. Scores and
    softmax in fp32; the causal mask is END-aligned (query row i sees key
    cols j <= i + Sk - Sq), masked scores set to -1e30. With
    ``dropout_rate`` > 0 the probabilities go through the JAX package's
    dropout under ``dropout_key``, a mask at their (B, H, Sq, Sk) shape."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        qlen, klen = s.shape[-2], s.shape[-1]
        mask = torch.ones(qlen, klen, dtype=torch.bool,
                          device=s.device).tril(klen - qlen)
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        if dropout_key is None:
            raise ValueError("attention dropout needs dropout_key")
        p = dropout(p, dropout_rate, dropout_key)
    return torch.matmul(p.to(v.dtype), v)


def gather_kv_lanes(pages: torch.Tensor, page_map: torch.Tensor) -> torch.Tensor:
    """(num_pages, H, page_size, D) pool + (..., ppn) int page map ->
    logical lanes (..., H, ppn * page_size, D). Exact data movement."""
    h, ps, d = pages.shape[1:]
    lanes = pages[page_map.long()]                 # (..., ppn, H, ps, D)
    lanes = lanes.movedim(-3, -4)                  # (..., H, ppn, ps, D)
    return lanes.reshape(page_map.shape[:-1] + (h, -1, d))


def gather_scale_lanes(scales: torch.Tensor,
                       page_map: torch.Tensor) -> torch.Tensor:
    """(num_pages, page_size) per-token scale pool + (..., ppn) page map ->
    logical scale lanes (..., ppn * page_size), row-aligned with
    :func:`gather_kv_lanes`. Exact data movement."""
    lanes = scales[page_map.long()]                # (..., ppn, ps)
    return lanes.reshape(page_map.shape[:-1] + (-1,))


def paged_attention_reference(q, k_pages, v_pages, page_map, positions,
                              sm_scale: Optional[float] = None,
                              k_scales=None, v_scales=None) -> torch.Tensor:
    """The plain version of B3 and B3-int8 (``paged_attention_reference``
    in the JAX package): gather each slot's logical lanes through its page
    map, mask cols > positions[s] with a -1e9 bias, attend. q (S,H,D) ->
    (S,H,D). Int8 pools pass their (num_pages, page_size) fp32 scale
    pools: the lanes are dequantized after the gather, and the output is
    fp32."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    lk = gather_kv_lanes(k_pages, page_map)        # (S, H, L, D)
    lv = gather_kv_lanes(v_pages, page_map)
    if k_scales is not None:
        from bigdl_tpu_torch.nn.int8 import dequantize_lanes

        lk = dequantize_lanes(lk, gather_scale_lanes(k_scales, page_map))
        lv = dequantize_lanes(lv, gather_scale_lanes(v_scales, page_map))
    cols = torch.arange(lk.shape[2], device=q.device)
    validity = torch.where(cols[None, :] <= positions.long()[:, None],
                           0.0, -1e9)[:, None, None, :]       # (S,1,1,L)
    out = plain_attention(q[:, :, None, :], lk, lv, validity, scale, False)
    return out[:, :, 0, :]


# ----------------------------------------------------------- checks ----


def _device_kind(*tensors) -> str:
    kinds = {t.device.type for t in tensors if t is not None}
    if len(kinds) != 1:
        raise ValueError(f"tensors on mixed devices: {sorted(kinds)}")
    kind = kinds.pop()
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"attention kernels run on cpu or cuda tensors, "
                         f"got {kind}")
    return kind


def _dtype_codes(q, kv, what):
    """The kernels' (q, K/V) dtype codes; raises on any other pairing."""
    if (q.dtype, kv.dtype) not in _DTYPE_PAIRS:
        raise TypeError(f"{what} kernel takes q/K/V dtypes float32/float32, "
                        f"bfloat16/bfloat16 or float32/bfloat16, got "
                        f"{q.dtype}/{kv.dtype}")
    return _DTYPE_CODES[q.dtype], _DTYPE_CODES[kv.dtype]


def _check_contiguous(**tensors):
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# ------------------------------------------------------------- B2 ----


class SplitPlan(NamedTuple):
    """How B2 cuts the key lane: ``n_splits`` splits of ``span`` keys (the
    last one ragged), and the fp32 scratch of partial rows that the
    wrapper allocates when there is more than one split (None
    otherwise): (B*H, n_splits, Sq, D + 2) — each row's unnormalised
    accumulator, running max and running sum."""
    span: int
    n_splits: int
    scratch: Optional[Tuple[int, int, int, int]]


def split_plan(q_shape, sk: int) -> SplitPlan:
    """B2's split plan for q of ``q_shape`` (B, H, Sq, D) against ``sk``
    keys. The span is a function of Sk alone — never of Sq, B or H, nor of
    the dtypes, which the kernel handles alike — so a query row's bits do
    not depend on how many rows share its chunk (chunked prefill equals
    whole prefill). Up to ``SPLIT_TILE * MAX_SPLITS`` keys it is one tile,
    which spreads a 256-key lane over 8 blocks per head; past that it grows
    in whole tiles so that a row never has more than MAX_SPLITS
    partials."""
    b, h, sq, d = q_shape
    span = SPLIT_TILE * -(-sk // (SPLIT_TILE * MAX_SPLITS))
    n_splits = -(-sk // span)
    scratch = (b * h, n_splits, sq, d + 2) if n_splits > 1 else None
    return SplitPlan(span, n_splits, scratch)


def _launch_flash(q, k, v, bias, scale: float, causal: bool) -> torch.Tensor:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, H, S, D), got {tuple(t.shape)}")
    if v.dtype != k.dtype:
        raise TypeError(f"k and v dtypes differ: {k.dtype} vs {v.dtype}")
    codes = _dtype_codes(q, k, "flash_attention")
    _check_contiguous(q=q, k=k, v=v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} outside [1, {MAX_HEAD_DIM}]")
    if q.device != k.device or q.device != v.device:
        raise ValueError("q, k, v must be on one device")
    strides = (0, 0, 0, 0)
    bias_ptr = None
    if bias is not None:
        if bias.device != q.device:
            raise ValueError("bias must be on q's device")
        # a broadcast VIEW: zero strides on broadcast dims, nothing
        # materialised at (B, H, Sq, Sk)
        bias = bias.to(torch.float32).expand(b, h, sq, sk)
        strides = bias.stride()
        bias_ptr = bias.data_ptr()
    plan = split_plan(q.shape, sk)
    out = torch.empty_like(q)
    partials = None
    if plan.scratch is not None:
        partials = torch.empty(plan.scratch, dtype=torch.float32,
                               device=q.device)
    with torch.cuda.device(q.device):
        err = cuda_lib.entry("flash_attention")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, *strides,
            out.data_ptr(), None if partials is None else partials.data_ptr(),
            b, h, sq, sk, d, plan.span, plan.n_splits, float(scale),
            int(causal), *codes, torch.cuda.current_stream().cuda_stream)
        flash_attention.launches += 1
    cuda_lib.check(err, "flash_attention")
    return out


class _FlashAttention(torch.autograd.Function):
    """B2 with a gradient. Forward: the kernel for CUDA tensors, its plain
    version for CPU tensors. Backward: autograd through a recompute of the
    plain version, as the JAX package's ``_vjp_bwd`` differentiates the XLA
    recompute rather than a Pallas backward; ``bias`` gets its gradient
    too, in its own (broadcast) shape."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, causal):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale, ctx.causal = scale, causal
        if q.device.type == "cpu":
            return plain_attention(q, k, v, bias, scale, causal)
        return _launch_flash(q, k, v, bias, scale, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip((q, k, v, bias),
                                         ctx.needs_input_grad[:4])]
            out = plain_attention(*leaves, ctx.scale, ctx.causal).to(g.dtype)
            wanted = [t for t in leaves if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g) if wanted
                         else ())
        return tuple(next(grads) if t is not None and t.requires_grad
                     else None for t in leaves) + (None, None)


def flash_attention(q, k, v, bias=None, sm_scale: Optional[float] = None,
                    causal: bool = False) -> torch.Tensor:
    """Fused online-softmax attention (kernel B2), differentiable in q, k,
    v and bias. q (B,H,Sq,D), k/v (B,H,Sk,D), optional additive bias
    broadcastable to (B,H,Sq,Sk). CPU tensors take :func:`plain_attention`;
    CUDA tensors launch the kernel, which takes float32 or bfloat16 (bf16
    K/V may sit under fp32 q), any Sq/Sk, D <= 256 and contiguous q/k/v,
    and returns q's dtype (anything else raises)."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    _device_kind(q, k, v, bias)
    return _FlashAttention.apply(q, k, v, bias, scale, causal)


flash_attention.launches = 0


# ------------------------------------------------------------- B3 ----


def _check_scales(k_pages, k_scales, v_scales):
    """Int8 pools need both (num_pages, page_size) fp32 scale pools; float
    pools take none. Returns the scale pools' data pointers (or Nones)."""
    int8_kv = k_pages.dtype == torch.int8
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales, or neither")
    if int8_kv != (k_scales is not None):
        raise ValueError("int8 pools need k_scales/v_scales, float pools "
                         f"take none (pools {k_pages.dtype}, scales "
                         f"{'given' if k_scales is not None else 'missing'})")
    if not int8_kv:
        return None, None
    want = (k_pages.shape[0], k_pages.shape[2])
    for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be (num_pages, page_size) = "
                             f"{want}, got {tuple(t.shape)}")
        if t.device != k_pages.device:
            raise ValueError(f"{name} must be on the pools' device")
    _check_contiguous(k_scales=k_scales, v_scales=v_scales)
    return k_scales.data_ptr(), v_scales.data_ptr()


def _launch_paged(q, k_pages, v_pages, page_map, positions, scale: float,
                  k_scales=None, v_scales=None) -> torch.Tensor:
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"q must be (S, H, D) and pools (P, H, page_size, "
                         f"D); got {tuple(q.shape)}, {tuple(k_pages.shape)}")
    n_slots, heads, d = q.shape
    _, _, page_size, _ = k_pages.shape
    if k_pages.shape[1] != heads or k_pages.shape[3] != d \
            or v_pages.shape != k_pages.shape:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} outside [1, {MAX_HEAD_DIM}]")
    if v_pages.dtype != k_pages.dtype:
        raise TypeError(f"pool dtypes differ: {k_pages.dtype} vs "
                        f"{v_pages.dtype}")
    if k_pages.dtype == torch.int8:
        if q.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"paged attention over int8 pools takes a "
                            f"float32 or bfloat16 q, got {q.dtype}")
        codes = _DTYPE_CODES[q.dtype], _DTYPE_CODES[torch.int8]
    else:
        codes = _dtype_codes(q, k_pages, "paged attention")
    scale_ptrs = _check_scales(k_pages, k_scales, v_scales)
    _check_contiguous(q=q, k_pages=k_pages, v_pages=v_pages,
                      page_map=page_map, positions=positions)
    if page_map.dim() != 2 or page_map.shape[0] != n_slots:
        raise ValueError(f"page_map must be (S, ppn), got "
                         f"{tuple(page_map.shape)}")
    if positions.shape != (n_slots,):
        raise ValueError(f"positions must be (S,), got "
                         f"{tuple(positions.shape)}")
    for name, t in (("page_map", page_map), ("positions", positions)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if len({t.device for t in (q, k_pages, v_pages, page_map,
                               positions)}) != 1:
        raise ValueError("paged attention inputs must be on one device")
    # B3-int8 outputs fp32 whatever q's dtype (the TPU kernel's out spec)
    out = torch.empty_like(q, dtype=torch.float32
                           if k_pages.dtype == torch.int8 else q.dtype)
    with torch.cuda.device(q.device):
        err = cuda_lib.entry("paged_attention")(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            *scale_ptrs, page_map.data_ptr(), positions.data_ptr(),
            out.data_ptr(),
            n_slots, heads, page_size, page_map.shape[1], d, float(scale),
            *codes, torch.cuda.current_stream().cuda_stream)
        if k_pages.dtype == torch.int8:
            paged_flash_attention.int8_launches += 1
        else:
            paged_flash_attention.launches += 1
    cuda_lib.check(err, "paged_attention")
    return out


def paged_flash_attention(q, k_pages, v_pages, page_map, positions,
                          sm_scale: Optional[float] = None,
                          k_scales=None, v_scales=None) -> torch.Tensor:
    """Paged decode attention: kernel B3 over float pools, B3-int8 over
    int8 pools. q (S,H,D); pools (num_pages,H,page_size,D); ``page_map``
    (S,ppn) int32 with ids in [0, num_pages); ``positions`` (S,) int32 —
    key col j of slot s is visible iff j <= positions[s]. Int8 pools pass
    their per-token fp32 scale pools ``k_scales``/``v_scales``
    (num_pages, page_size). CPU tensors take
    :func:`paged_attention_reference`; CUDA tensors launch the kernel
    (float32 or bfloat16 pools under q float32 or the pools' dtype,
    output in q's dtype; int8 pools under q float32 or bfloat16, output
    float32)."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    kind = _device_kind(q, k_pages, v_pages, page_map, positions, k_scales,
                        v_scales)
    if kind == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, page_map,
                                         positions, scale, k_scales,
                                         v_scales)
    return _launch_paged(q, k_pages, v_pages, page_map, positions, scale,
                         k_scales, v_scales)


paged_flash_attention.launches = 0
paged_flash_attention.int8_launches = 0
