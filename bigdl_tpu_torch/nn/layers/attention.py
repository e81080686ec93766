"""Transformer tier (``bigdl_tpu/nn/layers/attention.py``): multi-head
self- and cross-attention, FFN, pre-norm transformer layer, and the
``Transformer`` in its two modes — the decoder-only language model, with
its paged KV-cache step API, and the encoder-decoder translation model.

Child modules carry the JAX package's module-path names, so a parameter's
dotted name here (``decoder_0.self_attention.inner.q_layer.weight``) is
its path in the JAX ``params`` tree. A model rewritten by
``nn.quantized.quantize_for_serving`` runs its GEMMs and its lm head in
int8; int8 KV pools carry per-token fp32 scale pools beside the pages
(quantize on scatter, dequantize on gather, ``nn.int8``). Two
differences from the JAX code:

- the paged KV pools are updated IN PLACE (``index_put``) instead of
  functionally: the port keeps one pool per layer for the engine's
  lifetime and never copies it, which is the memory the JAX package
  recovers by donating the cache to every jitted call;
- the step API has the language model's two caches. Paged:
  ``init_paged_cache``, ``prefill_paged`` (prompt chunks),
  ``decode_step_paged`` (one token per slot) and ``decode_verify_paged``
  (the speculative verify step: W candidate rows per slot, which takes
  no external bias), with float or int8 pools. ``Attention`` in its
  paged decode arm composes an external ``(S, 1, 1, L)`` bias with the
  validity mask over the gathered lanes (B2 on a card; the plain paged
  attention's bits on the CPU for an all-zero bias). Dense (the slot
  table, float lanes): ``init_cache``, ``prefill`` (one padded prompt
  into a slot's lane) and ``decode_step``; the lanes, like the pools,
  update in place, and every dense call attends through B2 on a card
  under the -1e9 validity bias (column 0 is always valid, so B2's
  zero-sum row is never reached there).

In training mode the forward takes a threefry key (``model(ids,
rng=key)``); every dropout draws its mask from it under its JAX module
path and the forward's draw count, so the masks are the JAX package's
(``nn.module.RngContext``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from bigdl_tpu_torch.core.device import DeviceLike, resolve_device
from bigdl_tpu_torch.nn.init import RandomNormal, default_generator
from bigdl_tpu_torch.nn.int8 import (
    dequantize_lanes,
    int8_linear,
    quantize_kv_rows,
)
from bigdl_tpu_torch.nn.layers.dropout import Dropout
from bigdl_tpu_torch.nn.layers.linear import Linear
from bigdl_tpu_torch.nn.layers.norm import LayerNormalization
from bigdl_tpu_torch.nn.module import RngContext, draw_key
from bigdl_tpu_torch.ops.attention import (
    attention_bias_from_padding,
    dot_product_attention,
    paged_attention,
)
from bigdl_tpu_torch.ops.flash_attention import (
    gather_kv_lanes,
    gather_scale_lanes,
)

# {layer: (K, V)} for float pools, {layer: (K, V, K_scale, V_scale)} for
# int8 pools
Cache = Dict[str, Tuple[torch.Tensor, ...]]


def position_encoding(length: int, hidden_size: int,
                      dtype: torch.dtype = torch.float32,
                      device: DeviceLike = "cpu") -> torch.Tensor:
    """Sinusoidal positions (reference ``TransformerOperation.getPositionEncode``)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    n_timescales = hidden_size // 2
    log_inc = math.log(10000.0) / max(n_timescales - 1, 1)
    inv = torch.exp(torch.arange(n_timescales, dtype=torch.float32,
                                 device=device) * -log_inc)
    scaled = pos * inv[None, :]
    enc = torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)
    if hidden_size % 2:
        enc = torch.nn.functional.pad(enc, (0, 1))
    return enc.to(dtype)


class Attention(nn.Module):
    """Multi-head attention with bias-free q/k/v/output projections
    (reference ``Attention.scala:35``): self-attention over ``x``, or
    cross-attention over ``(x, y)`` (queries from ``x``, keys and values
    from ``y``)."""

    def __init__(self, hidden_size: int, num_heads: int,
                 attention_dropout: float = 0.0, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} % num_heads "
                             f"{num_heads} != 0")
        gen = default_generator(generator)
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.attention_dropout = attention_dropout
        init = RandomNormal(0.0, hidden_size ** -0.5)
        kw = dict(with_bias=False, weight_init=init, device=device,
                  generator=gen)
        self.q_layer = Linear(hidden_size, hidden_size, **kw)
        self.k_layer = Linear(hidden_size, hidden_size, **kw)
        self.v_layer = Linear(hidden_size, hidden_size, **kw)
        self.output_layer = Linear(hidden_size, hidden_size, **kw)

    def _split_heads(self, t):
        b, s, _ = t.shape
        d = self.hidden_size // self.num_heads
        return t.reshape(b, s, self.num_heads, d).transpose(1, 2)

    def _join_heads(self, t):
        b, h, s, d = t.shape
        return t.transpose(1, 2).reshape(b, s, h * d)

    def forward(self, x, bias: Optional[torch.Tensor] = None,
                causal: bool = False, cache=None, cache_index=None,
                paged=None, write_len: Optional[int] = None, rng=None):
        x, y = x if isinstance(x, (tuple, list)) else (x, x)
        q = self._split_heads(self.q_layer(x))
        k = self._split_heads(self.k_layer(y))
        v = self._split_heads(self.v_layer(y))
        if paged is None:
            if cache is not None:
                k, v, validity = _write_lanes(cache, cache_index, k, v)
                bias = validity if bias is None else bias + validity
                causal = False
            drop = self.attention_dropout if self.training else 0.0
            key = (draw_key(RngContext.of(rng, self), self) if drop > 0.0
                   else None)
            out = dot_product_attention(q, k, v, bias, causal=causal,
                                        dropout_rate=drop, dropout_key=key)
            out = self.output_layer(self._join_heads(out))
            return out if cache is None else (out, cache)

        # Block-table KV cache: pools "k"/"v" (num_pages, H, page_size, D)
        # and "map", int32 physical-page ids. New K/V rows are scattered
        # into the pools in place, then attention reads them back. Int8
        # pools come with "k_scale"/"v_scale" (num_pages, page_size):
        # the scatter quantizes each new row (one fp32 scale per row,
        # shared across heads), the gather dequantizes.
        pk, pv = paged["k"], paged["v"]
        pks, pvs = paged.get("k_scale"), paged.get("v_scale")
        int8_kv = pks is not None
        page_size = pk.shape[2]
        per_slot = (isinstance(cache_index, torch.Tensor)
                    and cache_index.dim() == 1)
        if per_slot and q.shape[2] > 1:
            # verify (speculative decoding): W candidate rows per slot at
            # positions cache_index .. cache_index+W-1; map is (S, ppn).
            # Rows past the lane end (a slot running out its budget
            # mid-verify) go to the trash page. The rows are scattered,
            # then every slot's lane gathered, and B2 attends W rows
            # against it under the validity bias. Rejected candidates'
            # rows stay: they sit past the slot's rewound position,
            # masked until a later verify overwrites them.
            if bias is not None:
                raise ValueError(
                    "paged verify attention takes no external bias")
            page_map = paged["map"].long()
            ppn = page_map.shape[1]
            pos = cache_index.long()[:, None] + torch.arange(
                q.shape[2], device=q.device)[None, :]          # (S, W)
            pg = torch.gather(page_map, 1,
                              (pos // page_size).clamp(0, ppn - 1))
            trash = paged.get("trash")
            if trash is not None:
                pg = torch.where(pos < ppn * page_size, pg,
                                 torch.full_like(pg, int(trash)))
            row = pos % page_size
            _scatter_rows(pk, pks, pg, row, k.transpose(1, 2))
            _scatter_rows(pv, pvs, pg, row, v.transpose(1, 2))
            lk = gather_kv_lanes(pk, page_map)             # (S, H, L, D)
            lv = gather_kv_lanes(pv, page_map)
            if int8_kv:
                lk = dequantize_lanes(lk, gather_scale_lanes(pks, page_map))
                lv = dequantize_lanes(lv, gather_scale_lanes(pvs, page_map))
            cols = torch.arange(lk.shape[2], device=q.device)
            validity = torch.where(cols[None, None, :] <= pos[:, :, None],
                                   0.0, -1e9)[:, None]     # (S, 1, W, L)
            out = dot_product_attention(q, lk, lv, validity)
        elif per_slot:
            # decode: one token per slot; map is (S, ppn)
            page_map = paged["map"]
            pos = cache_index.long()
            slots = torch.arange(pos.shape[0], device=pos.device)
            pg = page_map.long()[slots, pos // page_size]
            row = pos % page_size
            _scatter_rows(pk, pks, pg, row, k[:, :, 0, :])
            _scatter_rows(pv, pvs, pg, row, v[:, :, 0, :])
            if bias is not None:
                # external bias: gather the logical lanes (dequantized
                # for int8 pools) and add the caller's bias, broadcast
                # against (S, 1, 1, L), to the -1e9 validity mask. The
                # op sequence of the plain paged attention, so an
                # all-zero bias gives its bits; a CUDA tensor runs B2
                lk = gather_kv_lanes(pk, page_map)         # (S, H, L, D)
                lv = gather_kv_lanes(pv, page_map)
                if int8_kv:
                    lk = dequantize_lanes(lk,
                                          gather_scale_lanes(pks, page_map))
                    lv = dequantize_lanes(lv,
                                          gather_scale_lanes(pvs, page_map))
                cols = torch.arange(lk.shape[2], device=q.device)
                validity = torch.where(cols[None, :] <= pos[:, None], 0.0,
                                       -1e9)[:, None, None, :]  # (S,1,1,L)
                out = dot_product_attention(q, lk, lv, bias + validity)
            else:
                out3 = paged_attention(q[:, :, 0, :].contiguous(), pk, pv,
                                       page_map, cache_index,
                                       use_kernel=paged.get("use_kernel"),
                                       k_scales=pks, v_scales=pvs)
                out = out3[:, :, None, :]
        else:
            # prefill chunk: q rows are positions idx..idx+C-1 of ONE
            # sequence whose page ids are the (ppn,) "map" row. Rows past
            # `write_len` are bucket padding, routed to the "trash" page so
            # pad garbage never lands in a page another slot owns.
            pages_row = paged["map"].long()
            ppn = pages_row.shape[0]
            idx = int(cache_index) if cache_index is not None else 0
            n_chunk = q.shape[2]
            t = torch.arange(n_chunk, device=q.device)
            pos = idx + t
            valid = t < (n_chunk if write_len is None else int(write_len))
            pg = torch.where(valid,
                             pages_row[(pos // page_size).clamp(0, ppn - 1)],
                             torch.full_like(pos, int(paged["trash"])))
            row = pos % page_size
            _scatter_rows(pk, pks, pg, row, k[0].transpose(0, 1))
            _scatter_rows(pv, pvs, pg, row, v[0].transpose(0, 1))
            lk = gather_kv_lanes(pk, pages_row)            # (H, L, D)
            lv = gather_kv_lanes(pv, pages_row)
            if int8_kv:
                lk = dequantize_lanes(lk, gather_scale_lanes(pks, pages_row))
                lv = dequantize_lanes(lv, gather_scale_lanes(pvs, pages_row))
            lk, lv = lk[None], lv[None]                    # (1, H, L, D)
            rows = pos[:, None]
            cols = torch.arange(lk.shape[2], device=q.device)[None, :]
            validity = torch.where(cols <= rows, 0.0, -1e9)[None, None]
            out = dot_product_attention(
                q, lk, lv, validity if bias is None else bias + validity)
        out = self.output_layer(self._join_heads(out))
        return out, ((pk, pv, pks, pvs) if int8_kv else (pk, pv))


def _write_lanes(cache, cache_index, k, v):
    """The dense slot-table cache's write: K/V rows (B, H, Sq, D) into the
    lanes ``cache`` = (K, V), each (B, H, L, D), in place, at the row
    offsets ``cache_index`` (a scalar, or (B,) per-slot offsets for
    continuous batching); a write that would run past the lane end starts
    where it fits, as ``dynamic_update_slice`` clamps. Returns the lanes
    and the validity bias: key col j is valid for query row i iff
    ``j <= cache_index + i``, 0 for valid and -1e9 otherwise, (1, 1, Sq,
    L) or (B, 1, Sq, L)."""
    ck, cv = cache
    sq, lane = k.shape[2], ck.shape[2]
    t = torch.arange(sq, device=k.device)
    cols = torch.arange(lane, device=k.device)
    if isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1:
        idx = cache_index.long()
        at = idx.clamp(0, lane - sq)[:, None] + t[None, :]      # (B, Sq)
        slots = torch.arange(ck.shape[0], device=k.device)[:, None]
        ck[slots, :, at] = k.transpose(1, 2).to(ck.dtype)
        cv[slots, :, at] = v.transpose(1, 2).to(cv.dtype)
        rows = idx[:, None] + t[None, :]
        validity = torch.where(cols[None, None, :] <= rows[:, :, None],
                               0.0, -1e9)[:, None]              # (B,1,Sq,L)
    else:
        idx = 0 if cache_index is None else int(cache_index)
        at = min(max(idx, 0), lane - sq)
        ck[:, :, at:at + sq] = k.to(ck.dtype)
        cv[:, :, at:at + sq] = v.to(cv.dtype)
        rows = idx + t[:, None]
        validity = torch.where(cols[None, :] <= rows, 0.0,
                               -1e9)[None, None]                # (1,1,Sq,L)
    return ck, cv, validity


def _scatter_rows(pool, scales, pg, row, rows):
    """Write K or V ``rows`` (N, H, D) into ``pool`` at (page ``pg``, row
    ``row``) in place; for an int8 pool, quantize them and write their
    scales into ``scales`` (num_pages, page_size) too."""
    if scales is None:
        pool[pg, :, row] = rows.to(pool.dtype)
        return
    rq, rs = quantize_kv_rows(rows)
    pool[pg, :, row] = rq
    scales[pg, row] = rs


class FeedForwardNetwork(nn.Module):
    """hidden -> filter (ReLU, dropout) -> hidden
    (reference ``FeedForwardNetwork.scala:32``)."""

    def __init__(self, hidden_size: int, filter_size: int,
                 relu_dropout: float = 0.0, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = default_generator(generator)
        self.filter_layer = Linear(hidden_size, filter_size, device=device,
                                   generator=gen)
        self.drop = Dropout(relu_dropout)
        self.output_layer = Linear(filter_size, hidden_size, device=device,
                                   generator=gen)

    def forward(self, x, rng=None):
        return self.output_layer(self.drop(torch.relu(self.filter_layer(x)),
                                           rng=rng))


class _SubLayer(nn.Module):
    """Pre/post-processing wrapper: LayerNorm -> fn -> dropout -> +residual.
    A ``(x, y)`` input (cross-attention) normalises and adds back ``x``
    only."""

    def __init__(self, inner: nn.Module, hidden_size: int, dropout: float, *,
                 device: DeviceLike = None):
        super().__init__()
        self.norm = LayerNormalization(hidden_size, device=device)
        self.inner = inner
        self.drop = Dropout(dropout)

    def forward(self, x, rng=None, **kw):
        if isinstance(x, (tuple, list)):
            residual, y = x
            out = self.inner((self.norm(residual), y), rng=rng, **kw)
        else:
            residual = x
            out = self.inner(self.norm(x), rng=rng, **kw)
        cache = None
        if isinstance(out, tuple):
            out, cache = out
        out = residual + self.drop(out, rng=rng).to(residual.dtype)
        return (out, cache) if cache is not None else out


class TransformerLayer(nn.Module):
    """One pre-norm block: self-attention (+ cross-attention over an
    encoder's output, in a translation decoder) + FFN."""

    def __init__(self, hidden_size: int, num_heads: int, filter_size: int,
                 attention_dropout: float = 0.0, ffn_dropout: float = 0.0,
                 residual_dropout: float = 0.0, cross_attention: bool = False,
                 *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = default_generator(generator)

        def sublayer(inner):
            return _SubLayer(inner, hidden_size, residual_dropout,
                             device=device)

        def attention():
            return Attention(hidden_size, num_heads, attention_dropout,
                             device=device, generator=gen)

        self.self_attention = sublayer(attention())
        if cross_attention:
            self.cross_attention = sublayer(attention())
        self.ffn = sublayer(FeedForwardNetwork(
            hidden_size, filter_size, ffn_dropout, device=device,
            generator=gen))

    def forward(self, x, bias=None, causal=False, encoder_output=None,
                encoder_bias=None, cache=None, cache_index=None, paged=None,
                write_len=None, rng=None):
        out = self.self_attention(x, bias=bias, causal=causal, cache=cache,
                                  cache_index=cache_index, paged=paged,
                                  write_len=write_len, rng=rng)
        new_cache = None
        if isinstance(out, tuple):
            out, new_cache = out
        if encoder_output is not None and "cross_attention" in self._modules:
            out = self.cross_attention((out, encoder_output),
                                       bias=encoder_bias, rng=rng)
        out = self.ffn(out, rng=rng)
        return (out, new_cache) if new_cache is not None else out


LANGUAGE_MODEL = "language_model"
TRANSLATION = "translation"


class Transformer(nn.Module):
    """Transformer (reference ``DL/nn/Transformer.scala:53``). The
    embedding is scaled by sqrt(hidden) and, with
    ``with_share_weights_linear``, is the output projection too; otherwise
    a bias-free ``project`` Linear is. ``embedding_dropout`` also drops
    each sublayer's output before its residual add.

    - ``transformer_type="language_model"``: decoder-only causal LM, token
      ids (B, S) -> logits (B, S, vocab).
    - ``"translation"``: encoder-decoder over ``(src_ids, tgt_ids)`` ->
      logits (B, S_tgt, vocab). Source tokens equal to ``padding_value``
      are masked out of the encoder's self-attention and of every
      decoder layer's cross-attention.

    ``forward(x, rng=key)`` in training mode draws every dropout mask
    from the threefry ``key`` as the JAX package's ``apply(..., rng=key)``
    does.

    ``device=None`` means ``"cuda"`` (raises without a card). Weights are
    drawn from ``generator`` (a seeded CPU ``torch.Generator``; default
    seed 0) and moved to ``device``, so one seed gives one set of weights
    on every device.
    """

    def __init__(self, vocab_size: int, hidden_size: int, num_heads: int,
                 filter_size: int, num_hidden_layers: int,
                 embedding_dropout: float = 0.0,
                 attention_dropout: float = 0.0, ffn_dropout: float = 0.0,
                 padding_value: int = 0,
                 with_share_weights_linear: bool = True,
                 transformer_type: str = LANGUAGE_MODEL,
                 *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if transformer_type not in (LANGUAGE_MODEL, TRANSLATION):
            raise ValueError(f"transformer_type {transformer_type!r}: "
                             f"{LANGUAGE_MODEL!r} or {TRANSLATION!r}")
        device = resolve_device(device)
        gen = default_generator(generator)
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.num_hidden_layers = num_hidden_layers
        self.padding_value = padding_value
        self.transformer_type = transformer_type
        self.embed_drop = Dropout(embedding_dropout)

        def stack(prefix, cross):
            for i in range(num_hidden_layers):
                self.add_module(f"{prefix}{i}", TransformerLayer(
                    hidden_size, num_heads, filter_size, attention_dropout,
                    ffn_dropout, residual_dropout=embedding_dropout,
                    cross_attention=cross, device=device, generator=gen))

        if transformer_type == TRANSLATION:
            stack("encoder_", False)
            self.src_norm = LayerNormalization(hidden_size, device=device)
        stack("decoder_", transformer_type == TRANSLATION)
        self.final_norm = LayerNormalization(hidden_size, device=device)
        if not with_share_weights_linear:
            self.project = Linear(hidden_size, vocab_size, with_bias=False,
                                  device=device, generator=gen)
        emb = RandomNormal(0.0, hidden_size ** -0.5)(
            gen, (vocab_size, hidden_size), vocab_size, hidden_size)
        self.embedding = nn.Parameter(emb.to(device))
        self._pe: Dict[tuple, torch.Tensor] = {}

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    def _positions(self, length: int, dtype: torch.dtype) -> torch.Tensor:
        key = (length, dtype, self.device)
        pe = self._pe.get(key)
        if pe is None:
            pe = position_encoding(length, self.hidden_size, dtype,
                                   self.device)
            self._pe[key] = pe
        return pe

    def _stack(self, prefix: str):
        return [(n, m) for n, m in self.named_children()
                if n.startswith(prefix)]

    def _decoders(self):
        return self._stack("decoder_")

    def _logits(self, h):
        if "project" in self._modules:
            return self.project(h)
        if "embedding_q" in self._parameters:
            # int8 lm head (quantize_for_serving): the float embedding
            # keeps doing the lookups
            return int8_linear(h, self.embedding_q, self.lm_scale)
        return torch.matmul(h, self.embedding.to(h.dtype).t())

    def _as_ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(ids, device=self.device).long()

    def _embed(self, ids, rng):
        x = self.embedding[ids] * (self.hidden_size ** 0.5)
        x = x + self._positions(ids.shape[1], x.dtype)[None]
        return self.embed_drop(x, rng=rng)

    def forward(self, x, rng=None) -> torch.Tensor:
        """Token ids (B, S) (language model) or ``(src_ids, tgt_ids)``
        (translation) -> logits. ``rng``: the threefry key of a training
        forward with dropout."""
        rng = RngContext.of(rng, self)
        if self.transformer_type == LANGUAGE_MODEL:
            h = self._embed(self._as_ids(x), rng)
            for _, layer in self._decoders():
                h = layer(h, causal=True, rng=rng)
            return self._logits(self.final_norm(h))
        src, tgt = (self._as_ids(ids) for ids in x)
        src_bias = attention_bias_from_padding(src == self.padding_value)
        enc = self._embed(src, rng)
        for _, layer in self._stack("encoder_"):
            enc = layer(enc, bias=src_bias, rng=rng)
        enc = self.src_norm(enc)
        dec = self._embed(tgt, rng)
        for _, layer in self._decoders():
            dec = layer(dec, causal=True, encoder_output=enc,
                        encoder_bias=src_bias, rng=rng)
        return self._logits(self.final_norm(dec))

    # ------------------------------------------------- dense decoding ----
    # The slot-table step API: one (max_slots, H, max_len, D) K/V lane
    # table per layer, a slot per sequence. The JAX package keeps it as
    # the paged engine's baseline; a lane's valid rows hold the bits a
    # page map would gather, so dense and paged steps give the same
    # logits.

    def init_cache(self, max_slots: int, max_len: int,
                   dtype: torch.dtype = torch.float32) -> Cache:
        """Zeroed per-layer K/V slot table ``{layer: (K, V)}`` with K/V of
        shape ``(max_slots, num_heads, max_len, head_dim)`` on the
        model's device. A lane is read only through the validity mask, so
        a freed slot's stale rows stay invisible until a prefill
        overwrites them."""
        if self.transformer_type != LANGUAGE_MODEL:
            raise ValueError("incremental decoding needs a language_model "
                             "transformer (decoder-only)")
        if not dtype.is_floating_point:
            raise ValueError(f"cache dtype {dtype}: the dense lanes are "
                             f"float (int8 KV lives in the paged pools)")
        shape = (max_slots, self.num_heads, max_len,
                 self.hidden_size // self.num_heads)
        return {name: (torch.zeros(shape, dtype=dtype, device=self.device),
                       torch.zeros(shape, dtype=dtype, device=self.device))
                for name, _ in self._decoders()}

    def prefill(self, cache: Cache, slot: int, tokens, length: int):
        """Run one padded prompt ``tokens`` (P,) through the decoder,
        writing its K/V into rows 0..P-1 of ``slot``'s lanes (the padding
        rows too: they stay masked until decode steps overwrite them).
        Returns ``(next-token logits (vocab,), cache)``, the logits read
        at row ``length - 1``, the last real token. The lanes update in
        place."""
        tokens = self._as_ids(tokens)
        slot, n = int(slot), tokens.shape[0]
        max_len = next(iter(cache.values()))[0].shape[2]
        x = self.embedding[tokens][None] * (self.hidden_size ** 0.5)
        x = self.embed_drop(x + self._positions(max_len, x.dtype)[:n][None])
        for name, layer in self._decoders():
            ck, cv = cache[name]
            x, _ = layer(x, cache=(ck[slot:slot + 1], cv[slot:slot + 1]),
                         cache_index=0)
        h = self.final_norm(x[:, int(length) - 1:int(length)])
        return self._logits(h)[0, 0], cache

    def decode_step(self, cache: Cache, tokens, positions):
        """One decode step for every slot: ``tokens``/``positions`` (S,)
        each slot's current token and the lane row it writes. Returns
        ``(logits (S, vocab), cache)``; rows are independent of each
        other, and the lanes update in place."""
        tokens = self._as_ids(tokens)
        positions = torch.as_tensor(positions, device=self.device).to(
            torch.int32)
        max_len = next(iter(cache.values()))[0].shape[2]
        x = self.embedding[tokens][:, None, :] * (self.hidden_size ** 0.5)
        # a finished slot of a static batch steps on at max_len: its row
        # reads the last position (a JAX gather clamps) and is discarded
        at = positions.long().clamp(0, max_len - 1)
        x = x + self._positions(max_len, x.dtype)[at][:, None, :]
        for name, layer in self._decoders():
            x, cache[name] = layer(x, cache=cache[name],
                                   cache_index=positions)
        x = self.final_norm(x)
        return self._logits(x)[:, 0, :], cache

    # ------------------------------------------------- paged decoding ----
    # The serving step API: a shared pool of fixed-size KV pages per layer
    # plus int32 page ids per sequence. Shapes stay fixed across calls
    # (page ids and positions are data), as in the JAX package.

    def init_paged_cache(self, num_pages: int, page_size: int,
                         dtype: torch.dtype = torch.float32) -> Cache:
        """Zeroed per-layer KV page pools ``{layer: (K, V)}`` with K/V of
        shape ``(num_pages, num_heads, page_size, head_dim)`` on the
        model's device. ``dtype=torch.int8`` stores the pages int8 with
        per-token fp32 scale pools of shape ``(num_pages, page_size)``
        beside them: ``{layer: (K, V, K_scale, V_scale)}``."""
        if self.transformer_type != LANGUAGE_MODEL:
            raise ValueError("incremental decoding needs a language_model "
                             "transformer (decoder-only)")
        head_dim = self.hidden_size // self.num_heads
        shape = (num_pages, self.num_heads, page_size, head_dim)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        if dtype == torch.int8:
            sshape = (num_pages, page_size)
            return {name: (zeros(shape, dtype), zeros(shape, dtype),
                           zeros(sshape, torch.float32),
                           zeros(sshape, torch.float32))
                    for name, _ in self._decoders()}
        if not dtype.is_floating_point:
            raise ValueError(f"cache dtype {dtype}: the KV pools are float "
                             f"or int8")
        return {name: (zeros(shape, dtype), zeros(shape, dtype))
                for name, _ in self._decoders()}

    def prefill_paged(self, cache: Cache, pages_row, tokens, start: int,
                      length: int, trash: int, need_logits: bool = True):
        """Run one prompt chunk ``tokens`` (C,) at positions
        ``start .. start+C-1`` of the sequence whose physical page ids are
        ``pages_row`` (ppn,). ``length`` real tokens (the rest is bucket
        padding, routed to the ``trash`` page). With ``need_logits``
        returns ``(next-token logits (vocab,), cache)`` read at chunk row
        ``length - 1``, otherwise ``cache``. The pools update in place."""
        tokens = self._as_ids(tokens)
        pages_row = torch.as_tensor(pages_row, device=self.device)
        n_chunk = tokens.shape[0]
        page_size = next(iter(cache.values()))[0].shape[2]
        max_len = pages_row.shape[0] * page_size
        x = self.embedding[tokens][None] * (self.hidden_size ** 0.5)
        pe = self._positions(max_len, x.dtype)
        at = (int(start) + torch.arange(n_chunk, device=self.device)).clamp(
            0, max_len - 1)
        x = self.embed_drop(x + pe[at][None])
        for name, layer in self._decoders():
            x, cache[name] = layer(
                x, cache_index=int(start), write_len=int(length),
                paged=_paged_inputs(cache[name], map=pages_row,
                                    trash=int(trash)))
        if not need_logits:
            return cache
        h = self.final_norm(x[:, int(length) - 1:int(length)])
        return self._logits(h)[0, 0], cache

    def decode_step_paged(self, cache: Cache, tokens, positions, page_map,
                          use_kernel: Optional[bool] = None):
        """One decode step for every slot: ``tokens``/``positions`` (S,)
        each slot's current token and the cache row it writes; ``page_map``
        (S, ppn) int32. Returns ``(logits (S, vocab), cache)``; the pools
        update in place. ``use_kernel=False`` forces the plain attention."""
        tokens = self._as_ids(tokens)
        positions = torch.as_tensor(positions, device=self.device).to(
            torch.int32)
        page_map = torch.as_tensor(page_map, device=self.device).to(
            torch.int32)
        page_size = next(iter(cache.values()))[0].shape[2]
        max_len = page_map.shape[1] * page_size
        x = self.embedding[tokens][:, None, :] * (self.hidden_size ** 0.5)
        x = x + self._positions(max_len, x.dtype)[positions.long()][:, None, :]
        for name, layer in self._decoders():
            x, cache[name] = layer(
                x, cache_index=positions,
                paged=_paged_inputs(cache[name], map=page_map,
                                    use_kernel=use_kernel))
        x = self.final_norm(x)
        return self._logits(x)[:, 0, :], cache

    def decode_verify_paged(self, cache: Cache, tokens, positions,
                            page_map, trash: int):
        """The verify step of speculative decoding: ``tokens`` (S, W) are
        each slot's last accepted token and its W-1 draft candidates,
        ``positions`` (S,) the cache row the first of them writes. Writes
        K/V rows ``positions .. positions+W-1`` (rows past the lane end go
        to ``trash``) and returns ``(logits (S, W, vocab), cache)``: row
        ``i`` scores the token after the candidate at ``positions + i``,
        which plain decode would take W steps to score. The pools update
        in place."""
        tokens = self._as_ids(tokens)
        positions = torch.as_tensor(positions, device=self.device).to(
            torch.int32)
        page_map = torch.as_tensor(page_map, device=self.device).to(
            torch.int32)
        page_size = next(iter(cache.values()))[0].shape[2]
        max_len = page_map.shape[1] * page_size
        x = self.embedding[tokens] * (self.hidden_size ** 0.5)  # (S, W, h)
        pos = positions.long()[:, None] + torch.arange(
            tokens.shape[1], device=self.device)[None, :]
        x = x + self._positions(max_len, x.dtype)[pos.clamp(0, max_len - 1)]
        for name, layer in self._decoders():
            x, cache[name] = layer(
                x, cache_index=positions,
                paged=_paged_inputs(cache[name], map=page_map,
                                    trash=int(trash)))
        return self._logits(self.final_norm(x)), cache


def _paged_inputs(entry, **extra) -> dict:
    """One layer's cache entry, (K, V) or (K, V, K_scale, V_scale), as the
    ``paged`` dict that ``Attention.forward`` reads."""
    paged = {"k": entry[0], "v": entry[1], **extra}
    if len(entry) == 4:
        paged["k_scale"], paged["v_scale"] = entry[2], entry[3]
    return paged
