"""Transformer tier (``bigdl_tpu/nn/layers/attention.py``): multi-head
attention, FFN, pre-norm transformer layer, and the decoder-only language
model with its paged KV-cache step API.

Child modules carry the JAX package's module-path names, so a parameter's
dotted name here (``decoder_0.self_attention.inner.q_layer.weight``) is
its path in the JAX ``params`` tree. Two differences from the JAX code:

- the paged KV pools are updated IN PLACE (``index_put``) instead of
  functionally: the port keeps one pool per layer for the engine's
  lifetime and never copies it, which is the memory the JAX package
  recovers by donating the cache to every jitted call;
- this slice ports the language-model paged path only: the full causal
  forward, ``init_paged_cache``, ``prefill_paged`` (prompt chunks) and
  ``decode_step_paged`` (one token per slot, no external bias). The dense
  slot-table cache, the speculative verify step, int8 KV and translation
  mode come with later slices.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from bigdl_tpu_torch.core.device import DeviceLike, resolve_device
from bigdl_tpu_torch.nn.init import RandomNormal, default_generator
from bigdl_tpu_torch.nn.layers.dropout import Dropout
from bigdl_tpu_torch.nn.layers.linear import Linear
from bigdl_tpu_torch.nn.layers.norm import LayerNormalization
from bigdl_tpu_torch.ops.attention import dot_product_attention, paged_attention
from bigdl_tpu_torch.ops.flash_attention import gather_kv_lanes

Cache = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


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
    """Multi-head self-attention with bias-free q/k/v/output projections
    (reference ``Attention.scala:35``)."""

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
                causal: bool = False, cache_index=None, paged=None,
                write_len: Optional[int] = None):
        q = self._split_heads(self.q_layer(x))
        k = self._split_heads(self.k_layer(x))
        v = self._split_heads(self.v_layer(x))
        drop = self.attention_dropout if self.training else 0.0
        if paged is None:
            out = dot_product_attention(q, k, v, bias, causal=causal,
                                        dropout_rate=drop)
            return self.output_layer(self._join_heads(out))

        # Block-table KV cache: pools "k"/"v" (num_pages, H, page_size, D)
        # and "map", int32 physical-page ids. New K/V rows are scattered
        # into the pools in place, then attention reads them back.
        pk, pv = paged["k"], paged["v"]
        page_size = pk.shape[2]
        if isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1:
            # decode: one token per slot; map is (S, ppn)
            if bias is not None:
                raise NotImplementedError(
                    "external-bias paged decode is not ported yet")
            page_map = paged["map"]
            pos = cache_index.long()
            slots = torch.arange(pos.shape[0], device=pos.device)
            pg = page_map.long()[slots, pos // page_size]
            row = pos % page_size
            pk[pg, :, row] = k[:, :, 0, :].to(pk.dtype)
            pv[pg, :, row] = v[:, :, 0, :].to(pv.dtype)
            out3 = paged_attention(q[:, :, 0, :].contiguous(), pk, pv,
                                   page_map, cache_index,
                                   use_kernel=paged.get("use_kernel"))
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
            pk[pg, :, row] = k[0].transpose(0, 1).to(pk.dtype)
            pv[pg, :, row] = v[0].transpose(0, 1).to(pv.dtype)
            lk = gather_kv_lanes(pk, pages_row)[None]      # (1, H, L, D)
            lv = gather_kv_lanes(pv, pages_row)[None]
            rows = pos[:, None]
            cols = torch.arange(lk.shape[2], device=q.device)[None, :]
            validity = torch.where(cols <= rows, 0.0, -1e9)[None, None]
            out = dot_product_attention(
                q, lk, lv, validity if bias is None else bias + validity)
        out = self.output_layer(self._join_heads(out))
        return out, (pk, pv)


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

    def forward(self, x):
        return self.output_layer(self.drop(torch.relu(self.filter_layer(x))))


class _SubLayer(nn.Module):
    """Pre/post-processing wrapper: LayerNorm -> fn -> dropout -> +residual."""

    def __init__(self, inner: nn.Module, hidden_size: int, dropout: float, *,
                 device: DeviceLike = None):
        super().__init__()
        self.norm = LayerNormalization(hidden_size, device=device)
        self.inner = inner
        self.drop = Dropout(dropout)

    def forward(self, x, **kw):
        out = self.inner(self.norm(x), **kw)
        cache = None
        if isinstance(out, tuple):
            out, cache = out
        out = x + self.drop(out).to(x.dtype)
        return (out, cache) if cache is not None else out


class TransformerLayer(nn.Module):
    """One pre-norm block: self-attention + FFN (decoder-only)."""

    def __init__(self, hidden_size: int, num_heads: int, filter_size: int,
                 attention_dropout: float = 0.0, ffn_dropout: float = 0.0,
                 residual_dropout: float = 0.0, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = default_generator(generator)
        self.self_attention = _SubLayer(
            Attention(hidden_size, num_heads, attention_dropout,
                      device=device, generator=gen),
            hidden_size, residual_dropout, device=device)
        self.ffn = _SubLayer(
            FeedForwardNetwork(hidden_size, filter_size, ffn_dropout,
                               device=device, generator=gen),
            hidden_size, residual_dropout, device=device)

    def forward(self, x, bias=None, causal=False, cache_index=None,
                paged=None, write_len=None):
        out = self.self_attention(x, bias=bias, causal=causal,
                                  cache_index=cache_index, paged=paged,
                                  write_len=write_len)
        new_cache = None
        if isinstance(out, tuple):
            out, new_cache = out
        out = self.ffn(out)
        return (out, new_cache) if new_cache is not None else out


class Transformer(nn.Module):
    """Decoder-only transformer language model (reference
    ``DL/nn/Transformer.scala:53``, ``language_model`` mode with shared
    embedding/output weights): token ids (B, S) -> logits (B, S, vocab).
    The embedding is scaled by sqrt(hidden). Translation mode and an
    untied output projection come with the training slice.

    ``device=None`` means ``"cuda"`` (raises without a card). Weights are
    drawn from ``generator`` (a seeded CPU ``torch.Generator``; default
    seed 0) and moved to ``device``, so one seed gives one set of weights
    on every device.
    """

    def __init__(self, vocab_size: int, hidden_size: int, num_heads: int,
                 filter_size: int, num_hidden_layers: int,
                 embedding_dropout: float = 0.0,
                 attention_dropout: float = 0.0, ffn_dropout: float = 0.0,
                 *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        gen = default_generator(generator)
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.num_hidden_layers = num_hidden_layers
        self.embed_drop = Dropout(embedding_dropout)
        for i in range(num_hidden_layers):
            self.add_module(f"decoder_{i}", TransformerLayer(
                hidden_size, num_heads, filter_size, attention_dropout,
                ffn_dropout, residual_dropout=embedding_dropout,
                device=device, generator=gen))
        self.final_norm = LayerNormalization(hidden_size, device=device)
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

    def _decoders(self):
        return [(n, m) for n, m in self.named_children()
                if n.startswith("decoder_")]

    def _logits(self, h):
        return torch.matmul(h, self.embedding.to(h.dtype).t())

    def _as_ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(ids, device=self.device).long()

    def forward(self, ids) -> torch.Tensor:
        ids = self._as_ids(ids)
        x = self.embedding[ids] * (self.hidden_size ** 0.5)
        x = x + self._positions(ids.shape[1], x.dtype)[None]
        h = self.embed_drop(x)
        for _, layer in self._decoders():
            h = layer(h, causal=True)
        return self._logits(self.final_norm(h))

    # ------------------------------------------------- paged decoding ----
    # The serving step API: a shared pool of fixed-size KV pages per layer
    # plus int32 page ids per sequence. Shapes stay fixed across calls
    # (page ids and positions are data), as in the JAX package.

    def init_paged_cache(self, num_pages: int, page_size: int,
                         dtype: torch.dtype = torch.float32) -> Cache:
        """Zeroed per-layer KV page pools ``{layer: (K, V)}`` with K/V of
        shape ``(num_pages, num_heads, page_size, head_dim)`` on the
        model's device (float dtypes only in this slice)."""
        if not dtype.is_floating_point:
            raise NotImplementedError(
                f"cache dtype {dtype}: int8 KV comes with a later slice")
        head_dim = self.hidden_size // self.num_heads
        shape = (num_pages, self.num_heads, page_size, head_dim)
        return {name: (torch.zeros(shape, dtype=dtype, device=self.device),
                       torch.zeros(shape, dtype=dtype, device=self.device))
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
            pk, pv = cache[name]
            x, cache[name] = layer(
                x, cache_index=int(start), write_len=int(length),
                paged={"k": pk, "v": pv, "map": pages_row,
                       "trash": int(trash)})
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
            pk, pv = cache[name]
            x, cache[name] = layer(
                x, cache_index=positions,
                paged={"k": pk, "v": pv, "map": page_map,
                       "use_kernel": use_kernel})
        x = self.final_norm(x)
        return self._logits(x)[:, 0, :], cache
