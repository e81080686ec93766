"""Kernel B3's algorithm on the card, emulated in torch on the CPU.

``csrc/paged_attention.cu`` runs each (slot, head) on a block of up to 8
warps (as many as fit its shared memory, by D and the pools' dtype): key
tile t (16 keys) belongs to warp t % warps; each warp walks its tiles in
order with one online-softmax state updated once per tile (the tile's
max, one exp per key, the tile's sum, one rescale of the accumulator);
then the warps' states merge once, in warp order. Int8 pools dequantize each row as ``float(k) *
scale`` before the dots, as the kernel does. The sums run in another
order than the card's, so this is held to tolerances, not bits.
"""

import math

import torch

from bigdl_tpu_torch.ops import flash_attention as tfa


def _merge(states):
    """The warps' (max, sum, acc) states, combined as the kernel does:
    their common max, then the rescaled sums in warp order."""
    top = torch.stack([m for m, _, _ in states]).amax(0)
    total, acc = 0.0, 0.0
    for m, l, a in states:
        w = torch.where(m == -math.inf, 0.0, torch.exp(m - top))
        total, acc = total + w * l, acc + w[:, None] * a
    return top, total, acc


def paged_tiles(q, k_pages, v_pages, page_map, positions, scale, warps,
                tile=16, k_scales=None, v_scales=None):
    """B3 / B3-int8 with ``warps`` warps a block and ``tile`` keys a tile:
    q (S, H, D) -> fp32 (S, H, D)."""
    n_slots, heads, d = q.shape
    lane = k_pages.shape[2] * page_map.shape[1]
    lk = tfa.gather_kv_lanes(k_pages, page_map).float()   # (S, H, L, D)
    lv = tfa.gather_kv_lanes(v_pages, page_map).float()
    if k_scales is not None:
        lk = lk * tfa.gather_scale_lanes(k_scales, page_map)[:, None, :, None]
        lv = lv * tfa.gather_scale_lanes(v_scales, page_map)[:, None, :, None]
    out = torch.zeros(n_slots, heads, d)
    for s in range(n_slots):
        pos = int(positions[s])
        if pos < 0:
            continue
        k_end = min(pos, lane - 1) + 1
        qs = q[s].float()
        n_tiles = -(-k_end // tile)
        states = []
        for w in range(warps):
            m = torch.full((heads,), -math.inf)
            l = torch.zeros(heads)
            acc = torch.zeros(heads, d)
            for t in range(w, n_tiles, warps):
                a, b = t * tile, min((t + 1) * tile, k_end)
                sc = torch.einsum("hkd,hd->hk", lk[s, :, a:b], qs) * scale
                m_new = torch.maximum(m, sc.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(sc - m_new[:, None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[:, None] + torch.einsum(
                    "hk,hkd->hd", p, lv[s, :, a:b])
                m = m_new
            states.append((m, l, acc))
        _, total, acc = _merge(states)
        out[s] = acc / total[:, None]
    return out
