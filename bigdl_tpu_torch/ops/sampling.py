"""Token sampling inside the serving step (``bigdl_tpu/ops/sampling.py``).

Per-slot parameters are host arrays of shape ``(S,)``: ``temperature``
(``<= 0`` is greedy), ``top_k`` (``<= 0`` keeps every token) and
``top_p`` (``<= 0`` or ``>= 1`` keeps every token). Each slot carries its
own raw threefry key, ``(S, 2)`` uint32 words, as in the JAX package.

A key's evolution and its uniform depend on the key alone, never on the
logits, so they are computed on the host (``core.rng``: ``split_keys``,
``fold_in_keys``, ``uniform_keys``, bitwise ``jax.random``) and only an
fp32 uniform per draw goes to the device, where the logits are. What runs
on the device is the JAX package's sequence of ops: divide by the
temperature (a tensor: CUDA turns a division by a Python scalar into a
multiply by its reciprocal), a stable descending sort, softmax, cumulative
sums, the top-k / top-p prefix keep mask, and an inverse-CDF pick clamped
into the kept set. The temperatures are host values, so a batch in which
no slot samples skips all of that without a device sync, as the JAX
package's ``lax.cond`` does, and greedy rows are the fp32 argmax bitwise.

The probabilities cannot match the JAX package's bitwise: XLA's cumulative
sum (a ``reduce_window``) and softmax round differently from PyTorch's.
What matches bitwise is the keys, the uniforms, the order of the sort and
every greedy row; a sampled token differs only where ``u * total`` falls
within a few ulps of a cumulative boundary (the tests flag such draws).

The speculative tier (``draft_sample``, ``speculative_sample``) keys every
draw by ``fold_in(fold_in(request_key, stream), output_position)``, so a
stream is a pure function of its request whatever the acceptance lengths.

An optional external logit bias ``(S, V)`` (the grammar mask of
constrained decoding: 0 for legal tokens, -1e9 for the rest) is added to
the fp32 logits before everything else, greedy argmax included, as the
JAX package adds it; an all-zero row changes no bit. ``logit + (-1e9)``
rounds to -1e9 for every ordinary logit, so masked tokens tie below every
legal one, and their softmax weight underflows to exactly 0.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from bigdl_tpu_torch.core.rng import (
    fold_in_keys,
    split_keys,
    uniform_keys,
)

DRAFT_STREAM = 1
ACCEPT_STREAM = 2
EXTRA_STREAM = 3


def check_temperature(temperature: float) -> None:
    if temperature < 0.0:
        raise ValueError("temperature must be >= 0")


def biased_logits(logits: torch.Tensor, bias=None) -> torch.Tensor:
    """``logits`` in fp32 plus the optional additive ``bias`` (a host
    array or a tensor of a broadcastable shape), moved to the logits'
    device and added in fp32."""
    logits = logits.float()
    if bias is None:
        return logits
    return logits + torch.as_tensor(bias).to(logits.device, torch.float32)


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """(..., V) logits -> (...,) int32 argmax over the fp32 logits (first
    maximal index on ties, as ``jnp.argmax``)."""
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)


def _host(a, dtype) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a, dtype).reshape(-1)


def _any_sampled(temperature) -> bool:
    return bool((_host(temperature, np.float32) > 0.0).any())


def _filters(temperature, top_k, top_p, vocab: int, device,
             u=None, upload=None) -> Tuple[torch.Tensor, ...]:
    """The per-slot filter arguments on ``device``, in one copy: the safe
    temperature, the effective top-k and top-p, the sampled flag and,
    given ``u``, the uniforms (JAX's ``where`` clauses, on the host).
    ``upload`` (a numpy array -> device tensor function), when given,
    makes the copy."""
    t = _host(temperature, np.float32)
    k = _host(top_k, np.int64)
    p = _host(top_p, np.float32)
    rows = [np.where(t > 0, t, np.float32(1.0)),
            np.where(k <= 0, vocab, np.clip(k, 1, vocab)),
            np.where((p <= 0.0) | (p >= 1.0), np.float32(1.0), p),
            t > 0]
    if u is not None:
        rows.append(_host(u, np.float32))
    host = np.stack([np.asarray(r, np.float32) for r in rows])
    out = (upload(host) if upload is not None
           else torch.from_numpy(host).to(device))
    return (out[0], out[1].long(), out[2], out[3] > 0) + tuple(out[4:])


def _sorted_keep(scaled, probs_sorted, k_eff, p_eff):
    """The top-k / top-p keep mask over the sorted ranks: the smallest
    prefix whose exclusive cumulative probability is below ``p`` (rank 0
    always kept), cut at ``k``."""
    csum = torch.cumsum(probs_sorted, dim=-1)
    ranks = torch.arange(scaled.shape[-1], device=scaled.device)[None, :]
    return (ranks < k_eff[:, None]) & (
        ((csum - probs_sorted) < p_eff[:, None]) | (ranks == 0))


def sample_with_uniforms(logits, temperature, top_k, top_p, u,
                         upload=None) -> torch.Tensor:
    """One token per slot from ``logits`` (S, V) given each slot's uniform
    draw ``u`` (S,) — :func:`sample_tokens` after its key split. The
    parameters and ``u`` are host values; ``upload``, when given, copies
    the filter rows to the device (see :func:`sample_tokens`)."""
    logits = logits.float()
    greedy = greedy_tokens(logits)
    if not _any_sampled(temperature):
        return greedy
    t_safe, k_eff, p_eff, sampled, u = _filters(
        temperature, top_k, top_p, logits.shape[-1], logits.device, u,
        upload)
    scaled = logits / t_safe[:, None]
    order = torch.argsort(-scaled, dim=-1, stable=True)
    probs = torch.softmax(torch.gather(scaled, -1, order), dim=-1)
    keep = _sorted_keep(scaled, probs, k_eff, p_eff)
    wsum = torch.cumsum(torch.where(keep, probs, 0.0), dim=-1)
    total = wsum[:, -1:]
    # the smallest rank whose inclusive kept mass exceeds u * total,
    # clamped into the kept prefix: with u near 1 the fp32 product can
    # round up to the whole mass, and the pick would leave the nucleus
    idx = (wsum <= u[:, None] * total).sum(dim=-1)
    idx = torch.minimum(idx, keep.sum(dim=-1) - 1)
    picked = torch.gather(order, -1, idx[:, None])[:, 0]
    return torch.where(sampled, picked.to(torch.int32), greedy)


def sample_tokens(logits, temperature, top_k, top_p, key_data,
                  bias=None, upload=None) -> Tuple[torch.Tensor, np.ndarray]:
    """Sample one token per slot. ``logits`` (S, V) on any device; the
    parameters and ``key_data`` (S, 2) uint32 are host arrays. Returns
    ``(tokens (S,) int32 on the logits' device, new key_data (S, 2))``.
    Exactly one split per slot per call, greedy slots included, so token
    ``i`` of a stream draws from split ``i`` of its request key.
    ``bias`` (S, V), optional, is added to the fp32 logits first.
    ``upload`` (a function from a numpy array to a tensor on the logits'
    device), when given, is how the sampled branch's per-slot rows reach
    the device: a pinned, non-blocking copy keeps the call from waiting
    for the kernels queued before it."""
    pairs = split_keys(key_data)                      # (S, 2, 2)
    u = uniform_keys(pairs[:, 1])
    return (sample_with_uniforms(biased_logits(logits, bias), temperature,
                                 top_k, top_p, u, upload),
            pairs[:, 0].copy())


def split_key_data(key_data) -> Tuple[np.ndarray, float]:
    """One slot's ``(2,)`` key advanced by one :func:`sample_tokens` call:
    ``(new key, the uniform it drew)``."""
    pair = split_keys(np.asarray(key_data, np.uint32).reshape(1, 2))[0]
    return pair[0].copy(), float(uniform_keys(pair[1]))


def position_uniform(key_data, stream: int, positions) -> np.ndarray:
    """Per-(request, output-position) uniforms: ``key_data`` (S, 2) raw
    request keys, ``positions`` (S,) or (S, K) -> float32 draws of the
    positions' shape, ``uniform(fold_in(fold_in(key, stream), pos))``."""
    keys = fold_in_keys(np.asarray(key_data, np.uint32).reshape(-1, 2),
                        stream)
    positions = np.asarray(positions, np.int64)
    if positions.ndim == 2:
        keys = keys[:, None]
    return uniform_keys(fold_in_keys(keys, positions))


def position_uniform_host(key_data, stream: int, position: int) -> float:
    """One :func:`position_uniform` draw for a single ``(2,)`` key."""
    return float(position_uniform(key_data, stream, [int(position)])[0])


def filtered_probs(logits, temperature, top_k, top_p,
                   bias=None) -> torch.Tensor:
    """The distribution each slot draws from, in vocab order: ``logits``
    (S, V) -> (S, V) fp32, normalised over the kept set after temperature
    and the top-k / top-p filters. Greedy rows are the one-hot argmax.
    ``bias`` (S, V), optional, is added to the fp32 logits first: a token
    it masks gets probability 0."""
    logits = biased_logits(logits, bias)
    n, vocab = logits.shape
    greedy = torch.nn.functional.one_hot(
        torch.argmax(logits, dim=-1), vocab).float()
    if not _any_sampled(temperature):
        return greedy
    t_safe, k_eff, p_eff, sampled = _filters(
        temperature, top_k, top_p, vocab, logits.device)
    scaled = logits / t_safe[:, None]
    probs = torch.softmax(scaled, dim=-1)
    order = torch.argsort(-scaled, dim=-1, stable=True)
    keep_sorted = _sorted_keep(scaled, torch.gather(probs, -1, order),
                               k_eff, p_eff)
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    w = torch.where(keep, probs, 0.0)
    w = w / w.sum(dim=-1, keepdim=True)
    return torch.where(sampled[:, None], w, greedy)


def pick_token(weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF pick over unnormalised ``weights`` (S, V) >= 0 with
    ``u`` (S,) on their device -> (S,) int32: the smallest index whose
    inclusive cumulative weight exceeds ``u * total``, clamped to the last
    positive weight; an all-zero row falls back to its argmax."""
    vocab = weights.shape[-1]
    csum = torch.cumsum(weights, dim=-1)
    total = csum[:, -1]
    pick = (csum <= u[:, None] * total[:, None]).sum(dim=-1)
    last_pos = vocab - 1 - torch.argmax(
        (weights > 0).flip(-1).to(torch.uint8), dim=-1)
    pick = torch.minimum(pick, last_pos)
    return torch.where(total > 0, pick,
                       torch.argmax(weights, dim=-1)).to(torch.int32)


def _device_u(u: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(u, np.float32)).to(device)


def position_sample(logits, temperature, top_k, top_p, key_data,
                    stream: int, positions,
                    bias=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token per slot from its filtered distribution, picked with the
    ``stream`` draw at its output position ``positions`` (S,). -> ``(tokens
    (S,) int32, dists (S, V))``. ``bias`` as :func:`filtered_probs`."""
    logits = biased_logits(logits, bias)
    dists = filtered_probs(logits, temperature, top_k, top_p)
    if not _any_sampled(temperature):
        # every row a one-hot delta: the pick is its argmax, for any u
        return greedy_tokens(logits), dists
    u = position_uniform(key_data, stream, positions)
    return pick_token(dists, _device_u(u, dists.device)), dists


def draft_sample(logits, temperature, top_k, top_p, key_data, out_pos,
                 bias=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One draft proposal per slot from the draft model's filtered
    distribution, with the DRAFT_STREAM draw at each slot's output
    position ``out_pos`` (S,). -> ``(tokens (S,) int32, dists (S, V))``;
    the distributions go to the verify step's accept test. A grammar
    ``bias`` keeps the proposals legal."""
    return position_sample(logits, temperature, top_k, top_p, key_data,
                           DRAFT_STREAM, out_pos, bias)


def speculative_sample(target_logits, draft_tokens, draft_dists,
                       temperature, top_k, top_p, key_data,
                       out_base) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rejection sampler of speculative decoding, per slot.

    ``target_logits`` (S, k+1, V) are the verify step's logits,
    ``draft_tokens`` (S, k) and ``draft_dists`` (S, k, V) the draft's
    proposals and filtered distributions (device tensors); the parameters,
    ``key_data`` (S, 2) and ``out_base`` (S,) — the output position of
    draft token 0 — are host arrays. Returns ``(n_accepted (S,) int32,
    tokens (S, k+1) int32)``: columns below ``n_accepted`` are accepted
    draft tokens, column ``n_accepted`` the extra token (the residual's
    pick after a rejection, the target's own past a full acceptance), the
    columns after it repeat it.

    Accept test ``i``: ``u_i * max(q(d_i), 1e-30) < p(d_i)`` with ``u_i``
    the ACCEPT_STREAM draw at ``out_base + i``; the extra token is picked
    from ``max(p - q, 0)`` with the EXTRA_STREAM draw at ``out_base + n``.
    Greedy rows (one-hot distributions) reduce to the longest prefix on
    which the draft equals the target's argmax."""
    target_logits = target_logits.float()
    s, k1, vocab = target_logits.shape
    k = k1 - 1
    dev = target_logits.device
    draft_tokens = draft_tokens.long()
    greedy_rows = greedy_tokens(target_logits)            # (S, k+1)
    if not _any_sampled(temperature):
        acc = (greedy_rows[:, :k].long() == draft_tokens).to(torch.int32)
        n = torch.cumprod(acc, dim=-1).sum(dim=-1)
        extra = torch.gather(greedy_rows, 1, n[:, None])[:, 0]
    else:
        def rep(a, dtype):
            return np.repeat(_host(a, dtype), k1)

        p = filtered_probs(target_logits.reshape(s * k1, vocab),
                           rep(temperature, np.float32),
                           rep(top_k, np.int64),
                           rep(top_p, np.float32)).reshape(s, k1, vocab)
        p_d = torch.gather(p[:, :k], -1, draft_tokens[..., None])[..., 0]
        q_d = torch.gather(draft_dists.float(), -1,
                           draft_tokens[..., None])[..., 0]
        base = _host(out_base, np.int64)[:, None]
        # the extra draw's position depends on n, which only the device
        # knows: draw it at every position it can take and gather
        u_acc, u_extra = (_device_u(position_uniform(
            key_data, stream, base + np.arange(width)[None, :]), dev)
            for stream, width in ((ACCEPT_STREAM, k), (EXTRA_STREAM, k1)))
        acc = (u_acc * torch.clamp_min(q_d, 1e-30) < p_d).to(torch.int32)
        n = torch.cumprod(acc, dim=-1).sum(dim=-1)
        gather_row = n[:, None, None].expand(s, 1, vocab)
        p_n = torch.gather(p, 1, gather_row)[:, 0]
        q_pad = torch.cat([draft_dists.float(),
                           torch.zeros((s, 1, vocab), device=dev)], dim=1)
        q_n = torch.gather(q_pad, 1, gather_row)[:, 0]
        residual = torch.clamp_min(p_n - q_n, 0.0)
        extra = pick_token(residual,
                           torch.gather(u_extra, 1, n[:, None])[:, 0])
    cand = torch.cat([draft_tokens.to(torch.int32),
                      torch.zeros((s, 1), dtype=torch.int32, device=dev)],
                     dim=1)
    cols = torch.arange(k1, device=dev)[None, :]
    tokens = torch.where(cols < n[:, None], cand, extra[:, None])
    return n.to(torch.int32), tokens.to(torch.int32)
