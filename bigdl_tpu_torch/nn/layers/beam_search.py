"""Sequence beam search (``bigdl_tpu/nn/layers/beam_search.py``).

``beam_search`` keeps the JAX function's order of operations step for
step: the log-softmax of the step's logits plus each alive beam's log
probability; the best ``2k`` of the ``k · vocab`` candidates; the best
``k`` candidates that do not end in EOS become the alive beams; the EOS
candidates, scored ``log p / ((5 + len) / 6) ** alpha`` at ``len = i + 1``,
compete with the finished set for its ``k`` places; beams start at
``[0, -1e7, ...]`` and ``-1e7`` marks the places that are out. A batch row
with nothing finished after ``max_decode_length`` steps returns its alive
beams, scored at the penalty of that length. Every top-k breaks ties as
``jax.lax.top_k`` does, the lower index first: a stable descending sort,
where ``torch.topk`` promises no order among equal values.

``symbols_to_logits_fn(ids, i, states) -> (logits (B·k, vocab), states)``
sees the whole fixed-width ``(B·k, L + 1)`` id buffer: positions ``0..i``
hold the decoded prefix, the rest are zeros, so the latest token is
``ids[:, i]``. As in the JAX package, ``states`` is handed from step to
step as the function returns it, and is **not** reordered when the beams
are (the JAX loop never gathers its ``new_states`` by the chosen beams,
where the TF original does): a function that caches per-beam decoder
state would read another beam's cache after a reorder. Use a stateless
function (a forward over the id buffer) or one that does its own
gathering.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import nn

_NEG_INF = -1.0e7


def _length_penalty(alpha: float, length: int) -> torch.Tensor:
    return torch.pow((5.0 + torch.tensor(float(length))) / 6.0, alpha)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: the ``k`` largest values in
    descending order, ties broken by the lower index."""
    values, index = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def _gather_beams(x: torch.Tensor, beam_index: torch.Tensor) -> torch.Tensor:
    """``x`` (B, k, ...) and ``beam_index`` (B, n) -> (B, n, ...)."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, beam_index]


def beam_search(symbols_to_logits_fn: Callable, initial_ids: torch.Tensor,
                beam_size: int, vocab_size: int, alpha: float,
                max_decode_length: int, eos_id: int, states=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sequences (B, k, L + 1), scores (B, k))``, best first."""
    batch, k, L = initial_ids.shape[0], beam_size, max_decode_length
    dev = initial_ids.device
    penalty = {n: _length_penalty(alpha, n).to(dev)
               for n in range(1, L + 1)}
    alive_seq = torch.zeros((batch, k, L + 1), dtype=initial_ids.dtype,
                            device=dev)
    alive_seq[:, :, 0] = initial_ids[:, None]
    alive_lp = torch.tensor([[0.0] + [_NEG_INF] * (k - 1)],
                            device=dev).repeat(batch, 1)
    fin_seq = torch.zeros_like(alive_seq)
    fin_scores = torch.full((batch, k), _NEG_INF, device=dev)
    fin_flags = torch.zeros((batch, k), dtype=torch.bool, device=dev)
    neg_inf = torch.tensor(_NEG_INF, device=dev)

    for i in range(L):
        logits, states = symbols_to_logits_fn(
            alive_seq.reshape(batch * k, L + 1), i, states)
        log_probs = torch.log_softmax(logits.float(), dim=-1)
        log_probs = log_probs.reshape(batch, k, vocab_size) \
            + alive_lp[..., None]
        topk_lp, topk_idx = top_k(log_probs.reshape(batch, k * vocab_size),
                                  2 * k)
        beam_idx = topk_idx // vocab_size
        token_idx = topk_idx % vocab_size

        cand_seq = _gather_beams(alive_seq, beam_idx)        # (B, 2k, L+1)
        cand_seq[:, :, i + 1] = token_idx.to(cand_seq.dtype)
        cand_is_eos = token_idx == eos_id

        alive_lp, alive_pick = top_k(
            torch.where(cand_is_eos, neg_inf, topk_lp), k)
        alive_seq = _gather_beams(cand_seq, alive_pick)

        cand_scores = torch.where(cand_is_eos, topk_lp / penalty[i + 1],
                                  neg_inf)
        fin_scores, fin_pick = top_k(
            torch.cat([fin_scores, cand_scores], dim=1), k)
        fin_seq = _gather_beams(torch.cat([fin_seq, cand_seq], dim=1),
                                fin_pick)
        fin_flags = torch.gather(torch.cat([fin_flags, cand_is_eos], dim=1),
                                 1, fin_pick)

    alive_scores = alive_lp / _length_penalty(alpha, L).to(dev)
    any_finished = fin_flags.any(dim=1, keepdim=True)
    seq = torch.where(any_finished[..., None], fin_seq, alive_seq)
    scores = torch.where(any_finished, fin_scores, alive_scores)
    return seq, scores


class SequenceBeamSearch(nn.Module):
    """``beam_search`` as a module over a fixed ``symbols_to_logits_fn``
    (which closes over the decoder model); ``forward(initial_ids)``."""

    def __init__(self, symbols_to_logits_fn: Callable, vocab_size: int,
                 beam_size: int, alpha: float, max_decode_length: int,
                 eos_id: int):
        super().__init__()
        self.fn = symbols_to_logits_fn
        self.vocab_size = vocab_size
        self.beam_size = beam_size
        self.alpha = alpha
        self.max_decode_length = max_decode_length
        self.eos_id = eos_id

    def forward(self, initial_ids: torch.Tensor):
        return beam_search(self.fn, initial_ids, self.beam_size,
                           self.vocab_size, self.alpha,
                           self.max_decode_length, self.eos_id)
