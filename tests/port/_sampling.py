"""The boundary rule of the sampling parity tests.

A sampled token is a comparison of ``t = u * total`` against cumulative
weights, and a top-p keep decision a comparison of ``csum - p`` against
``top_p``. Two implementations that round their probabilities differently
(XLA's softmax and ``reduce_window`` cumulative sum against PyTorch's, or a
card against the CPU) agree on every such comparison except where the two
sides lie within a few ulps. A draw is **flagged** when ``t`` lies within
``ULPS`` ulps (of ``t``) of any kept cumulative weight, when a top-p
decision ``csum - p < top_p`` lies within ``ULPS`` ulps of ``top_p``, or
(speculative) when the accept test ``u * max(q, 1e-30) < p`` lies within
``ULPS`` ulps of ``p``. Only flagged draws may pick differently. The
values are the numpy fp32 oracle's (``bigdl_tpu/ops/sampling.py``'s
``numpy_reference_*`` sequence of ops). ``chip_smoke.py`` carries a copy.
"""

import numpy as np

ULPS = 4


def _near(values, target, scale) -> bool:
    values = np.asarray(values, np.float64).reshape(-1)
    room = ULPS * float(np.spacing(np.float32(abs(scale))))
    return bool(np.any(np.abs(values - float(target)) <= room))


def _sorted_probs(logits, temperature):
    scaled = (np.asarray(logits, np.float32)
              / np.float32(temperature)).astype(np.float32)
    order = np.argsort(-scaled, kind="stable")
    e = np.exp((scaled[order] - scaled.max()).astype(np.float32))
    return order, (e / e.sum()).astype(np.float32)


def _keep(probs, top_k, top_p):
    vocab = probs.shape[-1]
    csum = np.cumsum(probs, dtype=np.float32)
    ranks = np.arange(vocab)
    k_eff = vocab if top_k <= 0 else min(max(int(top_k), 1), vocab)
    p_eff = (np.float32(1.0) if (top_p <= 0.0 or top_p >= 1.0)
             else np.float32(top_p))
    keep = (ranks < k_eff) & (((csum - probs) < p_eff) | (ranks == 0))
    near_p = p_eff < 1 and _near((csum - probs)[1:k_eff], p_eff, p_eff)
    return keep, near_p


def filter_flagged(logits, temperature, top_k, top_p) -> bool:
    """A top-p keep decision of this row sits on its boundary."""
    if temperature <= 0:
        return False
    _, probs = _sorted_probs(logits, temperature)
    return _keep(probs, top_k, top_p)[1]


def pick_flagged(weights, u) -> bool:
    """An inverse-CDF pick over ``weights`` (vocab order) with ``u`` sits
    on a cumulative boundary."""
    weights = np.asarray(weights, np.float32)
    c = np.cumsum(weights, dtype=np.float32)
    t = np.float32(u) * c[-1]
    return _near(c[weights > 0], t, t)


def sample_flagged(logits, temperature, top_k, top_p, u) -> bool:
    """The boundary rule for one ``sample_tokens`` draw."""
    if temperature <= 0:
        return False
    _, probs = _sorted_probs(logits, temperature)
    keep, near_p = _keep(probs, top_k, top_p)
    c = np.cumsum(np.where(keep, probs, np.float32(0.0)), dtype=np.float32)
    t = np.float32(u) * c[-1]
    return near_p or _near(c[keep], t, t)


def draft_flagged(logits, temperature, top_k, top_p, u) -> bool:
    """The boundary rule for one position-keyed pick (``draft_sample``,
    the speculative tier's first token)."""
    if temperature <= 0:
        return False
    from bigdl_tpu.ops.sampling import numpy_reference_filtered

    dist = numpy_reference_filtered(logits, temperature, top_k, top_p)
    return (filter_flagged(logits, temperature, top_k, top_p)
            or pick_flagged(dist, u))


def accept_flagged(u, q, p) -> bool:
    """The accept test ``u * max(q, 1e-30) < p`` sits on its boundary."""
    lhs = np.float32(u) * max(np.float32(q), np.float32(1e-30))
    return _near([lhs], p, p)


def speculative_flagged(target_logits, draft_tokens, draft_dists,
                        temperature, top_k, top_p, key, out_base) -> bool:
    """The boundary rule over one slot's ``speculative_sample`` step: any
    of its top-p decisions, accept tests or its extra pick."""
    if temperature <= 0:
        return False
    from bigdl_tpu.ops.sampling import numpy_reference_filtered
    from bigdl_tpu_torch.ops.sampling import (
        ACCEPT_STREAM,
        EXTRA_STREAM,
        position_uniform_host,
    )

    k = len(draft_tokens)
    p = [numpy_reference_filtered(row, temperature, top_k, top_p)
         for row in target_logits]
    if any(filter_flagged(row, temperature, top_k, top_p)
           for row in target_logits):
        return True
    n = 0
    for i in range(k):
        d = int(draft_tokens[i])
        u = position_uniform_host(key, ACCEPT_STREAM, int(out_base) + i)
        q = np.float32(draft_dists[i][d])
        if accept_flagged(u, q, p[i][d]):
            return True
        if not np.float32(u) * max(q, np.float32(1e-30)) < p[i][d]:
            break
        n += 1
    q_n = (np.asarray(draft_dists[n], np.float32) if n < k
           else np.zeros_like(p[n]))
    residual = np.maximum(p[n] - q_n, np.float32(0.0))
    return pick_flagged(residual, position_uniform_host(
        key, EXTRA_STREAM, int(out_base) + n))
