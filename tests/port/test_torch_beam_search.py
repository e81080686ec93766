"""``beam_search`` against the JAX function on the same logits: the
sequences equal, the scores within 1e-5 x their largest magnitude (the
log-softmax and the length penalty's power round differently in XLA and
PyTorch). Cases: the three of the JAX suite's own beam-search tests
(a best path, all mass on EOS, uniform logits), seeded random logits that
depend on the decoded prefix, and ties everywhere (top-k must keep the
lower index first, as ``jax.lax.top_k`` does)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_trees import FAST_COMPILE

from bigdl_tpu.nn.layers.beam_search import beam_search as jax_beam_search
from bigdl_tpu_torch.nn import SequenceBeamSearch, beam_search
from bigdl_tpu_torch.nn.layers.beam_search import top_k


def _best_path(vocab, L):
    t = np.full((L, vocab), -4.0, np.float32)
    for i, tok in enumerate([2, 4, 1, 3]):
        t[i, tok] = 2.0
    return t


def _eos_mass(vocab, L):
    t = np.full((L, vocab), -10.0, np.float32)
    t[:, 3] = 5.0
    return t


CASES = {
    # name: (batch, beam, vocab, L, alpha, eos, step table, prefix weight)
    "best_path": (2, 3, 5, 4, 0.0, 4, _best_path(5, 4), 0.0),
    "eos_mass": (1, 2, 4, 3, 0.6, 3, _eos_mass(4, 3), 0.0),
    "uniform_ties": (2, 2, 4, 3, 0.0, 3, np.ones((3, 4), np.float32), 0.0),
    "random_prefix": (3, 4, 11, 6, 0.6, 2, None, 0.1),
    "ties_everywhere": (2, 4, 6, 5, 0.6, 5, np.zeros((5, 6), np.float32),
                        0.0),
}


def _table(case):
    b, k, v, L, alpha, eos, table, _ = CASES[case]
    if table is None:
        table = np.random.RandomState(0).standard_normal(
            (L, v)).astype(np.float32) * 2
    return table


@pytest.mark.parametrize("case", list(CASES))
def test_beam_search_matches_jax(case):
    b, k, v, L, alpha, eos, _, w = CASES[case]
    table = _table(case)
    init = np.arange(1, b + 1, dtype=np.int32) % v

    def jfn(ids, i, states):
        return (jnp.asarray(table)[i][None]
                + w * ids.sum(1, keepdims=True).astype(jnp.float32)), states

    def tfn(ids, i, states):
        return (torch.from_numpy(table[i])[None]
                + w * ids.sum(1, keepdim=True).float()), states

    run = jax.jit(lambda x: jax_beam_search(jfn, x, k, v, alpha, L, eos))
    jseq, jscores = jax.device_get(
        run.lower(jnp.asarray(init)).compile(FAST_COMPILE)(jnp.asarray(init)))
    seq, scores = beam_search(tfn, torch.from_numpy(init), k, v, alpha, L,
                              eos)
    assert seq.shape == (b, k, L + 1) and seq.dtype == torch.int32
    np.testing.assert_array_equal(seq.numpy(), jseq)
    np.testing.assert_allclose(scores.numpy(), jscores, rtol=1e-5,
                               atol=1e-5 * np.abs(jscores).max())


def test_top_k_breaks_ties_by_the_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0, 1.0]])
    values, index = top_k(x, 4)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert index.tolist() == np.asarray(ji).tolist() == [[1, 2, 4, 0]]
    assert values.tolist() == np.asarray(jv).tolist()


def test_states_pass_through_unreordered():
    """The function's state is handed on as returned, never gathered by
    beam (the JAX loop's behaviour, see the module docstring)."""
    seen = []

    def fn(ids, i, states):
        seen.append(states)
        return torch.zeros(ids.shape[0], 5), states + 1

    module = SequenceBeamSearch(lambda ids, i, s: fn(ids, i, 0), 5,
                                beam_size=2, alpha=0.0, max_decode_length=3,
                                eos_id=4)
    beam_search(fn, torch.zeros(2, dtype=torch.int32), 2, 5, 0.0, 3, 4,
                states=torch.tensor(10))
    assert [int(s) for s in seen] == [10, 11, 12]
    seq, scores = module(torch.zeros(2, dtype=torch.int32))
    assert len(seen) == 6
    assert seq.shape == (2, 2, 4) and scores.shape == (2, 2)
