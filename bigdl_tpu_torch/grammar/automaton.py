"""Token-level grammar automata over a vocabulary.

:func:`compile_grammar` lowers a :class:`Grammar` spec (regex or JSON
schema) to a character DFA, then lifts it to the TOKEN level against a
concrete vocabulary: for every DFA state, walk every token's characters
— the token is legal iff the walk stays defined and ends in a LIVE
state (one from which acceptance is still reachable). The result is a
dense ``(n_states, V)`` int32 destination table, the per-state legal
sets packed as bit masks (``np.packbits`` — the canonical compact
representation), and a precomputed ``(n_states, V)`` float32 additive
bias matrix (0 legal / -1e9 illegal) whose rows the engine copies into
the per-slot ``(S, V)`` bias array consumed inside the step's sampler.

Compilation happens ONCE per distinct ``(grammar, vocabulary, eos)``
triple: a module-level cache shares the compiled automaton across
requests and engines (the per-state tables are immutable; per-request
state is just an int, advanced host-side as tokens stream back).

EOS is part of the automaton's contract, not of the text: the EOS
column of a state's mask is legal iff the state is ACCEPTING, so a
constrained stream can only terminate on a parse — and a state with no
legal continuation and no legal EOS is the stuck terminal the engine
fails with ``GrammarViolation``.
"""

from __future__ import annotations

import hashlib
import json
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from bigdl_tpu_torch.grammar.regex import CharDFA, compile_regex
from bigdl_tpu_torch.grammar.schema import json_schema_regex

NEG_BIAS = np.float32(-1e9)
DEAD = -1


class Grammar:
    """A grammar SPEC — kind + source, no vocabulary yet.

    Build via :func:`regex_grammar` / :func:`json_schema_grammar`;
    compile against a vocabulary with :func:`compile_grammar`. The
    ``key`` is a stable identity used by the compile cache and the
    engine's shared-grammar registry."""

    __slots__ = ("kind", "source", "pattern")

    def __init__(self, kind: str, source: str, pattern: str):
        self.kind = kind        # "regex" | "json"
        self.source = source    # the user-facing spec text
        self.pattern = pattern  # the lowered regex actually compiled

    @property
    def key(self) -> str:
        return f"{self.kind}:{self.source}"

    def __repr__(self):
        return f"Grammar(kind={self.kind!r}, source={self.source!r})"


def regex_grammar(pattern: str) -> Grammar:
    """Grammar spec from an anchored (fullmatch) regex pattern."""
    return Grammar("regex", pattern, pattern)


def json_schema_grammar(schema) -> Grammar:
    """Grammar spec from a JSON schema (dict or JSON text) — lowered to
    a regex over canonical compact JSON (see :mod:`grammar.schema`)."""
    pattern = json_schema_regex(schema)
    if not isinstance(schema, str):
        schema = json.dumps(schema, sort_keys=False,
                            separators=(",", ":"))
    return Grammar("json", schema, pattern)


class TokenAutomaton:
    """A grammar compiled against one vocabulary (immutable, shared).

    Per-request state is an int (``start_state`` to begin); the engine
    advances it host-side with :meth:`advance` on every emitted token
    and arms the next step's mask with :meth:`bias_row`."""

    def __init__(self, spec: Grammar, dfa: CharDFA,
                 vocab: Sequence[str], eos_id: Optional[int], key: str):
        self.spec = spec
        self.key = key
        self.vocab = tuple(vocab)
        self.vocab_size = len(vocab)
        self.eos_id = eos_id
        self.start_state = dfa.start
        self._dfa = dfa
        n, v = dfa.n_states, self.vocab_size

        dest = np.full((n, v), DEAD, np.int32)
        legal = np.zeros((n, v), bool)
        for s in range(n):
            if not dfa.live[s]:
                continue
            trans = dfa.trans
            for t, text in enumerate(self.vocab):
                if not text or t == eos_id:
                    continue  # empty tokens never advance; EOS below
                cur = s
                for ch in text:
                    cur = trans[cur].get(ch)
                    if cur is None:
                        break
                if cur is not None and dfa.live[cur]:
                    dest[s, t] = cur
                    legal[s, t] = True
        if eos_id is not None:
            legal[:, eos_id] = np.asarray(dfa.accepting, bool)
        self._dest = dest
        self._legal = legal
        self.packed_masks = np.packbits(legal, axis=1)
        self._bias = np.where(legal, np.float32(0.0), NEG_BIAS)
        self._accepting = np.asarray(dfa.accepting, bool)
        eos_col = (np.zeros(n, bool) if eos_id is None
                   else legal[:, eos_id])
        self._has_continuation = (legal.sum(axis=1)
                                  - eos_col.astype(int)) > 0
        self._masked_frac = 1.0 - legal.sum(axis=1) / float(v)

    @property
    def n_states(self) -> int:
        return self._dest.shape[0]

    def advance(self, state: int, token: int) -> int:
        """Next automaton state after emitting ``token`` (``DEAD`` for
        an illegal token or from a dead state)."""
        if state < 0:
            return DEAD
        return int(self._dest[state, token])

    def bias_row(self, state: int) -> np.ndarray:
        """(V,) float32 additive mask for ``state`` — 0 legal, -1e9
        illegal. A dead state returns all-zeros (unconstrained): the
        engine retires the stream before another step samples, and a
        uniform row keeps the array a no-op for the speculative rows
        past a stream's terminal."""
        if state < 0:
            return np.zeros(self.vocab_size, np.float32)
        return self._bias[state]

    def is_accepting(self, state: int) -> bool:
        return state >= 0 and bool(self._accepting[state])

    def has_continuation(self, state: int) -> bool:
        """True iff some non-EOS token is legal from ``state``."""
        return state >= 0 and bool(self._has_continuation[state])

    def legal_count(self, state: int) -> int:
        return 0 if state < 0 else int(self._legal[state].sum())

    def masked_frac(self, state: int) -> float:
        """Fraction of the vocabulary the state's mask excludes."""
        return 1.0 if state < 0 else float(self._masked_frac[state])

    def text_of(self, tokens: Sequence[int]) -> str:
        """Decode a token stream (EOS dropped) to its surface text."""
        return "".join(self.vocab[t] for t in tokens if t != self.eos_id)

    def matches(self, tokens: Sequence[int]) -> bool:
        """Does the emitted stream parse? (fullmatch of the decoded
        text — the contract every constrained stream must satisfy)."""
        return self._dfa.fullmatch(self.text_of(tokens))

    def __repr__(self):
        return (f"TokenAutomaton({self.spec.kind!r}, states="
                f"{self.n_states}, vocab={self.vocab_size})")


_CACHE: dict = {}
_CACHE_LOCK = threading.Lock()
_HITS = 0
_MISSES = 0


def _vocab_fingerprint(vocab: Sequence[str]) -> str:
    h = hashlib.sha256()
    for text in vocab:
        h.update(text.encode("utf-8", "surrogatepass"))
        h.update(b"\x00")
    return h.hexdigest()[:16]


def compile_grammar(spec: Grammar, vocab: Sequence[str],
                    eos_id: Optional[int] = None) -> TokenAutomaton:
    """Compile (or fetch) the token automaton for ``spec`` over
    ``vocab``. Cached per ``(grammar, vocabulary, eos)`` — every
    request sharing a grammar shares ONE compiled automaton."""
    global _HITS, _MISSES
    if not isinstance(spec, Grammar):
        raise TypeError(
            f"expected a Grammar spec (regex_grammar / "
            f"json_schema_grammar), got {type(spec).__name__}")
    key = (f"{spec.key}|vocab:{_vocab_fingerprint(vocab)}"
           f"|eos:{eos_id}")
    with _CACHE_LOCK:
        cached = _CACHE.get(key)
        if cached is not None:
            _HITS += 1
            return cached
    alphabet = set()
    for text in vocab:
        alphabet.update(text)
    dfa = compile_regex(spec.pattern, alphabet)
    automaton = TokenAutomaton(spec, dfa, vocab, eos_id, key)
    with _CACHE_LOCK:
        # a racing compile of the same key keeps the first one in
        if key in _CACHE:
            _HITS += 1
            return _CACHE[key]
        _CACHE[key] = automaton
        _MISSES += 1
    return automaton


def compile_cache_stats() -> Tuple[int, int]:
    """(hits, misses) of the module compile cache — misses count
    actual compilations."""
    with _CACHE_LOCK:
        return _HITS, _MISSES


def clear_compile_cache() -> None:
    """Testing hook: drop every cached automaton and zero the stats."""
    global _HITS, _MISSES
    with _CACHE_LOCK:
        _CACHE.clear()
        _HITS = 0
        _MISSES = 0
