"""Structured generation: grammar-constrained decoding
(``bigdl_tpu/grammar``, copied: pure Python and numpy, the same tables
bit for bit).

Host-side grammar compiler + token-level automata. A regex or JSON
schema lowers to a character DFA, then lifts to a token automaton over
the serving vocabulary with per-state legal-token sets precomputed as
packed vocab masks (Willard & Louf 2023, "Efficient Guided Generation
for Large Language Models"). The engine consumes the automaton through
``GenerationEngine.submit(grammar=...)``: the current state's mask row
enters the decode step's sampler as a per-slot additive bias, and the
state advances on the host as tokens stream back.

    from bigdl_tpu_torch.grammar import json_schema_grammar, compile_grammar
    g = compile_grammar(json_schema_grammar(schema), vocab, eos_id=eos)
    stream = engine.submit(prompt, max_new_tokens=64, grammar=g)
"""

from bigdl_tpu_torch.grammar.automaton import (
    DEAD,
    NEG_BIAS,
    Grammar,
    TokenAutomaton,
    clear_compile_cache,
    compile_cache_stats,
    compile_grammar,
    json_schema_grammar,
    regex_grammar,
)
from bigdl_tpu_torch.grammar.regex import CharDFA, RegexError, compile_regex
from bigdl_tpu_torch.grammar.schema import SchemaError, json_schema_regex

__all__ = [
    "DEAD",
    "NEG_BIAS",
    "CharDFA",
    "Grammar",
    "GrammarViolation",
    "RegexError",
    "SchemaError",
    "TokenAutomaton",
    "clear_compile_cache",
    "compile_cache_stats",
    "compile_grammar",
    "compile_regex",
    "json_schema_grammar",
    "json_schema_regex",
    "regex_grammar",
]


def __getattr__(name):
    # GrammarViolation lives in serving.errors (it is a ServingError);
    # re-exported here for discoverability without a circular import
    if name == "GrammarViolation":
        from bigdl_tpu_torch.serving.errors import GrammarViolation

        return GrammarViolation
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
