"""Regex -> character DFA, the host-side half of grammar compilation.

A deliberately small, dependency-free regex engine: recursive-descent
parse to an AST, Thompson construction to an epsilon-NFA, subset
construction to a DFA, then a liveness trim (states from which no
accepting state is reachable are DEAD — a token whose character walk
lands in one can never complete a parse, so the automaton marks it
illegal up front instead of discovering the dead end mid-stream).

The alphabet is FINITE and known at compile time: the union of every
character that appears in the vocabulary with every literal character in
the pattern. ``.`` and negated classes quantify over that alphabet, not
over unicode — legality is only ever tested on vocabulary strings, so
characters no token can emit are irrelevant by construction.

Supported syntax: literals, escapes (``\\d \\w \\s \\D \\W \\S`` and
escaped metacharacters), ``.``, character classes ``[a-z0-9_]`` /
``[^...]`` with ranges, groups ``(...)``, alternation ``|`` and the
quantifiers ``* + ? {m} {m,} {m,n}``. Matching is anchored (fullmatch
semantics): the grammar describes the ENTIRE emitted stream.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Set, Tuple

_DIGITS = frozenset("0123456789")
_WORD = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")
_SPACE = frozenset(" \t\n\r\f\v")
_META = frozenset("\\.[]()|*+?{}^$")


class RegexError(ValueError):
    """Pattern rejected by the grammar regex subset."""


# ------------------------------------------------------------- AST ----


class _Node:
    __slots__ = ()


class _Lit(_Node):
    """One character drawn from a set (a literal is a 1-element set;
    classes/escapes are bigger sets; negations resolve at build time
    against the compile alphabet)."""

    __slots__ = ("chars", "negated")

    def __init__(self, chars: FrozenSet[str], negated: bool = False):
        self.chars = chars
        self.negated = negated


class _Cat(_Node):
    __slots__ = ("parts",)

    def __init__(self, parts: List[_Node]):
        self.parts = parts


class _Alt(_Node):
    __slots__ = ("options",)

    def __init__(self, options: List[_Node]):
        self.options = options


class _Repeat(_Node):
    """lo..hi copies of ``node``; ``hi`` None means unbounded."""

    __slots__ = ("node", "lo", "hi")

    def __init__(self, node: _Node, lo: int, hi):
        self.node = node
        self.lo = lo
        self.hi = hi


class _Parser:
    def __init__(self, pattern: str):
        self.pat = pattern
        self.pos = 0

    def _peek(self):
        return self.pat[self.pos] if self.pos < len(self.pat) else None

    def _next(self) -> str:
        if self.pos >= len(self.pat):
            raise RegexError(f"unexpected end of pattern: {self.pat!r}")
        ch = self.pat[self.pos]
        self.pos += 1
        return ch

    def parse(self) -> _Node:
        node = self._alternation()
        if self.pos != len(self.pat):
            raise RegexError(
                f"trailing {self.pat[self.pos:]!r} in {self.pat!r}")
        return node

    def _alternation(self) -> _Node:
        options = [self._concat()]
        while self._peek() == "|":
            self._next()
            options.append(self._concat())
        return options[0] if len(options) == 1 else _Alt(options)

    def _concat(self) -> _Node:
        parts: List[_Node] = []
        while self._peek() is not None and self._peek() not in "|)":
            parts.append(self._quantified())
        if not parts:
            return _Cat([])  # empty branch: matches ""
        return parts[0] if len(parts) == 1 else _Cat(parts)

    def _quantified(self) -> _Node:
        node = self._atom()
        ch = self._peek()
        if ch == "*":
            self._next()
            return _Repeat(node, 0, None)
        if ch == "+":
            self._next()
            return _Repeat(node, 1, None)
        if ch == "?":
            self._next()
            return _Repeat(node, 0, 1)
        if ch == "{":
            self._next()
            lo = self._int()
            hi: object = lo
            if self._peek() == ",":
                self._next()
                hi = self._int() if self._peek() != "}" else None
            if self._next() != "}":
                raise RegexError(f"unclosed {{}} in {self.pat!r}")
            if hi is not None and hi < lo:
                raise RegexError(f"bad repeat bounds in {self.pat!r}")
            return _Repeat(node, lo, hi)
        return node

    def _int(self) -> int:
        digits = ""
        while self._peek() is not None and self._peek().isdigit():
            digits += self._next()
        if not digits:
            raise RegexError(f"expected number in {self.pat!r}")
        return int(digits)

    def _atom(self) -> _Node:
        ch = self._next()
        if ch == "(":
            node = self._alternation()
            if self._next() != ")":
                raise RegexError(f"unclosed group in {self.pat!r}")
            return node
        if ch == "[":
            return self._char_class()
        if ch == ".":
            return _Lit(frozenset(), negated=True)  # anything in alphabet
        if ch == "\\":
            return _Lit(*self._escape())
        if ch in "*+?{":
            raise RegexError(f"dangling quantifier {ch!r} in {self.pat!r}")
        if ch in ")]|":
            raise RegexError(f"unbalanced {ch!r} in {self.pat!r}")
        return _Lit(frozenset(ch))

    def _escape(self) -> Tuple[FrozenSet[str], bool]:
        ch = self._next()
        if ch == "d":
            return _DIGITS, False
        if ch == "D":
            return _DIGITS, True
        if ch == "w":
            return _WORD, False
        if ch == "W":
            return _WORD, True
        if ch == "s":
            return _SPACE, False
        if ch == "S":
            return _SPACE, True
        if ch == "n":
            return frozenset("\n"), False
        if ch == "t":
            return frozenset("\t"), False
        if ch == "r":
            return frozenset("\r"), False
        if ch in _META or not ch.isalnum():
            return frozenset(ch), False
        raise RegexError(f"unsupported escape \\{ch} in {self.pat!r}")

    def _char_class(self) -> _Node:
        negated = self._peek() == "^"
        if negated:
            self._next()
        chars: Set[str] = set()
        first = True
        while True:
            ch = self._peek()
            if ch is None:
                raise RegexError(f"unclosed [] in {self.pat!r}")
            if ch == "]" and not first:
                self._next()
                break
            first = False
            ch = self._next()
            if ch == "\\":
                esc, esc_neg = self._escape()
                if esc_neg:
                    raise RegexError(
                        f"negated escape inside class in {self.pat!r}")
                chars |= esc
                continue
            if self._peek() == "-" and self.pos + 1 < len(self.pat) \
                    and self.pat[self.pos + 1] != "]":
                self._next()
                hi = self._next()
                if hi == "\\":
                    esc, _ = self._escape()
                    if len(esc) != 1:
                        raise RegexError(
                            f"bad range end in {self.pat!r}")
                    (hi,) = esc
                if ord(hi) < ord(ch):
                    raise RegexError(f"reversed range in {self.pat!r}")
                chars |= {chr(c) for c in range(ord(ch), ord(hi) + 1)}
            else:
                chars.add(ch)
        return _Lit(frozenset(chars), negated)


# ------------------------------------------------------------- NFA ----


class _NFA:
    def __init__(self):
        self.eps: List[Set[int]] = []
        self.trans: List[Dict[str, Set[int]]] = []

    def new_state(self) -> int:
        self.eps.append(set())
        self.trans.append({})
        return len(self.eps) - 1

    def add_eps(self, a: int, b: int):
        self.eps[a].add(b)

    def add_char(self, a: int, ch: str, b: int):
        self.trans[a].setdefault(ch, set()).add(b)


def _pattern_chars(node: _Node) -> Set[str]:
    """Every concrete character the AST names (negations contribute the
    characters they EXCLUDE — those must exist in the alphabet for the
    complement to be meaningful)."""
    out: Set[str] = set()
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, _Lit):
            out |= n.chars
        elif isinstance(n, _Cat):
            stack.extend(n.parts)
        elif isinstance(n, _Alt):
            stack.extend(n.options)
        elif isinstance(n, _Repeat):
            stack.append(n.node)
    return out


def _build_nfa(node: _Node, nfa: _NFA, alphabet: FrozenSet[str],
               start: int) -> int:
    """Thompson construction; returns the fragment's accept state."""
    if isinstance(node, _Lit):
        chars = (alphabet - node.chars) if node.negated else \
            (node.chars & alphabet)
        end = nfa.new_state()
        for ch in chars:
            nfa.add_char(start, ch, end)
        return end
    if isinstance(node, _Cat):
        cur = start
        for part in node.parts:
            cur = _build_nfa(part, nfa, alphabet, cur)
        return cur
    if isinstance(node, _Alt):
        end = nfa.new_state()
        for opt in node.options:
            s = nfa.new_state()
            nfa.add_eps(start, s)
            nfa.add_eps(_build_nfa(opt, nfa, alphabet, s), end)
        return end
    if isinstance(node, _Repeat):
        cur = start
        for _ in range(node.lo):
            cur = _build_nfa(node.node, nfa, alphabet, cur)
        if node.hi is None:
            loop = nfa.new_state()
            nfa.add_eps(cur, loop)
            body_end = _build_nfa(node.node, nfa, alphabet, loop)
            nfa.add_eps(body_end, loop)
            return loop
        end = nfa.new_state()
        nfa.add_eps(cur, end)
        for _ in range(node.hi - node.lo):
            cur = _build_nfa(node.node, nfa, alphabet, cur)
            nfa.add_eps(cur, end)
        return end
    raise RegexError(f"unknown AST node {type(node).__name__}")


def _eps_closure(nfa: _NFA, states: Set[int]) -> FrozenSet[int]:
    out = set(states)
    stack = list(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in out:
                out.add(t)
                stack.append(t)
    return frozenset(out)


class CharDFA:
    """Deterministic automaton over a finite character alphabet.

    ``trans[state]`` maps char -> next state (absent = reject);
    ``accepting`` / ``live`` are boolean-per-state lists, ``live[s]``
    true iff some accepting state is reachable from ``s``."""

    __slots__ = ("trans", "accepting", "live", "start", "alphabet")

    def __init__(self, trans, accepting, live, start, alphabet):
        self.trans = trans
        self.accepting = accepting
        self.live = live
        self.start = start
        self.alphabet = alphabet

    @property
    def n_states(self) -> int:
        return len(self.trans)

    def fullmatch(self, text: str) -> bool:
        cur = self.start
        for ch in text:
            cur = self.trans[cur].get(ch)
            if cur is None:
                return False
        return self.accepting[cur]


def compile_regex(pattern: str, alphabet) -> CharDFA:
    """Pattern + iterable of alphabet characters -> :class:`CharDFA`.

    The effective alphabet is the union of ``alphabet`` (the characters
    the vocabulary can emit) and the pattern's own literals, so a
    pattern naming characters no token contains still compiles — those
    branches are simply unreachable through the vocabulary."""
    ast = _Parser(pattern).parse()
    full_alphabet = frozenset(alphabet) | _pattern_chars(ast)
    nfa = _NFA()
    start = nfa.new_state()
    accept = _build_nfa(ast, nfa, full_alphabet, start)

    # subset construction
    start_set = _eps_closure(nfa, {start})
    ids: Dict[FrozenSet[int], int] = {start_set: 0}
    trans: List[Dict[str, int]] = [{}]
    accepting: List[bool] = [accept in start_set]
    work = [start_set]
    while work:
        cur = work.pop()
        cid = ids[cur]
        moves: Dict[str, Set[int]] = {}
        for s in cur:
            for ch, dests in nfa.trans[s].items():
                moves.setdefault(ch, set()).update(dests)
        for ch, dests in moves.items():
            closure = _eps_closure(nfa, dests)
            nid = ids.get(closure)
            if nid is None:
                nid = len(ids)
                ids[closure] = nid
                trans.append({})
                accepting.append(accept in closure)
                work.append(closure)
            trans[cid][ch] = nid

    # liveness: reverse reachability from accepting states
    n = len(trans)
    rev: List[Set[int]] = [set() for _ in range(n)]
    for s, moves in enumerate(trans):
        for d in moves.values():
            rev[d].add(s)
    live = [False] * n
    stack = [s for s in range(n) if accepting[s]]
    for s in stack:
        live[s] = True
    while stack:
        s = stack.pop()
        for p in rev[s]:
            if not live[p]:
                live[p] = True
                stack.append(p)
    return CharDFA(trans, accepting, live, 0, full_alphabet)
