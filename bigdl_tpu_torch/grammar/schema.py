"""JSON schema -> regex lowering (the second grammar kind).

The engine constrains a stream token by token, so the schema is lowered
to a regular language over CHARACTERS and compiled by the same
:mod:`bigdl_tpu_torch.grammar.regex` pipeline the regex kind uses. The
supported subset is the tool-call shape production traffic actually has
— compact (no inter-token whitespace) canonical JSON:

- ``{"type": "object", "properties": {...}}`` — properties are emitted
  in DECLARATION order and all of them are present (the canonical
  serialization a tool-call emitter produces; ``required`` may restate
  any subset, it cannot reorder or drop keys);
- ``{"type": "string"}`` — double-quoted, any characters except ``"``
  and ``\\`` (escape sequences are out of the subset);
- ``{"type": "integer"}`` / ``{"type": "number"}`` — canonical forms
  (no leading zeros, optional ``-``; numbers allow one fraction part);
- ``{"type": "boolean"}`` / ``{"type": "null"}``;
- ``{"enum": [...]}`` — alternation of the literal JSON encodings;
- ``{"type": "array", "items": ...}`` with optional ``minItems`` 0/1 —
  ``[]`` or ``[item(,item)*]``.

Anything outside the subset raises :class:`SchemaError` at compile time
— the contract is "every emitted stream parses", so an approximated
schema is a bug, not a fallback.
"""

from __future__ import annotations

import json


class SchemaError(ValueError):
    """JSON schema outside the supported lowering subset."""


_STRING_RE = '"[^"\\\\]*"'
_INTEGER_RE = "-?(0|[1-9][0-9]*)"
_NUMBER_RE = "-?(0|[1-9][0-9]*)(\\.[0-9]+)?"


def _escape_literal(text: str) -> str:
    """Regex-quote a literal string for the grammar regex subset."""
    out = []
    for ch in text:
        if ch in "\\.[]()|*+?{}^$":
            out.append("\\" + ch)
        else:
            out.append(ch)
    return "".join(out)


def json_schema_regex(schema) -> str:
    """Lower a schema dict (or JSON string) to an anchored regex."""
    if isinstance(schema, str):
        try:
            schema = json.loads(schema)
        except json.JSONDecodeError as e:
            raise SchemaError(f"schema is not valid JSON: {e}") from e
    if not isinstance(schema, dict):
        raise SchemaError(f"schema must be an object, got "
                          f"{type(schema).__name__}")

    if "enum" in schema:
        options = schema["enum"]
        if not options:
            raise SchemaError("empty enum matches nothing")
        return "(" + "|".join(
            _escape_literal(json.dumps(v, separators=(",", ":")))
            for v in options) + ")"

    kind = schema.get("type")
    if kind == "string":
        return _STRING_RE
    if kind == "integer":
        return "(" + _INTEGER_RE + ")"
    if kind == "number":
        return "(" + _NUMBER_RE + ")"
    if kind == "boolean":
        return "(true|false)"
    if kind == "null":
        return "null"
    if kind == "array":
        item = json_schema_regex(schema.get("items", {"type": "string"}))
        min_items = int(schema.get("minItems", 0))
        if min_items not in (0, 1):
            raise SchemaError("minItems > 1 outside the lowering subset")
        body = f"{item}(,{item})*"
        return ("\\[" + body + "\\]" if min_items
                else "\\[(" + body + ")?\\]")
    if kind == "object":
        props = schema.get("properties")
        if not props:
            raise SchemaError("object schema needs non-empty properties")
        required = schema.get("required")
        if required is not None and set(required) - set(props):
            raise SchemaError(
                f"required names unknown properties: "
                f"{sorted(set(required) - set(props))}")
        parts = []
        for name, sub in props.items():
            parts.append(
                _escape_literal(json.dumps(name)) + ":"
                + json_schema_regex(sub))
        return "\\{" + ",".join(parts) + "\\}"
    raise SchemaError(f"unsupported schema: {schema!r}")
