"""Frame-composition strategies: phonological attribute dicts → tokens.

Pure string functions, one call per *sample* (a list of per-frame dicts),
matching the reference's four strategies byte-for-byte
(reference dataset/builder/dataset_builder.py:137-223):

  all_values    — per field, the raw value left-padded to width 20, fields
                  joined by '-' (dataset_builder.py:155-167)
  as_words      — per field, first letter of each '_'-separated word,
                  fields joined by '-', e.g. 'lb--ldf--L-'
                  (dataset_builder.py:169-182; the configs' default,
                  config/config-transformer.yaml:68)
  as_words_norm — orientation/movement fields normalized to a 3-slot
                  'l/r u/d f/b' code, others raw
                  (dataset_builder.py:184-208)
  as_sep_feat   — stringified Python list of per-field abbreviations
                  (dataset_builder.py:210-223)

A frame dict maps field name → either a falsy value (null in the source
JSON) or {"value": "<underscore_separated_attribute>"}.
"""
from __future__ import annotations

from typing import Mapping, Sequence

Frame = Mapping[str, object]


def _value(data) -> str:
    return str(data["value"]) if data else ""


def _abbrev(data) -> str:
    """First letter of each '_'-separated word of the value; '' if null."""
    if not data:
        return ""
    return "".join(word[0] for word in str(data["value"]).split("_") if word)


def compose_all_values(rows: Sequence[Frame], fields: Sequence[str]) -> list:
    return [
        "-".join(f"{_value(row[f]):<20}" for f in fields)
        for row in rows
    ]


def compose_as_words(rows: Sequence[Frame], fields: Sequence[str]) -> list:
    return [
        "-".join(_abbrev(row[f]) for f in fields)
        for row in rows
    ]


def compose_as_words_norm(rows: Sequence[Frame],
                          fields: Sequence[str]) -> list:
    def compose_field(field: str, data) -> str:
        values = _value(data)
        if field.startswith("orientation") or field.startswith("movement"):
            words = values.split("_")
            return "".join([
                "l" if "left" in words else "r" if "right" in words else "_",
                "u" if "up" in words else "d" if "down" in words else "_",
                "f" if "front" in words else "b" if "back" in words else "_",
            ])
        return values

    return [
        "-".join(compose_field(f, row[f]) for f in fields)
        for row in rows
    ]


def compose_as_sep_feat(rows: Sequence[Frame], fields: Sequence[str]) -> list:
    return [str([_abbrev(row[f]) for f in fields]) for row in rows]


COMPOSITION_STRATEGIES = {
    "all_values": compose_all_values,
    "as_words": compose_as_words,
    "as_words_norm": compose_as_words_norm,
    "as_sep_feat": compose_as_sep_feat,
}


def compose(rows: Sequence[Frame], fields: Sequence[str],
            strategy: str = "as_words") -> list:
    if strategy not in COMPOSITION_STRATEGIES:
        raise ValueError(f"Unknown composition strategy: '{strategy}'")
    return COMPOSITION_STRATEGIES[strategy](rows, fields)
