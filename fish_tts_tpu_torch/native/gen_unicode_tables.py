"""Generate ``unicode_tables.h`` for the port's native BPE pre-tokenizer.

The C++ scanner (``bpe.cc``) needs three Unicode general-category classes,
L (letters), N (numbers) and P (punctuation), plus ``\\s`` (White_Space), to
implement the reference tokenizer's tiktoken split pattern without an
external regex engine.

The classes are extracted from tiktoken itself, so the tables match the
Unicode version of the regex engine the tokenizer must agree with token for
token: a tiktoken ``Encoding`` whose pattern is a single-codepoint class
(e.g. ``\\p{L}``) over a 256-byte vocabulary encodes a character iff the
engine puts it in that class (unmatched text is skipped by ``find_iter``),
so one bulk encode of every scalar codepoint recovers the class.  It needs
tiktoken, and raises without it: another engine's Unicode version would give
other tables.

Tables are emitted as sorted ``[first, last]`` ranges; the scanner
binary-searches L/N/P (``\\s`` stays written out in ``bpe.cc``'s ``is_ws``:
the probe runs here only to check that the White_Space list has not
changed).

Usage: python -m fish_tts_tpu_torch.native.gen_unicode_tables --out PATH

(``--out fish_tts_tpu_torch/native/unicode_tables.h`` rewrites the shipped
header.)
"""

from __future__ import annotations

import argparse
from pathlib import Path

HEADER = Path(__file__).parent / "unicode_tables.h"

# Unicode White_Space: must mirror is_ws() in bpe.cc.
WHITE_SPACE = (
    list(range(0x09, 0x0E)) + [0x20, 0x85, 0xA0, 0x1680]
    + list(range(0x2000, 0x200B)) + [0x2028, 0x2029, 0x202F, 0x205F, 0x3000]
)

_SCALARS = [c for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF]


def _probe_tiktoken(class_pat: str) -> set[int]:
    """All scalar codepoints matched by ``class_pat`` in tiktoken's engine."""
    import tiktoken

    enc = tiktoken.core.Encoding(
        name=f"probe_{abs(hash(class_pat))}",
        pat_str=class_pat,
        mergeable_ranks={bytes([i]): i for i in range(256)},
        special_tokens={},
    )
    members: set[int] = set()
    chunk = 65536
    for i in range(0, len(_SCALARS), chunk):
        cps = _SCALARS[i:i + chunk]
        out = bytes(enc.encode("".join(map(chr, cps))))
        pos = 0
        for cp in cps:
            b = chr(cp).encode("utf-8")
            if out[pos:pos + len(b)] == b:
                members.add(cp)
                pos += len(b)
        if pos != len(out):
            raise RuntimeError(f"probe misalignment for {class_pat}")
    return members


def _to_ranges(members: set[int]) -> list[tuple[int, int]]:
    out: list[tuple[int, int]] = []
    start = prev = None
    for cp in sorted(members):
        if start is None:
            start = prev = cp
        elif cp == prev + 1:
            prev = cp
        else:
            out.append((start, prev))
            start = prev = cp
    if start is not None:
        out.append((start, prev))
    return out


def _emit(name: str, ranges: list[tuple[int, int]]) -> str:
    rows = ",\n".join(
        "  " + ", ".join(f"{{0x{a:X}, 0x{b:X}}}" for a, b in ranges[i:i + 4])
        for i in range(0, len(ranges), 4)
    )
    return (
        f"static const CpRange {name}[] = {{\n{rows}\n}};\n"
        f"static const int {name}_len = {len(ranges)};\n"
    )


def tables() -> dict[str, list[tuple[int, int]]]:
    """Each table's ranges by its C name, probed from tiktoken."""
    classes = {
        "kTableL": _probe_tiktoken(r"\p{L}"),
        "kTableN": _probe_tiktoken(r"\p{N}"),
        "kTableP": _probe_tiktoken(r"\p{P}"),
    }
    ws = _probe_tiktoken(r"\s")
    if ws != set(WHITE_SPACE):
        raise RuntimeError(
            f"tiktoken's \\s changed: +{sorted(ws - set(WHITE_SPACE))} "
            f"-{sorted(set(WHITE_SPACE) - ws)}: update is_ws() in bpe.cc")
    return {name: _to_ranges(m) for name, m in classes.items()}


def render(ranges: dict[str, list[tuple[int, int]]]) -> str:
    """The header's text."""
    parts = [
        "// Generated by gen_unicode_tables.py — do not edit by hand.\n"
        "// Source: probed from tiktoken\n"
        "#pragma once\n#include <cstdint>\n\n"
        "struct CpRange { uint32_t first, last; };\n\n"
    ]
    parts += [_emit(name, r) for name, r in ranges.items()]
    return "".join(parts)


def main(argv: list[str] | None = None) -> dict[str, list[tuple[int, int]]]:
    """Write the header to ``--out`` and return its tables."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, required=True,
                    help=f"where to write the header (the shipped one is {HEADER})")
    args = ap.parse_args(argv)
    ranges = tables()
    args.out.write_text(render(ranges), encoding="utf-8")
    print(f"wrote {args.out} ({ {k: len(v) for k, v in ranges.items()} })")
    return ranges


if __name__ == "__main__":
    main()
