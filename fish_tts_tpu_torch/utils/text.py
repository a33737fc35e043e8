"""Sentence-aware text chunking for long-form synthesis.

The port's copy of ``fish_tts_tpu/utils/text.py``: split on sentence
boundaries, pack sentences up to ``max_chars``, fall back to clause
boundaries, then whitespace, then hard cuts for pathological inputs, and
never drop or reorder a character (``"".join(chunks) == text`` up to the
whitespace trimmed at chunk joins).  The serving chain
(``ServeSession.submit(long=True)``) splits its text with it.
"""

from __future__ import annotations

import re

# sentence enders (incl. CJK full-width), keeping the punctuation and any
# closing quotes/brackets with the sentence they end
_SENTENCE_RE = re.compile(
    r'[^.!?。！？…\n]*(?:[.!?。！？…]+[\'")\]』」”’]*|\n+|$)', re.S
)
# clause-level fallback separators for one oversize sentence
_CLAUSE_RE = re.compile(r'[^,;:，；：]*(?:[,;:，；：]+|$)', re.S)


def _pack(pieces: list[str], max_chars: int) -> list[str]:
    """Greedily pack pieces into chunks of at most ``max_chars`` (a single
    oversize piece passes through for the caller to split further)."""
    chunks: list[str] = []
    cur = ""
    for piece in pieces:
        if not cur:
            cur = piece
        elif len(cur) + len(piece) <= max_chars:
            cur += piece
        else:
            chunks.append(cur)
            cur = piece
    if cur:
        chunks.append(cur)
    return chunks


def _split_oversize(piece: str, max_chars: int) -> list[str]:
    """One piece longer than ``max_chars``: clause boundaries, then
    whitespace, then hard character cuts."""
    clauses = [m.group(0) for m in _CLAUSE_RE.finditer(piece) if m.group(0)]
    if len(clauses) > 1:
        out = []
        for c in _pack(clauses, max_chars):
            out.extend(
                _split_oversize(c, max_chars) if len(c) > max_chars else [c]
            )
        return out
    # keep LEADING whitespace with the first word: an oversize piece that
    # starts with a separator (e.g. the space after a previous sentence)
    # must not lose it, or packing glues it to the preceding sentence
    words = re.findall(r"\s*\S+\s*", piece)
    if len(words) > 1:
        out = []
        for w in _pack(words, max_chars):
            out.extend(
                _split_oversize(w, max_chars) if len(w) > max_chars else [w]
            )
        return out
    return [piece[i: i + max_chars] for i in range(0, len(piece), max_chars)]


def split_text(text: str, max_chars: int = 200) -> list[str]:
    """Split ``text`` into synthesis chunks of at most ``max_chars``
    characters, preferring sentence boundaries (then clauses, whitespace,
    hard cuts).  Chunks are stripped; empty chunks are dropped.
    """
    if max_chars < 1:
        raise ValueError("max_chars must be >= 1")
    sentences = [m.group(0) for m in _SENTENCE_RE.finditer(text) if m.group(0)]
    pieces: list[str] = []
    for s in sentences:
        if len(s) > max_chars:
            pieces.extend(_split_oversize(s, max_chars))
        else:
            pieces.append(s)
    return [c for c in (p.strip() for p in _pack(pieces, max_chars)) if c]
