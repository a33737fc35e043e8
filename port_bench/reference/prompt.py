"""The prompt matrix of a request, worked out from its text and voices alone.

The benchmark writes a byte-level vocabulary: ids 0-255 are the bytes of
the UTF-8 text, the special tokens follow in ``SPECIALS`` order, then the
semantic tokens ``<|semantic:i|>``.  A prompt is laid out as the published
Fish-Speech inference prompt: ``<|interleave|>``, then per voice
``<|speaker:0|>`` + its text + its codes (row 0 as semantic token ids, every
book's code in rows 1..K) + ``<|im_end|>``, then ``<|speaker:0|>`` + the
text.  ``<|speaker:0|>`` is no special token of the vocabulary, so it is
spelt in bytes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SPECIALS = (
    "<|begin_of_text|>", "<|end_of_text|>", "<|pad|>", "<|im_start|>", "<|im_end|>",
    "<|phoneme_start|>", "<|phoneme_end|>", "<|tool_call_start|>", "<|tool_call_end|>",
    "<|text|>", "<|voice|>", "<|interleave|>", "<|audio_start|>", "<|audio_end|>",
    "<|audio|>",
)
BYTES = 256
SPEAKER = "<|speaker:0|>"


@dataclass(frozen=True)
class Ids:
    """The ids the model's arithmetic depends on."""

    semantic_begin: int
    semantic_end: int
    im_end: int
    interleave: int


def special_tokens(num_semantic: int) -> list[str]:
    """The special-token list of the written vocabulary, in id order."""
    return [*SPECIALS, *(f"<|semantic:{i}|>" for i in range(num_semantic))]


def ids(num_semantic: int) -> Ids:
    begin = BYTES + len(SPECIALS)
    return Ids(semantic_begin=begin, semantic_end=begin + num_semantic - 1,
               im_end=BYTES + SPECIALS.index("<|im_end|>"),
               interleave=BYTES + SPECIALS.index("<|interleave|>"))


def vocab_lines() -> str:
    """The ``.tiktoken`` file of the byte vocabulary: one base64 byte and its
    rank per line."""
    import base64

    return "\n".join(f"{base64.b64encode(bytes([i])).decode()} {i}" for i in range(BYTES)) + "\n"


def _text(s: str) -> list[int]:
    return list(s.encode("utf-8"))


def prompt_matrix(text: str, num_codebooks: int, num_semantic: int,
                  voices: list[tuple[str, np.ndarray]] = ()) -> np.ndarray:
    """The (1 + K, T) int64 prompt of ``text`` after ``voices`` [(text,
    codes (K, n))]."""
    t = ids(num_semantic)
    rows: list[np.ndarray] = []

    def tokens(toks):
        col = np.zeros((1 + num_codebooks, len(toks)), np.int64)
        col[0] = toks
        rows.append(col)

    tokens([t.interleave])
    for vtext, codes in voices:
        tokens(_text(SPEAKER) + _text(vtext))
        codes = np.asarray(codes, np.int64)
        col = np.zeros((1 + num_codebooks, codes.shape[1]), np.int64)
        col[0] = codes[0] + t.semantic_begin
        col[1:] = codes
        rows.append(col)
        tokens([t.im_end])
    tokens(_text(SPEAKER) + _text(text))
    return np.concatenate(rows, axis=1)


def prompt_length(text_tokens: int, voices: list[tuple[int, int]] = ()) -> int:
    """Tokens of a prompt whose text is ``text_tokens`` bytes, after voices
    [(text bytes, frames)]."""
    speaker = len(_text(SPEAKER))
    return 1 + sum(speaker + tb + n + 1 for tb, n in voices) + speaker + text_tokens
