"""Text tokenizer for the PyTorch port.

The port's copy of ``fish_tts_tpu/models/tokenizer.py`` without tiktoken:
the same ``.tiktoken`` vocab loader, special-token table and id layout
(specials follow the mergeable ranks, ``<|semantic:i|>`` ids form one
contiguous block), with the native C++ BPE (``native/bpe.cc``) as the only
encoder and ``decode`` joining the inverted ranks.  The native encoder
implements the same split pattern, literal ``(\\?!\\S)`` group included, so
ids match the JAX package's tokenizer token for token.
"""

from __future__ import annotations

import base64
import json
import re
from pathlib import Path

BOS_TOKEN = "<|begin_of_text|>"
EOS_TOKEN = "<|end_of_text|>"
PAD_TOKEN = "<|pad|>"
IM_START_TOKEN = "<|im_start|>"
IM_END_TOKEN = "<|im_end|>"
PHONEME_START_TOKEN = "<|phoneme_start|>"
PHONEME_END_TOKEN = "<|phoneme_end|>"
TOOL_CALL_START_TOKEN = "<|tool_call_start|>"
TOOL_CALL_END_TOKEN = "<|tool_call_end|>"

MODALITY_TEXT_TOKEN = "<|text|>"
MODALITY_VOICE_TOKEN = "<|voice|>"
MODALITY_INTERLEAVE_TOKEN = "<|interleave|>"
AUDIO_START_TOKEN = "<|audio_start|>"
AUDIO_END_TOKEN = "<|audio_end|>"
AUDIO_EMBED_TOKEN = "<|audio|>"

MODALITY_TOKENS = {
    "text": MODALITY_TEXT_TOKEN,
    "voice": MODALITY_VOICE_TOKEN,
    "interleave": MODALITY_INTERLEAVE_TOKEN,
}

SEMANTIC_TOKEN_TEMPLATE = "<|semantic:{i}|>"
NUM_SEMANTIC_TOKENS = 4096
SEMANTIC_TOKENS = [SEMANTIC_TOKEN_TEMPLATE.format(i=i) for i in range(NUM_SEMANTIC_TOKENS)]

ALL_SPECIAL_TOKENS = [
    BOS_TOKEN,
    EOS_TOKEN,
    PAD_TOKEN,
    IM_START_TOKEN,
    IM_END_TOKEN,
    PHONEME_START_TOKEN,
    PHONEME_END_TOKEN,
    TOOL_CALL_START_TOKEN,
    TOOL_CALL_END_TOKEN,
    MODALITY_TEXT_TOKEN,
    MODALITY_VOICE_TOKEN,
    MODALITY_INTERLEAVE_TOKEN,
    AUDIO_START_TOKEN,
    AUDIO_END_TOKEN,
    AUDIO_EMBED_TOKEN,
    *SEMANTIC_TOKENS,
]

_SEMANTIC_RE = re.compile(r"<\|semantic:(\d+)\|>")
MAX_ENCODE_CHARS = 400_000


def load_tiktoken_bpe(tiktoken_bpe_file: str | Path) -> dict[bytes, int]:
    """Parse a ``.tiktoken`` vocab: one ``<base64-token> <rank>`` pair per
    line; a literal ``=`` placeholder row is dropped."""
    pairs = (
        line.split()
        for line in Path(tiktoken_bpe_file).read_text().splitlines()
        if line
    )
    return {base64.b64decode(tok): int(rank) for tok, rank in pairs if tok != "="}


class FishTokenizer:
    """BPE tokenizer with Fish-Speech special tokens (same surface as the
    JAX package's ``FishTokenizer``)."""

    def __init__(self, model_path: str | Path, special_tokens: list[str] | None = None):
        from fish_tts_tpu_torch.native.bpe import load_native_bpe

        specials = list(special_tokens) if special_tokens is not None else ALL_SPECIAL_TOKENS
        ranks = load_tiktoken_bpe(model_path)
        self._ranks = ranks
        self.all_special_tokens_with_ids = dict(
            zip(specials, range(len(ranks), len(ranks) + len(specials)))
        )
        self.semantic_id_to_token_id = {
            int(m.group(1)): tid
            for tok, tid in self.all_special_tokens_with_ids.items()
            if (m := _SEMANTIC_RE.match(tok))
        }
        if not self.semantic_id_to_token_id:
            raise ValueError("special-token list has no <|semantic:i|> entries")
        self.num_semantic_tokens = max(self.semantic_id_to_token_id) + 1
        self.semantic_begin_id = self.semantic_id_to_token_id[0]
        self.semantic_end_id = self.semantic_id_to_token_id[self.num_semantic_tokens - 1]

        self._native = load_native_bpe(ranks)
        self._decoder: dict[int, bytes] = {r: t for t, r in ranks.items()}
        self._decoder.update(
            {i: t.encode("utf-8") for t, i in self.all_special_tokens_with_ids.items()}
        )
        self._special_split_res: dict[frozenset, re.Pattern] = {}

    @property
    def vocab_size(self) -> int:
        return len(self._ranks)

    def get_token_id(self, token: str) -> int:
        return self.all_special_tokens_with_ids[token]

    @property
    def im_end_id(self) -> int:
        return self.get_token_id(IM_END_TOKEN)

    def _special_split_re(self, allowed: frozenset) -> re.Pattern:
        pat = self._special_split_res.get(allowed)
        if pat is None:
            pat = re.compile("|".join(re.escape(t) for t in sorted(allowed)))
            self._special_split_res[allowed] = pat
        return pat

    def encode(self, s: str, allowed_special: bool | set[str] = True) -> list[int]:
        """Encode text: split on the allowed specials and BPE-encode the
        ordinary text between them (a special that is not allowed is
        ordinary text)."""
        if not isinstance(s, str):
            raise TypeError(f"encode expects str, got {type(s).__name__}")
        if allowed_special is True:
            allowed = set(self.all_special_tokens_with_ids)
        else:
            allowed = (allowed_special or set()) & set(self.all_special_tokens_with_ids)
        out: list[int] = []
        # fixed-size spans, as the JAX package's tokenizer cuts very long text
        for start in range(0, len(s), MAX_ENCODE_CHARS):
            out.extend(self._encode_span(s[start:start + MAX_ENCODE_CHARS], allowed))
        return out

    def _encode_span(self, span: str, allowed: set[str]) -> list[int]:
        native = self._native
        if not allowed:
            return list(native.encode_ordinary(span))
        out: list[int] = []
        pos = 0
        for m in self._special_split_re(frozenset(allowed)).finditer(span):
            if m.start() > pos:
                out.extend(native.encode_ordinary(span[pos:m.start()]))
            out.append(self.all_special_tokens_with_ids[m.group()])
            pos = m.end()
        if pos < len(span):
            out.extend(native.encode_ordinary(span[pos:]))
        return out

    def decode(self, tokens: list[int]) -> str:
        return b"".join(self._decoder[int(t)] for t in tokens).decode(
            "utf-8", errors="replace"
        )

    @classmethod
    def from_pretrained(cls, path: str | Path) -> "FishTokenizer":
        """Load from a checkpoint dir: ``tokenizer.tiktoken`` plus optional
        ``special_tokens.json``."""
        path = Path(path)
        special_tokens_path = path / "special_tokens.json"
        if special_tokens_path.exists():
            with open(special_tokens_path) as f:
                special_tokens = json.load(f)
        else:
            special_tokens = ALL_SPECIAL_TOKENS
        return cls(path / "tokenizer.tiktoken", special_tokens)


def write_tiny_vocab(path: str | Path, num_tokens: int = 256) -> None:
    """Write a byte-level ``.tiktoken`` vocab (256 single-byte tokens, no
    merges): encodes any string without a real checkpoint."""
    lines = [f"{base64.b64encode(bytes([i])).decode()} {i}" for i in range(min(num_tokens, 256))]
    Path(path).write_text("\n".join(lines) + "\n")


def tiny_special_tokens(num_semantic: int) -> list[str]:
    """Special-token list with a reduced semantic range, for tiny configs."""
    base = [t for t in ALL_SPECIAL_TOKENS if not t.startswith("<|semantic:")]
    return base + [SEMANTIC_TOKEN_TEMPLATE.format(i=i) for i in range(num_semantic)]
