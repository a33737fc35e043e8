"""Prompt assembly: interleaved multimodal content sequences.

The PyTorch port's own copy of ``fish_tts_tpu/models/prompt.py`` (host-side
numpy; no change of behaviour).

Builds the ``(1 + num_codebooks, T)`` prompt matrix the DualAR LM consumes,
matching the reference's ``ContentSequence.encode_for_inference`` contract
(upstream fish-tts ``models/inference.py:467-640``):

- row 0: text-token ids; positions covered by a VQ part carry
  ``semantic_begin_id + code`` instead (inference.py:631-633),
- rows 1..K: codebook values under the VQ mask, zero elsewhere (inference.py:634),
- parts are laid out as ``<|interleave|>`` then per reference
  ``[<|speaker:0|>, text, VQ codes, <|im_end|>]`` and finally
  ``[<|speaker:0|>, target text]`` (inference.py:779-789).

This is host-side numpy (it runs once per synthesize call); the device side
only ever sees the finished int32 matrix.

The training-mode surface (``ContentSequence.encode``, reference
inference.py:523-609) is also implemented: per-position labels with the -100
ignore index, the next-token shift, VQ token/label masks, per-VQ-part loss
flags, and the (always-empty in this model family) audio-part channel.
Nothing in the reference's shipped inference path calls it, but it is part of
the reference API surface and data-pipeline contract.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Literal, Sequence, Union

import numpy as np

from fish_tts_tpu_torch.models.tokenizer import (
    IM_END_TOKEN,
    MODALITY_TOKENS,
    FishTokenizer,
)


@dataclass
class TextPart:
    """A text span (reference inference.py:442-451)."""

    text: str | None = None
    tokens: list[int] | None = None
    cal_loss: bool = False
    type: str = "text"

    def __post_init__(self):
        if self.text is None and self.tokens is None:
            raise ValueError("Either text or tokens must be provided")


@dataclass
class VQPart:
    """A span of audio codes, shape ``(num_codebooks, T)`` with row 0 the
    semantic codebook (reference inference.py:432-439)."""

    codes: np.ndarray
    cal_loss: bool = False
    type: str = "vq"

    def __post_init__(self):
        self.codes = np.asarray(self.codes)


Part = Union[TextPart, VQPart]

_PART_TYPES: dict[str, type] = {"text": TextPart, "vq": VQPart}


def _coerce_part(spec: Part | dict) -> Part:
    """Accept an already-built part or a ``{"type": ..., ...}`` dict (the
    dict-or-dataclass convention of the reference API surface)."""
    if not isinstance(spec, dict):
        return spec
    kwargs = dict(spec)
    kind = kwargs.pop("type", None)
    cls = _PART_TYPES.get(kind)
    if cls is None:
        raise ValueError(f"Unsupported part type: {kind}")
    return cls(**kwargs)


@dataclass
class EncodedPrompt:
    """Result of :meth:`ContentSequence.encode_for_inference`."""

    values: np.ndarray  # (1 + num_codebooks, T) int32
    vq_mask: np.ndarray  # (T,) bool — True where row 0 holds a semantic token


IGNORE_INDEX = -100  # loss ignore index (reference inference.py:585)


@dataclass
class EncodedMessage:
    """Result of the training-mode :meth:`ContentSequence.encode`
    (reference ``EncodedMessage``, inference.py:454-464).

    ``tokens``/``labels`` carry the next-token shift when requested;
    ``vq_mask_tokens``/``vq_mask_labels`` mark which token/label positions
    belong to VQ parts (they differ by one position under the shift).
    ``audio_parts``/``audio_masks`` exist for surface parity — this model
    family has no audio-embedding parts, so the list is always empty and the
    mask all-False.
    """

    tokens: np.ndarray  # (T,) int32
    labels: np.ndarray  # (T,) int32, IGNORE_INDEX where loss is off
    vq_mask_tokens: np.ndarray  # (T,) bool
    vq_mask_labels: np.ndarray  # (T,) bool
    vq_parts: list[np.ndarray] = field(default_factory=list)
    vq_require_losses: np.ndarray | None = None  # (num_vq_parts,) bool
    audio_parts: list[np.ndarray] = field(default_factory=list)
    audio_masks: np.ndarray | None = None  # (T,) bool
    metadata: dict | None = None


class ContentSequence:
    """Flexible sequence of content parts (reference inference.py:467-640)."""

    def __init__(
        self,
        parts: Sequence[Part | dict] | None = None,
        modality: Literal["text", "voice", "interleave"] | None = None,
        metadata: dict | None = None,
    ):
        self.modality = modality
        self.metadata = metadata or {}
        self.parts: list[Part] = [_coerce_part(p) for p in (parts or [])]
        # A modality sequence always opens with its tag token; prepend it
        # unless the caller's first part already carries it.
        if modality is not None and not self._opens_with_modality_tag():
            self.parts.insert(0, TextPart(text=MODALITY_TOKENS[modality]))

    def _opens_with_modality_tag(self) -> bool:
        if not self.parts:
            return False
        head = self.parts[0]
        return (
            isinstance(head, TextPart)
            and head.text is not None
            and head.text.startswith(MODALITY_TOKENS[self.modality])
        )

    def append(
        self,
        part_or_parts: Part | list[Part],
        add_end: bool = False,
        speaker: str | int | None = None,
    ) -> None:
        """Append one layout block: ``[<|speaker:s|>?] parts... [<|im_end|>?]``.

        This is how the per-reference blocks of the inference prompt are
        laid out (reference generate_long, inference.py:783-789).
        """
        block: list[Part] = []
        if speaker is not None:
            block.append(TextPart(text=f"<|speaker:{speaker}|>"))
        block += part_or_parts if isinstance(part_or_parts, list) else [part_or_parts]
        if add_end:
            if not block and not self.parts:
                raise ValueError(
                    "append(add_end=True) on an empty sequence: no part to "
                    "inherit cal_loss from"
                )
            tail = block[-1] if block else self.parts[-1]
            block.append(TextPart(text=IM_END_TOKEN, cal_loss=tail.cal_loss))
        self.parts += block

    def encode(
        self,
        tokenizer: FishTokenizer,
        add_shift: bool = True,
        ignore_loss_tokens: Sequence[str] = (),
    ) -> EncodedMessage:
        """Training-mode encoding with labels (reference inference.py:523-609).

        Per part: token ids; labels are a copy of the tokens where
        ``part.cal_loss`` else ``IGNORE_INDEX``.  VQ parts contribute their
        semantic row as token ids (``semantic_begin_id + code``) and their
        full code matrix to ``vq_parts``.  With ``add_shift`` the usual
        next-token alignment drops the last token and the first label (so
        ``labels[t]`` is the target for ``tokens[t]``); the VQ masks shift
        with their respective streams.  ``ignore_loss_tokens`` names special
        tokens whose label positions are forced to ``IGNORE_INDEX`` after the
        shift (reference inference.py:595-596).
        """
        ignore_ids = [tokenizer.get_token_id(t) for t in ignore_loss_tokens]

        tok_chunks: list[np.ndarray] = []
        label_chunks: list[np.ndarray] = []
        mask_chunks: list[np.ndarray] = []
        vq_parts: list[np.ndarray] = []
        vq_require_losses: list[bool] = []

        for part in self.parts:
            if isinstance(part, TextPart):
                toks = (
                    tokenizer.encode(part.text) if part.tokens is None
                    else list(part.tokens)
                )
                toks = np.asarray(toks, dtype=np.int32)
                mask_chunks.append(np.zeros(len(toks), dtype=bool))
            elif isinstance(part, VQPart):
                codes = np.asarray(part.codes, dtype=np.int32)
                if codes.ndim != 2 or codes.shape[0] < 1:
                    raise ValueError(
                        f"VQPart codes must be (num_codebooks, T), got "
                        f"{codes.shape}"
                    )
                if vq_parts and codes.shape[0] != vq_parts[0].shape[0]:
                    raise ValueError(
                        "VQPart codebook counts differ within one sequence: "
                        f"{vq_parts[0].shape[0]} vs {codes.shape[0]}"
                    )
                toks = (codes[0] + tokenizer.semantic_begin_id).astype(np.int32)
                mask_chunks.append(np.ones(len(toks), dtype=bool))
                vq_parts.append(codes)
                vq_require_losses.append(bool(part.cal_loss))
            else:
                raise ValueError(f"Unsupported part type: {type(part)}")
            tok_chunks.append(toks)
            label_chunks.append(
                toks.copy() if part.cal_loss
                else np.full_like(toks, IGNORE_INDEX)
            )

        tokens = np.concatenate(tok_chunks) if tok_chunks else np.zeros(0, np.int32)
        labels = np.concatenate(label_chunks) if label_chunks else np.zeros(0, np.int32)
        vq_mask = np.concatenate(mask_chunks) if mask_chunks else np.zeros(0, bool)
        vq_mask_tokens = vq_mask
        vq_mask_labels = vq_mask

        if add_shift:
            tokens = tokens[:-1]
            labels = labels[1:]
            vq_mask_tokens = vq_mask_tokens[:-1]
            vq_mask_labels = vq_mask_labels[1:]

        for i in ignore_ids:
            labels = np.where(labels == i, IGNORE_INDEX, labels)

        return EncodedMessage(
            tokens=tokens,
            labels=labels.astype(np.int32),
            vq_mask_tokens=vq_mask_tokens,
            vq_mask_labels=vq_mask_labels,
            vq_parts=vq_parts,
            vq_require_losses=np.asarray(vq_require_losses, dtype=bool),
            audio_parts=[],
            audio_masks=np.zeros(len(tokens), dtype=bool),
            metadata=self.metadata,
        )

    def encode_for_inference(
        self, tokenizer: FishTokenizer, num_codebooks: int
    ) -> EncodedPrompt:
        """Token-ize all parts into the ``(1+K, T)`` prompt matrix."""
        token_chunks: list[np.ndarray] = []
        mask_chunks: list[np.ndarray] = []
        vq_chunks: list[np.ndarray] = []

        for part in self.parts:
            if isinstance(part, TextPart):
                if part.tokens is None:
                    toks = tokenizer.encode(part.text)
                else:
                    toks = list(part.tokens)
                toks = np.asarray(toks, dtype=np.int32)
                token_chunks.append(toks)
                mask_chunks.append(np.zeros(len(toks), dtype=bool))
            elif isinstance(part, VQPart):
                codes = np.asarray(part.codes, dtype=np.int32)
                if codes.ndim != 2 or codes.shape[0] != num_codebooks:
                    raise ValueError(
                        f"VQPart codes must be ({num_codebooks}, T), got {codes.shape}"
                    )
                # Row 0 of the prompt matrix holds the *token id* of each
                # semantic code (semantic_begin_id + code), reference
                # inference.py:553-559, 631-633.
                sem_tokens = codes[0] + tokenizer.semantic_begin_id
                token_chunks.append(sem_tokens.astype(np.int32))
                mask_chunks.append(np.ones(codes.shape[1], dtype=bool))
                vq_chunks.append(codes)
            else:
                raise ValueError(f"Unsupported part type: {type(part)}")

        tokens = (
            np.concatenate(token_chunks) if token_chunks else np.zeros(0, np.int32)
        )
        vq_mask = np.concatenate(mask_chunks) if mask_chunks else np.zeros(0, bool)

        values = np.zeros((num_codebooks + 1, len(tokens)), dtype=np.int32)
        values[0] = tokens
        if vq_chunks:
            all_codes = np.concatenate(vq_chunks, axis=1)
            values[1:, vq_mask] = all_codes
        return EncodedPrompt(values=values, vq_mask=vq_mask)


def build_prompt(
    tokenizer: FishTokenizer,
    text: str,
    num_codebooks: int,
    prompt_texts: Sequence[str] = (),
    prompt_codes: Sequence[np.ndarray] = (),
) -> EncodedPrompt:
    """Assemble the full inference prompt as the reference does
    (``generate_long``, inference.py:779-795): an ``<|interleave|>`` modality
    tag, one ``[speaker, text, codes, <|im_end|>]`` block per voice reference,
    then ``[speaker, target text]`` with no end tag.

    A mismatched reference list raises (the reference silently generates
    without the prompt when either half is missing, inference.py:767-773 —
    a dropped voice reference is a bug worth surfacing, and ``python -O``
    would strip an assert into silent zip truncation)."""
    if len(prompt_texts) != len(prompt_codes):
        raise ValueError(
            f"prompt_texts ({len(prompt_texts)}) and prompt_codes "
            f"({len(prompt_codes)}) must pair up one reference each"
        )
    seq = ContentSequence(modality="interleave")
    for t, c in zip(prompt_texts, prompt_codes):
        seq.append([TextPart(text=t), VQPart(codes=c)], add_end=True, speaker=0)
    seq.append([TextPart(text=text)], add_end=False, speaker=0)
    return seq.encode_for_inference(tokenizer, num_codebooks)
