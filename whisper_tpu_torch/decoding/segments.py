"""Segment emission: token stream -> timestamped segments.

reference whisper_full_with_state output block (src/whisper.cpp:7546-7675)
and whisper_wrap_segment (:6030-6100).
"""

from __future__ import annotations

from typing import List

from whisper_tpu_torch.api import Segment, TokenData
from whisper_tpu_torch.config import FullParams
from whisper_tpu_torch.tokenizer import Tokenizer, WhisperVocab


def emit_segments(
    tokens: List[TokenData],
    seek: int,
    seek_delta: int,
    vocab: WhisperVocab,
    tokenizer: Tokenizer,
    params: FullParams,
    no_speech_prob: float,
) -> "List[Segment]":
    """Split a window's token stream at timestamp pairs into segments
    (reference :7563-7655). Timestamps are centiseconds: t = seek +
    2*(tid - beg)."""
    segments: List[Segment] = []
    if not tokens:
        return segments

    beg = vocab.token_beg
    eot = vocab.token_eot

    i0 = 0
    t0 = seek + 2 * (tokens[0].tid - beg)
    text_bytes = b""
    speaker_turn_next = False

    i = 0
    while i < len(tokens):
        td = tokens[i]
        if params.print_special or td.id < eot:
            text_bytes += vocab.id_to_token[td.id] if 0 <= td.id < len(vocab.id_to_token) else b""
        if params.tdrz_enable and td.id == vocab.token_solm:
            speaker_turn_next = True

        if td.id > beg and not params.single_segment:
            t1 = seek + 2 * (td.tid - beg)
            if text_bytes:
                segments.append(Segment(
                    t0=t0, t1=t1,
                    text=text_bytes.decode("utf-8", errors="replace"),
                    tokens=tokens[i0 : i + 1],
                    speaker_turn_next=speaker_turn_next,
                    no_speech_prob=no_speech_prob,
                ))
            text_bytes = b""
            # skip consecutive timestamp tokens (:7639-7643)
            while i < len(tokens) and tokens[i].id > beg:
                i += 1
            i -= 1
            t0 = t1
            i0 = i + 1
            speaker_turn_next = False
        i += 1

    if text_bytes:
        t1 = seek + seek_delta
        segments.append(Segment(
            t0=t0, t1=t1,
            text=text_bytes.decode("utf-8", errors="replace"),
            tokens=tokens[i0:],
            speaker_turn_next=speaker_turn_next,
            no_speech_prob=no_speech_prob,
        ))
    return segments


def _should_split_on_word(text: str, split_on_word: bool) -> bool:
    # reference should_split_on_word (:6021-6027)
    if not split_on_word:
        return True
    return text.startswith(" ")


def wrap_segment(
    segment: Segment,
    vocab: WhisperVocab,
    max_len: int,
    split_on_word: bool,
) -> List[Segment]:
    """Re-split a segment at max_len chars / word boundaries
    (reference whisper_wrap_segment, :6030-6100). Requires token-level
    timestamps (t0/t1 on TokenData) for the split times."""
    if max_len <= 0 or not segment.tokens:
        return [segment]

    out: List[Segment] = []
    acc = ""
    length = 0
    cur_tokens: List[TokenData] = []
    t0 = segment.t0

    for td in segment.tokens:
        if td.id >= vocab.token_eot:
            cur_tokens.append(td)
            continue
        txt = vocab.id_to_token[td.id].decode("utf-8", errors="replace")
        cur = len(txt)
        if length + cur > max_len and length > 0 and _should_split_on_word(txt, split_on_word):
            t_split = td.t0 if td.t0 >= 0 else segment.t1
            out.append(Segment(
                t0=t0, t1=t_split, text=acc, tokens=cur_tokens,
                speaker_turn_next=False, no_speech_prob=segment.no_speech_prob))
            acc = ""
            length = 0
            cur_tokens = []
            t0 = t_split
        acc += txt
        length += cur
        cur_tokens.append(td)

    if cur_tokens or acc:
        out.append(Segment(
            t0=t0, t1=segment.t1, text=acc, tokens=cur_tokens,
            speaker_turn_next=segment.speaker_turn_next,
            no_speech_prob=segment.no_speech_prob))
    return out if out else [segment]


def to_timestamp(t: int, comma: bool = False) -> str:
    """Centiseconds -> "HH:MM:SS.mmm" (reference to_timestamp,
    examples/common-whisper... and src/whisper.cpp:233-246)."""
    msec = t * 10
    hr = msec // (1000 * 60 * 60)
    msec -= hr * 1000 * 60 * 60
    minute = msec // (1000 * 60)
    msec -= minute * 1000 * 60
    sec = msec // 1000
    msec -= sec * 1000
    sep = "," if comma else "."
    return f"{hr:02d}:{minute:02d}:{sec:02d}{sep}{msec:03d}"
