"""Whisper vocabulary + GPT-2-style tokenizer.

Reproduces the reference's tokenizer behavior:
- vocab container + special-token ids with multilingual shift
  (reference src/whisper.cpp:462-492, 1606-1692)
- extra-token synthesis for n_vocab > stored vocab ([_TT_i], [_EOT_], ...)
  (reference src/whisper.cpp:1659-1690)
- GPT-2 regex word split + greedy longest-match tokenize — no BPE merge
  table; relies on the vocab containing merged tokens
  (reference src/whisper.cpp:3288-3336)

Tokens are stored as raw *bytes* (the ggml checkpoint stores UTF-8 byte
strings; multi-byte characters may split across tokens, so decoding
concatenates bytes before UTF-8 decoding).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

from whisper_tpu_torch import languages

# GPT-2 word-split pattern (reference src/whisper.cpp:3285-3295). The
# reference comment cites the Unicode \p{L}/\p{N} pattern, but the code it
# actually runs is `std::regex` over the raw *bytes* of a std::string in the
# default "C" locale, where `[[:alpha:]]` is [A-Za-z], `[[:digit:]]` is
# [0-9], and `\s` is ASCII whitespace — every byte >= 0x80 (all non-ASCII
# text) falls into the `[^\s[:alpha:][:digit:]]` catch-all run. A Python
# bytes-regex reproduces those byte-level semantics exactly (an earlier
# revision used Unicode classes `[^\W\d_]`/`\d`, which provably diverges on
# mixed ASCII/non-ASCII words like "café" and drops "_" entirely).
_SPLIT_RE = re.compile(
    rb"'s|'t|'re|'ve|'m|'ll|'d"
    rb"| ?[A-Za-z]+"
    rb"| ?[0-9]+"
    rb"| ?[^\sA-Za-z0-9]+"
    rb"|\s+(?!\S)|\s+"
)


class WhisperVocab:
    """Vocabulary + special tokens (reference whisper_vocab, src/whisper.cpp:462-492)."""

    def __init__(self, n_vocab: int, tokens: Sequence[bytes]):
        self.n_vocab = n_vocab
        # defaults are the English-model ids (reference src/whisper.cpp:473-484)
        self.token_eot = 50256
        self.token_sot = 50257
        self.token_translate = 50357
        self.token_transcribe = 50358
        self.token_solm = 50359
        self.token_prev = 50360
        self.token_nosp = 50361
        self.token_not = 50362
        self.token_beg = 50363

        if self.is_multilingual:
            # reference src/whisper.cpp:1643-1657
            self.token_eot += 1
            self.token_sot += 1
            dt = self.num_languages - 98
            self.token_translate += dt
            self.token_transcribe += dt
            self.token_solm += dt
            self.token_prev += dt
            self.token_nosp += dt
            self.token_not += dt
            self.token_beg += dt

        self.id_to_token: List[bytes] = list(tokens)
        # synthesize names for extra ids (reference src/whisper.cpp:1659-1690)
        for i in range(len(tokens), n_vocab):
            if i > self.token_beg:
                word = f"[_TT_{i - self.token_beg}]"
            elif i == self.token_eot:
                word = "[_EOT_]"
            elif i == self.token_sot:
                word = "[_SOT_]"
            elif i == self.token_translate:
                word = "[_TRANSLATE_]"
            elif i == self.token_transcribe:
                word = "[_TRANSCRIBE_]"
            elif i == self.token_solm:
                word = "[_SOLM_]"
            elif i == self.token_prev:
                word = "[_PREV_]"
            elif i == self.token_nosp:
                word = "[_NOSP_]"
            elif i == self.token_not:
                word = "[_NOT_]"
            elif i == self.token_beg:
                word = "[_BEG_]"
            elif self.token_sot < i <= self.token_sot + self.num_languages:
                word = f"[_LANG_{languages.lang_str(i - self.token_sot - 1)}]"
            else:
                word = f"[_extra_token_{i}]"
            self.id_to_token.append(word.encode("utf-8"))

        self.token_to_id: Dict[bytes, int] = {}
        for i, tok in enumerate(self.id_to_token):
            self.token_to_id[tok] = i  # later ids win, matching std::map insert-overwrite

    @property
    def is_multilingual(self) -> bool:
        return self.n_vocab >= 51865

    @property
    def num_languages(self) -> int:
        return self.n_vocab - 51765 - (1 if self.is_multilingual else 0)

    def token_lang(self, lang_id: int) -> int:
        """Language token id (reference whisper_token_lang, src/whisper.cpp:4249)."""
        return self.token_sot + 1 + lang_id

    def is_timestamp(self, token_id: int) -> bool:
        return token_id >= self.token_beg

    def timestamp_to_time(self, token_id: int) -> int:
        """Timestamp token -> centiseconds (t units of 10ms are 2*(tid-beg);
        reference src/whisper.cpp:7577)."""
        return 2 * (token_id - self.token_beg)


class Tokenizer:
    """Greedy longest-match tokenizer over a WhisperVocab."""

    def __init__(self, vocab: WhisperVocab):
        self.vocab = vocab

    def encode(self, text: str) -> List[int]:
        """reference tokenize() (src/whisper.cpp:3288-3336)."""
        out: List[int] = []
        for m in _SPLIT_RE.finditer(text.encode("utf-8")):
            word = m.group(0)
            if not word:
                continue
            i, n = 0, len(word)
            while i < n:
                j = n
                found = False
                while j > i:
                    tid = self.vocab.token_to_id.get(word[i:j])
                    if tid is not None:
                        out.append(tid)
                        i = j
                        found = True
                        break
                    j -= 1
                if not found:
                    i += 1  # skip unknown byte (reference logs "unknown token")
        return out

    def decode(self, tokens: Sequence[int], skip_special: bool = True) -> str:
        buf = b""
        for t in tokens:
            if skip_special and t >= self.vocab.token_eot:
                continue
            if 0 <= t < len(self.vocab.id_to_token):
                buf += self.vocab.id_to_token[t]
        return buf.decode("utf-8", errors="replace")

    def token_str(self, token_id: int) -> Optional[str]:
        """Single-token text (reference whisper_token_to_str); lossy on partial UTF-8."""
        if 0 <= token_id < len(self.vocab.id_to_token):
            return self.vocab.id_to_token[token_id].decode("utf-8", errors="replace")
        return None


def synthetic_vocab(n_vocab: int = 51864) -> WhisperVocab:
    """Build a deterministic stand-in vocab for tests/benches when no real
    checkpoint is available (the reference's CI runs with stub models too —
    sys/whisper.cpp/tests/CMakeLists.txt:18-91). Token 0..255 are single
    bytes; others get synthetic names. A few common words/punctuation are
    included so tokenize/decode round-trips are meaningful in tests."""
    toks: List[bytes] = [bytes([b]) for b in range(256)]
    extras = [
        b" the", b" a", b" and", b" of", b" to", b"ing", b"ed", b" country",
        b" ask", b" not", b" what", b" you", b" can", b" do", b" for", b" your",
        b".", b",", b"!", b"?", b" ", b"er", b"on", b"at", b"en", b" is",
    ]
    toks.extend(extras)
    i = 0
    while len(toks) < min(n_vocab, 50256):
        toks.append(f"<syn{i}>".encode())
        i += 1
    return WhisperVocab(n_vocab, toks[: min(n_vocab, 50256)])
