"""Logit-filter pipeline on torch tensors.

Counterpart of whisper_tpu/decoding/filters.py. Reproduces the reference's
whisper_process_logits rule set IN ORDER (src/whisper.cpp:6183-6417):

 1. suppress blank at initial step (EOT + " ")            (:6186-6193)
 2. suppress <|notimestamps|>; all timestamps if no_timestamps (:6195-6202)
 3. suppress SOT, NOSP                                    (:6204-6206)
 4. suppress SOLM unless tdrz                             (:6208-6211)
 5. suppress task tokens translate/transcribe/prev        (:6213-6222)
 6. suppress lang tokens                                  (:6218-6220)
 7. user logits_filter_callback                           (:6224-6226) [host loop]
 8. suppress_regex matches                                (:6228-6237) [static mask]
 9. suppress non-speech tokens if suppress_nst            (:6239-6259) [static mask]
10. timestamp pairing rules                               (:6262-6281)
11. max_initial_ts at initial step                        (:6283-6292)
12. monotonic timestamps (>= seek_delta/2 when has_ts)    (:6294-6302)
13. log_softmax -> logprobs                               (:6305)
14. timestamp-vs-text logsumexp rule                      (:6307-6358)
15. grammar penalty, unless timestamps were forced      (:6344-6390)

Static rules (1-9, 11) are boolean masks built host-side once per (vocab,
params); the dynamic rules (10, 12, 14) are computed on the device each
step, batched over the decoders.
"""

from __future__ import annotations

import re
from typing import NamedTuple, Optional

import numpy as np
import torch

from whisper_tpu_torch.config import CHUNK_SIZE, FullParams, WhisperHParams
from whisper_tpu_torch.tokenizer import WhisperVocab

NEG_INF = float("-inf")

# reference src/whisper.cpp:6102-6107
NON_SPEECH_TOKENS = [
    "\"", "#", "(", ")", "*", "+", "/", ":", ";", "<", "=", ">", "@", "[",
    "\\", "]", "^", "_", "`", "{", "|", "}", "~", "「", "」", "『", "』",
    "<<", ">>", "<<<", ">>>", "--", "---", "-(", "-[", "('", "(\"", "((",
    "))", "(((", ")))", "[[", "]]", "{{", "}}", "♪♪", "♪♪♪", "♩", "♪",
    "♫", "♬", "♭", "♮", "♯",
]


class TokenIds(NamedTuple):
    """Special-token ids the per-step filters need."""

    eot: int
    beg: int
    nosp: int
    n_vocab: int


class FilterConsts(NamedTuple):
    """Device-resident constants driving the per-step filters."""

    suppress_always: torch.Tensor   # (V,) bool — rules 2-6, 8, 9
    suppress_initial: torch.Tensor  # (V,) bool — rule 1 (blank) + rule 11 (max_initial_ts)


def build_filter_consts(
    vocab: WhisperVocab,
    hp: WhisperHParams,
    params: FullParams,
    device="cpu",
):
    V = vocab.n_vocab
    always = np.zeros(V, bool)
    initial = np.zeros(V, bool)

    # rule 1: suppress blank at initial (EOT + " ")
    if params.suppress_blank:
        initial[vocab.token_eot] = True
        space = vocab.token_to_id.get(b" ")
        if space is not None:
            initial[space] = True

    # rule 2: <|notimestamps|> always; all timestamps if no_timestamps
    always[vocab.token_not] = True
    if params.no_timestamps:
        always[vocab.token_beg :] = True

    # rules 3-6
    always[vocab.token_sot] = True
    always[vocab.token_nosp] = True
    if not params.tdrz_enable:
        always[vocab.token_solm] = True
    always[vocab.token_translate] = True
    always[vocab.token_transcribe] = True
    always[vocab.token_prev] = True
    for lang_id in range(100):
        t = vocab.token_lang(lang_id)
        if t < V:
            always[t] = True

    # rule 8: suppress_regex. The reference matches token BYTES with
    # std::regex_match (src/whisper.cpp:6232-6238: char-traits regex over
    # the raw token string, one byte = one char), so compile the pattern
    # as bytes — decoding to UTF-8 first would both change `.`/class
    # semantics on multi-byte tokens and silently skip the 128-255 byte
    # tokens (proven divergent by tests/test_reference_parity.py)
    if params.suppress_regex:
        pat = re.compile(params.suppress_regex.encode("utf-8"))
        for tok, tid in vocab.token_to_id.items():
            if pat.fullmatch(tok):
                always[tid] = True

    # rule 9: non-speech tokens
    if params.suppress_nst:
        for t in NON_SPEECH_TOKENS:
            for s in (t, " " + t):
                tid = vocab.token_to_id.get(s.encode("utf-8"))
                if tid is not None:
                    always[tid] = True
        for s in (" -", " '"):
            tid = vocab.token_to_id.get(s.encode("utf-8"))
            if tid is not None:
                always[tid] = True

    # rule 11: initial timestamp cap (max_initial_ts)
    if params.max_initial_ts > 0:
        precision = float(CHUNK_SIZE) / hp.n_audio_ctx
        tid0 = int(round(params.max_initial_ts / precision))
        initial[vocab.token_beg + tid0 + 1 :] = True

    return (
        FilterConsts(
            suppress_always=torch.from_numpy(always).to(device),
            suppress_initial=torch.from_numpy(initial).to(device),
        ),
        TokenIds(eot=vocab.token_eot, beg=vocab.token_beg,
                 nosp=vocab.token_nosp, n_vocab=V),
    )


def apply_filters(
    logits: torch.Tensor,        # (B, V) f32 — raw model logits for the last token
    consts: FilterConsts,
    tid_consts: TokenIds,
    *,
    is_initial: torch.Tensor,    # (B,) bool — no sampled tokens yet
    last_was_ts: torch.Tensor,   # (B,) bool — last sampled token >= beg
    penult_was_ts: torch.Tensor, # (B,) bool — 2nd-to-last >= beg (or <2 tokens)
    has_ts: torch.Tensor,        # (B,) bool — a timestamp was sampled this segment
    seek_delta: torch.Tensor,    # (B,) int — current per-decoder seek delta
    temperature: float,
    grammar_reject: Optional[torch.Tensor] = None,   # (B, V) bool
    grammar_penalty: float = 100.0,
):
    """Returns (logits, logprobs, probs) after the full ordered rule set,
    batched over the decoder rows."""
    V = tid_consts.n_vocab
    beg = tid_consts.beg
    ids = torch.arange(V, device=logits.device)
    is_ts_token = ids >= beg  # (V,)

    # temperature scaling (reference :6170-6174, applied before the filters)
    if temperature > 0.0:
        logits = logits / max(temperature, 1e-8)

    # static rules
    logits = logits.masked_fill(consts.suppress_always[None, :], NEG_INF)
    logits = logits.masked_fill(is_initial[:, None] & consts.suppress_initial[None, :],
                                NEG_INF)

    # rule 10: timestamp pairing
    #   last && penultimate were ts -> no more timestamps
    #   last was ts, penultimate wasn't -> only timestamps or EOT
    suppress_ts = (last_was_ts & penult_was_ts)[:, None] & is_ts_token[None, :]
    text_and_not_eot = (~is_ts_token & (ids < tid_consts.eot))[None, :]
    suppress_text = (last_was_ts & ~penult_was_ts)[:, None] & text_and_not_eot
    logits = logits.masked_fill(suppress_ts | suppress_text, NEG_INF)

    # rule 12: monotonic timestamps
    tid0 = seek_delta // 2                                    # (B,)
    mono = is_ts_token[None, :] & (ids[None, :] < beg + tid0[:, None])
    logits = logits.masked_fill(has_ts[:, None] & mono, NEG_INF)

    # rule 13: log-softmax (matches whisper_compute_logprobs :6110-6129)
    logprobs = torch.log_softmax(logits, dim=-1)

    # rule 14: timestamp-vs-text logsumexp
    ts_logprob = torch.logsumexp(logprobs[:, beg:], dim=-1)   # (B,)
    max_text = logprobs[:, :beg].max(dim=-1).values
    force_ts = ts_logprob > max_text                           # (B,)
    kill_text = force_ts[:, None] & ~is_ts_token[None, :]
    logits = logits.masked_fill(kill_text, NEG_INF)
    logprobs = logprobs.masked_fill(kill_text, NEG_INF)

    # rule 15: grammar penalty — only where timestamps were NOT forced, then
    # log_softmax again (reference :6344-6390)
    if grammar_reject is not None:
        apply_g = (~force_ts)[:, None] & grammar_reject
        logits = torch.where(apply_g, logits - grammar_penalty, logits)
        dead = torch.isinf(logits)
        logprobs2 = torch.log_softmax(logits.masked_fill(dead, NEG_INF), dim=-1)
        logprobs2 = logprobs2.masked_fill(dead, NEG_INF)
        logprobs = torch.where(force_ts[:, None], logprobs, logprobs2)

    probs = torch.where(torch.isinf(logprobs), 0.0, torch.exp(logprobs))
    return logits, logprobs, probs


def timestamp_stats(probs: torch.Tensor, tid_consts: TokenIds,
                    default_tid: int = 0):
    """(pt, ptsum, tid): max/sum of timestamp-token probabilities and argmax
    timestamp id (reference whisper_sample_token :6447-6465).

    `default_tid` is the value tid keeps when the timestamp mass is
    all-zero: 0 for greedy/sample (whisper_sample_token's init, :6437 —
    the tid=0 quirk: segment emission then computes t0 = seek +
    2*(0 - token_beg), :7576) but token_beg for BEAM
    (whisper_sample_token_topk initializes `tid = vocab.token_beg`, :6524).
    On non-zero rows tid is the first maximal index, matching the strict
    `<` scan at :6455-6459."""
    beg = tid_consts.beg
    ts_probs = probs[:, beg:]
    ptsum = ts_probs.sum(dim=-1)
    max_ts = ts_probs.max(dim=-1).values
    tid = beg + ts_probs.argmax(dim=-1)
    tid = torch.where(max_ts > 0, tid, torch.full_like(tid, default_tid))
    pt = max_ts / (ptsum + 1e-10)
    return pt, ptsum, tid
