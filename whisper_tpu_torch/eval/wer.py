"""Word-error-rate computation over protocol-normalized text.

Counterpart of whisper_tpu/eval/wer.py (host code, no JAX).

reference: tests/librispeech/eval.py:30-46 (jiwer.wer over
EnglishTextNormalizer output). The normalizer is the FULL protocol port
(eval/normalizer.py, validated against the reference's vendored copy by
tests/test_normalizer.py); this environment has no
jiwer, so WER is a direct Levenshtein over words with identical semantics
to jiwer's corpus WER: (S+D+I) / total reference words."""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np

from whisper_tpu_torch.eval.normalizer import (  # noqa: F401  (re-exported API)
    BasicTextNormalizer,
    EnglishTextNormalizer,
)

_NORMALIZER = None


def _default_normalizer() -> EnglishTextNormalizer:
    """Shared instance: construction loads the 1.7k-entry spelling table
    from disk and builds the number-machine vocabularies — per-call
    construction made hot callers (CommandDetector scoring every allowed
    command per utterance) re-do that work constantly."""
    global _NORMALIZER
    if _NORMALIZER is None:
        _NORMALIZER = EnglishTextNormalizer()
    return _NORMALIZER


def _edit_ops(ref: Sequence[str], hyp: Sequence[str]) -> Tuple[int, int, int]:
    """(substitutions+deletions+insertions breakdown) via Levenshtein DP.
    Returns (S, D, I)."""
    n, m = len(ref), len(hyp)
    # dp[i][j] = (cost, S, D, I)
    cost = np.zeros((n + 1, m + 1), np.int32)
    cost[:, 0] = np.arange(n + 1)
    cost[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        ri = ref[i - 1]
        row = cost[i]
        prev = cost[i - 1]
        for j in range(1, m + 1):
            sub = prev[j - 1] + (ri != hyp[j - 1])
            dele = prev[j] + 1
            ins = row[j - 1] + 1
            row[j] = min(sub, dele, ins)
    # backtrace for S/D/I counts
    i, j = n, m
    S = D = I = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and cost[i, j] == cost[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]):
            if ref[i - 1] != hyp[j - 1]:
                S += 1
            i -= 1
            j -= 1
        elif i > 0 and cost[i, j] == cost[i - 1, j] + 1:
            D += 1
            i -= 1
        else:
            I += 1
            j -= 1
    return S, D, I


def _edit_distance(ref: Sequence[str], hyp: Sequence[str]) -> int:
    """Levenshtein distance via a vectorized two-row DP. The corpus metric
    only needs S+D+I (= the distance): the backtracing O(n*m) matrix of
    _edit_ops costs ~1 GB and minutes per hour-long Earnings21
    transcript. The left-to-right insertion dependency is resolved with
    the min-accumulate identity cur[j] = min_{k<=j}(cand[k] + (j-k))."""
    n, m = len(ref), len(hyp)
    if m == 0:
        return n
    if n == 0:
        return m
    hyp_arr = np.array(hyp, dtype=object)
    prev = np.arange(m + 1, dtype=np.int32)
    idx = np.arange(m + 1, dtype=np.int32)
    for i in range(1, n + 1):
        sub = prev[:-1] + (hyp_arr != ref[i - 1])
        dele = prev[1:] + 1
        cand = np.empty(m + 1, np.int32)
        cand[0] = i
        cand[1:] = np.minimum(sub, dele)
        prev = np.minimum.accumulate(cand - idx) + idx
    return int(prev[m])


def wer(references: Iterable[str], hypotheses: Iterable[str],
        normalize: bool = False) -> float:
    """Corpus WER = (S+D+I) / total reference words (jiwer semantics).

    NB on defaults: like jiwer.wer, this scores the texts AS GIVEN
    (normalize=False) — the reference protocol normalizes both sides
    BEFORE scoring (eval.py:30-44), which eval/librispeech.py and
    eval/earnings21.py do via normalize=True. wer_details defaults to
    normalize=True because its consumer (voice-command matching,
    serving/command.py) always wants canonicalized text."""
    norm = _default_normalizer() if normalize else (lambda x: x)
    total_err = 0
    total_ref = 0
    for ref, hyp in zip(references, hypotheses):
        r = norm(ref).split()
        h = norm(hyp).split()
        total_err += _edit_distance(r, h)
        total_ref += len(r)
    return total_err / max(1, total_ref)


def wer_details(reference: str, hypothesis: str, normalize: bool = True):
    norm = _default_normalizer() if normalize else (lambda x: x)
    r = norm(reference).split()
    h = norm(hypothesis).split()
    S, D, I = _edit_ops(r, h)
    return {"wer": (S + D + I) / max(1, len(r)), "sub": S, "del": D,
            "ins": I, "n_ref": len(r)}
