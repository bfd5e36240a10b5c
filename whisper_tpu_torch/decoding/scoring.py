"""Sequence scoring + ranking (host side; tiny arrays).

reference whisper_sequence_score (src/whisper.cpp:6566-6613) and the
ranking/fallback logic in whisper_full_with_state (:7483-7543).
"""

from __future__ import annotations

import dataclasses
import math
from collections import Counter
from typing import List, Optional

import numpy as np

from whisper_tpu_torch.config import FullParams


@dataclasses.dataclass
class SequenceScore:
    sum_logprobs: float
    avg_logprobs: float
    entropy: float
    score: float


def score_sequence(
    token_ids: np.ndarray,     # (result_len,)
    token_plogs: np.ndarray,   # (result_len,)
    length_penalty: float,
) -> SequenceScore:
    n = len(token_ids)
    if n == 0:
        return SequenceScore(float("-inf"), float("-inf"), 0.0, float("-inf"))
    s = float(np.sum(token_plogs))
    penalty = float(n)
    if length_penalty > 0:
        penalty = ((5.0 + n) / 6.0) ** length_penalty
    # entropy over the last 32 tokens (:6592-6611)
    window = token_ids[max(0, n - 32):]
    cnt = Counter(window.tolist())
    total = len(window)
    entropy = -sum((c / total) * math.log(c / total) for c in cnt.values())
    return SequenceScore(s, s / n, entropy, s / penalty)


def rank_decoders(
    result,                    # WindowResult (host numpy views)
    params: FullParams,
) -> tuple:
    """Apply entropy-based failure + pick the best decoder
    (reference :7483-7516). Returns (best_idx, scores, failed_mask)."""
    B = result.tokens.shape[0]
    failed = np.asarray(result.failed).copy()
    scores: List[Optional[SequenceScore]] = [None] * B
    best_idx, best_score = 0, float("-inf")
    for j in range(B):
        if failed[j]:
            continue
        rl = int(result.result_len[j])
        sc = score_sequence(
            np.asarray(result.tokens[j][:rl]),
            np.asarray(result.tok_plog[j][:rl]),
            params.length_penalty,
        )
        scores[j] = sc
        if rl > 32 and sc.entropy < params.entropy_thold:
            failed[j] = True    # repetition detected (:7498-7506)
            continue
        if sc.score > best_score:
            best_score = sc.score
            best_idx = j
    return best_idx, scores, failed


def needs_fallback(
    best_failed: bool,
    avg_logprobs: float,
    no_speech_prob: float,
    params: FullParams,
    is_last_temperature: bool,
) -> bool:
    """Temperature-fallback decision (reference :7519-7536)."""
    if is_last_temperature:
        return False
    if best_failed:
        return True
    return (avg_logprobs < params.logprob_thold
            and no_speech_prob < params.no_speech_thold)
