"""DTW token-level timestamps from cross-attention alignment heads.

Counterpart of whisper_tpu/decoding/dtw.py (reference
whisper_exp_compute_token_level_timestamps_dtw, src/whisper.cpp:8772-8931,
dtw_and_backtrace :8647-8730, median_filter :8737-8769; OpenAI
whisper/timing.py):

 1. the token sequence [SOT, (lang), NOT, text..., EOT] is decoded once
    more with cross-attention capture (models/whisper.py collect_cross_qk,
    the plain attention: the flash kernel never materialises the
    probabilities);
 2. the preset's (text_layer, head) alignment heads are gathered on the
    device and copied to the host;
 3. the audio axis is cropped to n_frames/2, z-normalized over the token
    axis, median-filtered (reflect pad) over the audio axis, averaged over
    the heads and negated;
 4. the DTW dynamic program + backtrace over the (tokens x frames) cost
    matrix, on the host (inherently sequential): in the host C++ runtime
    (runtime/native.py) when it is built, else in the Python loop below;
 5. where the path's token index steps, t_dtw = 2*time + seek.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from whisper_tpu_torch.config import (
    ALIGNMENT_HEADS,
    AlignmentHeadsPreset,
    ContextParams,
    WhisperHParams,
)


def resolve_alignment_heads(cparams: ContextParams, hp: WhisperHParams) -> List[Tuple[int, int]]:
    """(text_layer, head) pairs for the configured preset
    (reference get_alignment_heads_by_layer, src/whisper.cpp:8622-8641)."""
    mode = cparams.dtw.mode
    if mode == AlignmentHeadsPreset.NONE:
        return []
    if mode == AlignmentHeadsPreset.N_TOP_MOST:
        n_top = cparams.dtw.n_top if cparams.dtw.n_top > 0 else hp.n_text_layer
        return [(l, h) for l in range(hp.n_text_layer - n_top, hp.n_text_layer)
                for h in range(hp.n_text_head)]
    if mode == AlignmentHeadsPreset.CUSTOM:
        return list(cparams.dtw.custom_aheads)
    return list(ALIGNMENT_HEADS[mode])


def median_filter_reflect(x: np.ndarray, width: int) -> np.ndarray:
    """Median filter along the last axis with reflect padding
    (reference :8737-8769)."""
    assert width % 2 == 1
    n = x.shape[-1]
    assert width < n
    idx = np.arange(n)[:, None] + np.arange(-(width // 2), width // 2 + 1)[None, :]
    idx = np.where(idx < 0, -idx, idx)
    idx = np.where(idx >= n, 2 * (n - 1) - idx, idx)
    return np.median(x[..., idx], axis=-1)


def dtw_path(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Monotonic alignment path through cost matrix x (N tokens x M frames).
    Returns (text_indices, time_indices), matching OpenAI timing.py's dtw
    (reference dtw_and_backtrace :8647-8730). The host runtime computes
    the same path when it is built; this loop serves when it is not."""
    from whisper_tpu_torch.runtime import native
    nat = native.dtw(np.ascontiguousarray(x, np.float32))
    if nat is not None:
        return nat

    N, M = x.shape
    cost = np.full((N + 1, M + 1), np.inf, dtype=np.float64)
    trace = np.full((N + 1, M + 1), -1, dtype=np.int32)
    cost[0, 0] = 0.0

    for j in range(1, M + 1):
        c_prev_col = cost[:, j - 1]
        # row-sequential DP (the cost[i-1, j] dependency prevents vectorizing)
        for i in range(1, N + 1):
            c0 = c_prev_col[i - 1]
            c1 = cost[i - 1, j]
            c2 = c_prev_col[i]
            if c0 < c1 and c0 < c2:
                c, t = c0, 0
            elif c1 < c0 and c1 < c2:
                c, t = c1, 1
            else:
                c, t = c2, 2
            cost[i, j] = x[i - 1, j - 1] + c
            trace[i, j] = t

    trace[0, :] = 2
    trace[:, 0] = 1

    i, j = N, M
    text_idx, time_idx = [], []
    while i > 0 or j > 0:
        text_idx.append(i - 1)
        time_idx.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i -= 1
            j -= 1
        elif t == 1:
            i -= 1
        else:  # t == 2
            j -= 1
    return np.array(text_idx[::-1]), np.array(time_idx[::-1])


def _extract_alignment(cross_qk: torch.Tensor, aheads, n_audio_tokens: int) -> np.ndarray:
    """(L, 1, H, T, Ta) device tensor -> (N_heads, T, n_audio_tokens)
    float32 on the host (one gather on the device, one copy)."""
    dev = cross_qk.device
    layers = torch.tensor([l for l, _ in aheads], device=dev)
    heads = torch.tensor([h for _, h in aheads], device=dev)
    w = cross_qk[layers, 0, heads, :, :n_audio_tokens]
    return w.float().cpu().numpy()


def compute_dtw_timestamps(
    state,
    params,
    segments: Sequence,
    seek: int,
    n_frames: int,
    medfilt_width: int = 7,
) -> None:
    """Stamp t_dtw on the text tokens of `segments` (emitted this window).

    reference :8772-8931. Runs one extra decode of the window's token
    sequence with a fresh KV cache (the reference clears kv_self)."""
    from whisper_tpu_torch.models import whisper as model_mod

    ctx = state.ctx
    hp = ctx.hparams
    vocab = ctx.vocab

    aheads = resolve_alignment_heads(ctx.cparams, hp)
    if not aheads or not segments:
        return
    assert medfilt_width % 2 == 1

    # token sequence: sot + [lang] + text tokens + eot (:8800-8817)
    tokens = [vocab.token_sot]
    if hp.is_multilingual:
        tokens.append(vocab.token_lang(state.lang_id))
    sot_len = len(tokens)
    tokens.append(vocab.token_not)
    text_token_refs = []
    for seg in segments:
        for td in seg.tokens:
            if td.id < vocab.token_eot:
                tokens.append(td.id)
                text_token_refs.append(td)
    tokens.append(vocab.token_eot)

    # a fresh compute-dtype cache (also under kv_dtype="int8", as in the
    # JAX package)
    n_tok = len(tokens)
    kv = model_mod.KVCache.zeros(hp, 1, ctx.dtype, ctx.device,
                                 size=-(-n_tok // 128) * 128, tp=ctx.tp)
    _, _, cross_qk = model_mod.decoder_forward(
        ctx.params, hp, torch.tensor([tokens], device=ctx.device), 0, kv,
        state.cross_k, state.cross_v, ctx.dtype,
        collect_cross_qk=True, logit_rows=0, tp=ctx.tp)   # QKs only: one logit row

    n_audio_tokens = max(1, n_frames // 2)
    n_audio_tokens = min(n_audio_tokens, cross_qk.shape[-1])
    w = _extract_alignment(cross_qk, aheads, n_audio_tokens)
    del cross_qk

    # z-normalize over the token axis per (head, frame) (:8860-8866)
    mean = w.mean(axis=1, keepdims=True)
    std = w.std(axis=1, keepdims=True)
    w = (w - mean) / np.sqrt(std**2 + 1e-9)

    w = median_filter_reflect(w, medfilt_width)      # over audio frames
    matrix = -w.mean(axis=0)                          # (T, Ta'), negated

    # drop sot sequence and trailing EOT rows (:8880-8884)
    matrix = matrix[sot_len : n_tok - 1]

    text_idx, time_idx = dtw_path(matrix.astype(np.float64))

    # walk the path; the first row of `matrix` is the NOT token, which the
    # reference skips via its "only text tokens" walker (:8901-8916)
    last_v = 0
    ti = 0
    for k in range(len(text_idx)):
        v = int(text_idx[k])
        if v != last_v:
            timestamp = int(time_idx[k]) * 2 + seek
            last_v = v
            if ti < len(text_token_refs):
                text_token_refs[ti].t_dtw = timestamp
                ti += 1
