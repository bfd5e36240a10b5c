"""Decode the current window of many utterances at once (continuous
batching).

Counterpart of whisper_tpu/decoding/batch_loop.py, the replacement for
whisper_full_parallel's thread per chunk (reference
src/whisper.cpp:7736-7864): U independent utterances decode their current
30 s windows together, each with its own prompt length, seek bounds and
completion state. Each utterance owns K decoder rows (K = beam_size for
BEAM, best_of for SAMPLE, 1 for greedy), folded into one decoder batch of
B = U*K rows, so every decoder call carries every utterance's rows.

As in decoding/device_loop.py, the loop is a Python loop on the host over
device tensors:

- on the device: the batched prompt pass (U rows at positions 0 with
  per-row logit rows, cross-attention through the flash kernel at U
  encoder copies), one decoder step per token for all B rows at per-row
  positions prompt_len[u] + i (models/whisper.py's merged path), the
  ordered logit filters, timestamp statistics, the argmax / Gumbel-max
  draw and the beam candidates; each grammar-DFA state;
- on the host, per step: the per-row values, the beam cursor per
  utterance group and the state machine with per-row seek bounds.

Beam forks stay block-diagonal: beam_select runs once per utterance group
on that group's K rows, so row u*K+j only ever takes a source among rows
u*K..u*K+K-1 (src = u*K + src_local; the reference's kv_seq_cp within one
state, vmapped over utterances in the JAX package). The KV fork is applied
by the next decoder step (fork_src). Rows of inactive utterances start
completed and never decode.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from whisper_tpu_torch.config import WhisperHParams
from whisper_tpu_torch.decoding.device_loop import (
    BEAM,
    SAMPLE,
    Rows,
    beam_select,
    fetch_candidates,
    fetch_chosen,
    grammar_accept,
    gumbel,
    sample_gumbel_max,
)
from whisper_tpu_torch.decoding.filters import FilterConsts, TokenIds
from whisper_tpu_torch.models import whisper as model_mod
from whisper_tpu_torch.models.whisper import KVCache


class BatchWindowResult(NamedTuple):
    tokens: np.ndarray        # (B, N_MAX) i32 — B = n_utt * rows per utterance
    tok_p: np.ndarray
    tok_plog: np.ndarray
    tok_pt: np.ndarray
    tok_ptsum: np.ndarray
    tok_tid: np.ndarray
    n_tokens: int             # loop steps executed
    result_len: np.ndarray    # (B,)
    seek_delta: np.ndarray    # (B,)
    failed: np.ndarray
    completed: np.ndarray
    sum_logprobs_all: np.ndarray
    no_speech_prob: np.ndarray  # (U,) — one per utterance


def rows_per_utt(strategy: int, beam_size: int, best_of: int = 1) -> int:
    """Decoder rows per utterance for a batch attempt (reference
    n_decoders_cur logic, src/whisper.cpp:7024-7044)."""
    if strategy == BEAM:
        return max(1, beam_size)
    if strategy == SAMPLE:
        return max(1, best_of)
    return 1


def decode_windows_batch(
    params,
    hp: WhisperHParams,
    consts: FilterConsts,
    cross_k, cross_v,          # (L, U, H, Ta, Dh), one encoder copy per utterance;
                               # or (int8 codes, scales) tuples
    prompts,                   # (U, PROMPT_BUCKET) int, right-padded per row
    prompt_len,                # (U,) int
    temperature: float,
    seek,                      # (U,) int
    seek_end,                  # (U,) int
    row_active,                # (U,) bool — False utterances are skipped
    generator: Optional[torch.Generator] = None,   # SAMPLE / multinomial beam
    grammar_reject: Optional[torch.Tensor] = None,  # (S, V) bool — DFA reject rows
    grammar_trans: Optional[torch.Tensor] = None,   # (S, V) int64 — DFA transitions
    grammar_penalty: float = 100.0,
    *,
    tids: TokenIds,
    n_utt: int,
    n_per_utt: int = 1,
    strategy: int,
    max_tokens: int = 0,
    single_segment: bool = False,
    no_timestamps: bool = False,
    dtype=torch.bfloat16,
    kv_quant: bool = False,
    beam_multinomial: bool = False,
    tp=None,                   # model group of tensor parallelism (models/whisper.py)
) -> BatchWindowResult:
    dev = (cross_k[0] if isinstance(cross_k, tuple) else cross_k).device
    V = tids.n_vocab
    U = n_utt
    K = n_per_utt
    B = U * K
    n_max = hp.n_text_ctx // 2 - 4           # reference :7157

    def to_rows(x):
        """(U, ...) -> (B, ...), utterance-major."""
        return np.repeat(np.asarray(x), K, axis=0)

    # ---- batched prompt pass, once per utterance; its KV is copied to the
    # utterance's K rows (the reference decodes the prompt on decoder 0 and
    # kv_seq_cp's it to the others, :7115-7154)
    prompt_len = np.asarray(prompt_len, np.int64)
    kv_u = KVCache.zeros(hp, U, dtype, dev, quant=kv_quant, tp=tp)
    prompt_t = torch.as_tensor(np.asarray(prompts), dtype=torch.long, device=dev)
    plen_t = torch.from_numpy(prompt_len).to(dev)
    logits_p, kv_u, _ = model_mod.decoder_forward(
        params, hp, prompt_t, torch.zeros(U, dtype=torch.long, device=dev), kv_u,
        cross_k, cross_v, dtype, logit_rows=plen_t - 1, tp=tp)
    last_row = logits_p[:, 0].float()                              # (U, V)
    # no_speech prob before any filtering (reference :7124-7134)
    no_speech_prob = torch.softmax(last_row, -1)[:, tids.nosp]
    kv = kv_u if K == 1 else KVCache(*(t.repeat_interleave(K, dim=1)
                                       for t in kv_u.tensors()))
    logits = last_row.repeat_interleave(K, dim=0) if K > 1 else last_row

    plen_row = torch.from_numpy(to_rows(prompt_len)).to(dev)
    seek_row = to_rows(seek).astype(np.int32)
    seek_end_row = to_rows(seek_end).astype(np.int32)

    # per-row state, host side; inactive utterances' rows never decode
    rows = Rows(B, n_max, completed=~to_rows(np.asarray(row_active, bool)))
    default_tid = tids.beg if strategy == BEAM else 0
    identity = np.arange(B)
    gstate = torch.zeros(B, dtype=torch.long, device=dev)   # DFA state 0: the start
    machine = dict(max_tokens=max_tokens, single_segment=single_segment,
                   no_timestamps=no_timestamps, n_max=n_max)

    i = 0
    while i < n_max and not rows.done():
        live = ~(rows.completed | rows.failed)
        logprobs, probs, pt, ptsum, tid = rows.filtered(
            logits, consts, tids, i, temperature, grammar_reject, gstate,
            grammar_penalty, default_tid)

        if strategy == BEAM:
            noise = gumbel((B, K, V), generator, dev) if beam_multinomial else None
            top_lp, top_p, top_id, pt_h, ptsum_h, tid_h = fetch_candidates(
                logprobs, probs, pt, ptsum, tid, K, noise)
            # block-diagonal fork: the beam cursor of each utterance group
            src = identity.copy()
            tok = rows.last_token.copy()
            cand = np.zeros(B, np.int64)
            for u in range(U):
                g = slice(u * K, (u + 1) * K)
                if not live[g].any():
                    continue
                s_l, tok[g], cand[g] = beam_select(
                    top_lp[g], top_id[g], live[g], rows.sum_lp[g], rows.prefix_hash[g],
                    rows.last_token[g], i)
                src[g] = u * K + s_l
            rows.fork(src, tok)
            pt_h, ptsum_h, tid_h = pt_h[src], ptsum_h[src], tid_h[src]
            p_tok, plog_tok = top_p[src, cand], top_lp[src, cand]
        else:
            if strategy == SAMPLE:
                tok_d = sample_gumbel_max(logprobs, gumbel((B, V), generator, dev))
            else:
                tok_d = probs.argmax(dim=-1)
            tok, p_tok, plog_tok, pt_h, ptsum_h, tid_h = fetch_chosen(
                logprobs, probs, pt, ptsum, tid, tok_d)
            src = identity

        # the state machine with per-row seek bounds
        upd = rows.append(i, live, tok, p_tok, plog_tok, pt_h, ptsum_h, tid_h, tids,
                          seek_row, seek_end_row, **machine)
        if grammar_trans is not None:
            gstate = grammar_accept(gstate, grammar_trans, src, tok, upd.live2)

        i += 1
        if i >= n_max or rows.done():
            break   # the next step's logits would never be read
        # ---- next decode step: row b at position prompt_len[b] + i - 1
        fork = (torch.from_numpy(src).to(dev)
                if strategy == BEAM and not np.array_equal(src, identity) else None)
        lg_next, kv, _ = model_mod.decoder_forward(
            params, hp, torch.from_numpy(rows.last_token).to(dev, torch.long)[:, None],
            plen_row + (i - 1), kv, cross_k, cross_v, dtype, fork_src=fork, tp=tp)
        logits = lg_next[:, 0]

    return BatchWindowResult(**rows.result(i), no_speech_prob=no_speech_prob.cpu().numpy())
