"""Decode one 30 s window at one temperature.

Counterpart of whisper_tpu/decoding/device_loop.py (the reference's token
loop, whisper_full_with_state src/whisper.cpp:7115-7477), with the same
semantics and the same WindowResult. The JAX package runs the whole window
as one jitted lax.while_loop; here the loop is a Python loop on the host
over device tensors:

- on the device: the prompt pass, one decoder step per token, the ordered
  logit filters, timestamp statistics, the greedy argmax / Gumbel-max draw,
  and the beam candidates (top-k);
- on the host, per step: the few per-decoder values (B <= 8), the beam
  cursor over the B*k candidates (beam_select) and the per-decoder state
  machine (decoding/state_machine.py), on numpy.

Matching reference semantics:
- sampling: whisper_sample_token (:6432-6493); beam candidates are the
  deterministic top-k by default, or k Gumbel-max draws with
  beam_multinomial (whisper_sample_token_topk's law, :6548-6558)
- beam candidate sort + dedup + KV fork (:7239-7290); the fork is applied
  to the cache by the next decoder step (models/whisper.py fork_src)
- per-decoder update rules (:7297-7378)
- no_speech_prob from the prompt-pass NOSP logit (:7124-7134)
- a grammar compiled to a token DFA (decoding/grammar_dfa.py): each
  decoder's DFA state stays on the device; its reject row is gathered
  before the filters (the penalty of whisper_suppress_invalid_grammar,
  :6336) and the transition on the chosen token is looked up for the rows
  still live (whisper_grammar_accept_token, :7329); the state follows the
  beam fork.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from whisper_tpu_torch.config import CHUNK_SIZE, WhisperHParams
from whisper_tpu_torch.decoding import state_machine
from whisper_tpu_torch.decoding.filters import (
    FilterConsts, TokenIds, apply_filters, timestamp_stats)
from whisper_tpu_torch.models import whisper as model_mod
from whisper_tpu_torch.models.whisper import KVCache

NEG_INF = float("-inf")
HASH_MULT = np.uint32(1000003)

# sampling strategies
GREEDY_BEST = 0   # t == 0, argmax
SAMPLE = 1        # t > 0, multinomial over filtered probs
BEAM = 2          # beam search (t == 0 under BEAM_SEARCH strategy)


def gumbel(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel noise, -log(Exp(1)), from `generator`."""
    e = torch.empty(shape, dtype=torch.float32, device=device)
    return -e.exponential_(generator=generator).log()


def sample_gumbel_max(logprobs: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """One draw per row from softmax(logprobs): argmax(logprobs + Gumbel);
    suppressed (-inf) tokens are never drawn."""
    pert = torch.where(torch.isinf(logprobs), NEG_INF, logprobs + noise)
    return pert.argmax(dim=-1)


def beam_candidates(logprobs: torch.Tensor, k: int, noise=None) -> torch.Tensor:
    """(B, k) candidate token ids per decoder row: the top-k with ties to
    the lower token id (lax.top_k's order; a stable descending sort gives
    it), or with `noise` (B, k, V) k independent Gumbel-max draws
    (FullParams.beam_search.multinomial_candidates)."""
    if noise is None:
        return torch.sort(logprobs, dim=-1, descending=True, stable=True).indices[:, :k]
    return sample_gumbel_max(logprobs[:, None, :], noise)


def beam_select(top_lp, top_id, live, sum_logprobs, prefix_hash, last_token, i):
    """Beam candidate sort + slot assignment for ONE beam group, on host
    numpy, exactly mirroring the reference cursor machine
    (src/whisper.cpp:7239-7290; the JAX package's beam_select):

    - top_lp / top_id (B, k): each decoder's candidates; dead decoders
      contribute none. One global sort by cumulative logprob desc, ties to
      the lower decoder index (:7240-7248).
    - a single cursor walks the sorted list; each live slot takes the
      candidate at the cursor, then the cursor skips past immediately
      following candidates whose full token sequence equals the one just
      taken (:7265-7267; equal sequences have equal scores, so they are
      adjacent);
    - when the cursor runs off the end it WRAPS to 0 (:7260-7262).

    Sequence equality is a rolling 32-bit hash of the token vector
    (prefix_hash * HASH_MULT + tok). Returns (src, tok, cand): the source
    slot, the token and its column in top_* per slot."""
    B, k = top_lp.shape
    nc_max = B * k
    cand_score = (sum_logprobs[:, None] + top_lp).reshape(-1)
    cand_dead = np.repeat(~live, k)
    cand_tok = top_id.reshape(-1).astype(np.int32)
    cand_src = np.repeat(np.arange(B), k)
    cand_hash = prefix_hash[cand_src] * HASH_MULT + cand_tok.astype(np.uint32)

    # primary: live first; secondary: score desc; stable -> lower decoder
    # index on ties (the reference comparator, :7243-7248)
    order = np.lexsort((-cand_score, cand_dead))
    n_cand = int(np.sum(~cand_dead))

    c = 0
    src = np.arange(B)
    tok = np.array(last_token, dtype=np.int32)
    cand = np.zeros(B, np.int64)
    for j in range(B):
        c0 = 0 if c >= n_cand else c                       # wrap (:7260)
        idx = order[c0]
        h = cand_hash[idx]
        cc = c0 + 1
        while (cc < n_cand and cand_hash[order[min(cc, nc_max - 1)]] == h
               and i > 0):
            cc += 1
        if live[j]:
            src[j], tok[j], cand[j] = cand_src[idx], cand_tok[idx], idx % k
            c = cc
    return src, tok, cand


class WindowResult(NamedTuple):
    tokens: np.ndarray        # (B, N_MAX) i32
    tok_p: np.ndarray         # (B, N_MAX) f32
    tok_plog: np.ndarray      # (B, N_MAX) f32
    tok_pt: np.ndarray        # (B, N_MAX) f32
    tok_ptsum: np.ndarray     # (B, N_MAX) f32
    tok_tid: np.ndarray       # (B, N_MAX) i32
    n_tokens: int             # loop steps executed
    result_len: np.ndarray    # (B,) i32
    seek_delta: np.ndarray    # (B,) i32
    failed: np.ndarray        # (B,) bool
    completed: np.ndarray     # (B,) bool
    sum_logprobs_all: np.ndarray  # (B,) f32
    no_speech_prob: float


def decode_window(
    params,
    hp: WhisperHParams,
    consts: FilterConsts,
    cross_k, cross_v,          # (L, 1, H, Ta, Dh) — shared by the decoders;
                               # or (int8 codes, scales) tuples
    prompt,                    # (PROMPT_BUCKET,) int, right-padded
    prompt_len: int,
    temperature: float,
    seek: int,
    seek_end: int,
    generator: Optional[torch.Generator] = None,   # SAMPLE / multinomial beam
    grammar_reject: Optional[torch.Tensor] = None,  # (S, V) bool — DFA reject rows
    grammar_trans: Optional[torch.Tensor] = None,   # (S, V) int64 — DFA transitions
    grammar_penalty: float = 100.0,                 # logit penalty for rejected tokens
    *,
    tids: TokenIds,
    n_dec: int,
    strategy: int,
    beam_size: int = 5,
    max_tokens: int = 0,
    single_segment: bool = False,
    no_timestamps: bool = False,
    dtype=torch.bfloat16,
    beam_multinomial: bool = False,
    kv_quant: bool = False,
) -> WindowResult:
    dev = (cross_k[0] if isinstance(cross_k, tuple) else cross_k).device
    V = tids.n_vocab
    B = n_dec
    k = beam_size
    n_max = hp.n_text_ctx // 2 - 4           # reference :7157

    # ---- prompt pass at batch 1, then one cache copy per decoder: the
    # reference decodes the prompt once on decoder 0 and kv_seq_cp's it
    # (:7115-7154)
    kv1 = KVCache.zeros(hp, 1, dtype, dev, quant=kv_quant)
    prompt_t = torch.as_tensor(np.asarray(prompt), dtype=torch.long, device=dev)[None]
    logits_p, kv1, _ = model_mod.decoder_forward(
        params, hp, prompt_t, 0, kv1, cross_k, cross_v, dtype,
        logit_rows=prompt_len - 1)
    last_row = logits_p[:, 0]                                  # (1, V)
    # no_speech prob BEFORE any filtering (reference :7124-7134)
    no_speech_prob = torch.softmax(last_row[0].float(), -1)[tids.nosp]
    kv = kv1.broadcast(B)
    logits = last_row.expand(B, V).float()

    # ---- per-decoder state, host side
    tokens = np.zeros((B, n_max), np.int32)
    tok_p = np.zeros((B, n_max), np.float32)
    tok_plog = np.zeros((B, n_max), np.float32)
    tok_pt = np.zeros((B, n_max), np.float32)
    tok_ptsum = np.zeros((B, n_max), np.float32)
    tok_tid = np.zeros((B, n_max), np.int32)
    sum_lp = np.zeros(B, np.float32)
    seek_delta = np.full(B, 100 * CHUNK_SIZE, np.int32)
    has_ts = np.zeros(B, bool)
    failed = np.zeros(B, bool)
    completed = np.zeros(B, bool)
    result_len = np.zeros(B, np.int32)
    last_token = np.zeros(B, np.int32)
    prefix_hash = np.zeros(B, np.uint32)
    default_tid = tids.beg if strategy == BEAM else 0
    rows = np.arange(B)
    gstate = torch.zeros(B, dtype=torch.long, device=dev)   # DFA state 0: the start

    i = 0
    while i < n_max and not np.all(completed | failed):
        live = ~(completed | failed)
        last_was_ts = (tokens[:, i - 1] >= tids.beg) if i > 0 else np.zeros(B, bool)
        penult_was_ts = ((tokens[:, i - 2] >= tids.beg) if i >= 2
                         else np.ones(B, bool))                 # <2 tokens -> true (:6264)
        flags = torch.from_numpy(np.stack(
            [np.full(B, i == 0), last_was_ts, penult_was_ts, has_ts])).to(dev)
        _, logprobs, probs = apply_filters(
            logits, consts, tids,
            is_initial=flags[0], last_was_ts=flags[1], penult_was_ts=flags[2],
            has_ts=flags[3], seek_delta=torch.from_numpy(seek_delta).to(dev),
            temperature=temperature,
            grammar_reject=None if grammar_reject is None else grammar_reject[gstate],
            grammar_penalty=grammar_penalty)
        pt, ptsum, tid = timestamp_stats(probs, tids, default_tid=default_tid)

        if strategy == BEAM:
            noise = (gumbel((B, k, V), generator, dev) if beam_multinomial else None)
            top_id = beam_candidates(logprobs, k, noise)
            host_f = torch.stack([logprobs.gather(1, top_id), probs.gather(1, top_id)])
            host_f = torch.cat([host_f.reshape(-1), pt, ptsum]).cpu().numpy()
            host_i = torch.cat([top_id.reshape(-1), tid]).cpu().numpy()
            top_lp = host_f[: B * k].reshape(B, k)
            top_p = host_f[B * k: 2 * B * k].reshape(B, k)
            pt_h, ptsum_h = host_f[2 * B * k: 2 * B * k + B], host_f[2 * B * k + B:]
            top_id_h = host_i[: B * k].reshape(B, k)
            tid_h = host_i[B * k:].astype(np.int32)
            src, tok, cand = beam_select(top_lp, top_id_h, live, sum_lp,
                                         prefix_hash, last_token, i)
            # fork: every per-decoder datum follows its source beam; the
            # cache rows follow in the next decoder step (fork_src)
            tokens, tok_p, tok_plog = tokens[src], tok_p[src], tok_plog[src]
            tok_pt, tok_ptsum, tok_tid = tok_pt[src], tok_ptsum[src], tok_tid[src]
            sum_lp, seek_delta = sum_lp[src], seek_delta[src]
            has_ts, result_len = has_ts[src], result_len[src]
            prefix_hash = prefix_hash[src] * HASH_MULT + tok.astype(np.uint32)
            pt_h, ptsum_h, tid_h = pt_h[src], ptsum_h[src], tid_h[src]
            p_tok = top_p[src, cand]
            plog_tok = top_lp[src, cand]
        else:
            if strategy == GREEDY_BEST:
                tok_d = probs.argmax(dim=-1)
            else:
                tok_d = sample_gumbel_max(logprobs, gumbel((B, V), generator, dev))
            host_f = torch.cat([probs.gather(1, tok_d[:, None])[:, 0],
                                logprobs.gather(1, tok_d[:, None])[:, 0],
                                pt, ptsum]).cpu().numpy()
            host_i = torch.cat([tok_d, tid]).cpu().numpy().astype(np.int32)
            p_tok, plog_tok = host_f[:B], host_f[B: 2 * B]
            pt_h, ptsum_h = host_f[2 * B: 3 * B], host_f[3 * B:]
            tok, tid_h = host_i[:B], host_i[B:]
            src = rows

        # sampled timestamp overrides the stats token (:6481-6484)
        is_ts = tok >= tids.beg
        tid_h = np.where(is_ts, tok, tid_h).astype(np.int32)
        pt_h = np.where(is_ts, p_tok, pt_h)

        # ---- append token for live decoders
        tokens[:, i] = np.where(live, tok, tokens[:, i])
        tok_p[:, i] = np.where(live, p_tok, tok_p[:, i])
        tok_plog[:, i] = np.where(live, plog_tok, tok_plog[:, i])
        tok_pt[:, i] = np.where(live, pt_h, tok_pt[:, i])
        tok_ptsum[:, i] = np.where(live, ptsum_h, tok_ptsum[:, i])
        tok_tid[:, i] = np.where(live, tid_h, tok_tid[:, i])
        sum_lp = np.where(live, sum_lp + plog_tok, sum_lp).astype(np.float32)

        # ---- per-decoder state machine (:7297-7378)
        upd = state_machine.advance(
            tok, i, live, has_ts, seek_delta, result_len, failed, completed,
            seek, seek_end, tids, max_tokens=max_tokens,
            single_segment=single_segment, no_timestamps=no_timestamps,
            n_max=n_max)
        has_ts, seek_delta, result_len = upd.has_ts, upd.seek_delta, upd.result_len
        failed, completed = upd.failed, upd.completed

        # grammar accept on the chosen token, from the forked state; not for
        # a row whose token tripped the timestamp-regress failure (the
        # reference `continue`s past the accept, :7320-7329)
        if grammar_trans is not None:
            step = torch.from_numpy(np.stack([src, tok, upd.live2]).astype(np.int64)).to(dev)
            g_src = gstate[step[0]]
            gstate = torch.where(step[2].bool(), grammar_trans[g_src, step[1]], g_src)

        next_tok = np.where(live, tok, last_token).astype(np.int32)
        last_token = next_tok
        i += 1
        if i >= n_max or np.all(completed | failed):
            break   # the next step's logits would never be read
        # ---- next decode step
        fork = (torch.from_numpy(src).to(dev)
                if strategy == BEAM and not np.array_equal(src, rows) else None)
        lg_next, kv, _ = model_mod.decoder_forward(
            params, hp, torch.from_numpy(next_tok).to(dev, torch.long)[:, None],
            prompt_len + i - 1, kv, cross_k, cross_v, dtype, fork_src=fork)
        logits = lg_next[:, 0]

    return WindowResult(
        tokens=tokens, tok_p=tok_p, tok_plog=tok_plog, tok_pt=tok_pt,
        tok_ptsum=tok_ptsum, tok_tid=tok_tid, n_tokens=i,
        result_len=np.asarray(result_len, np.int32),
        seek_delta=np.asarray(seek_delta, np.int32),
        failed=np.asarray(failed), completed=np.asarray(completed),
        sum_logprobs_all=sum_lp, no_speech_prob=float(no_speech_prob),
    )
