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
    # draft/verify rounds of a speculative window (decoding/speculative.py);
    # 0 on this loop. Tokens per round = n_tokens / n_rounds
    n_rounds: int = 0


class Rows:
    """The per-decoder-row state of a window decode, on the host (numpy),
    and the steps both window loops take on it (this module's
    decode_window and batch_loop.decode_windows_batch)."""

    FORKED = ("tokens", "tok_p", "tok_plog", "tok_pt", "tok_ptsum", "tok_tid",
              "sum_lp", "seek_delta", "has_ts", "result_len")

    def __init__(self, B: int, n_max: int, completed: Optional[np.ndarray] = None):
        self.tokens = np.zeros((B, n_max), np.int32)
        self.tok_p = np.zeros((B, n_max), np.float32)
        self.tok_plog = np.zeros((B, n_max), np.float32)
        self.tok_pt = np.zeros((B, n_max), np.float32)
        self.tok_ptsum = np.zeros((B, n_max), np.float32)
        self.tok_tid = np.zeros((B, n_max), np.int32)
        self.sum_lp = np.zeros(B, np.float32)
        self.seek_delta = np.full(B, 100 * CHUNK_SIZE, np.int32)
        self.has_ts = np.zeros(B, bool)
        self.failed = np.zeros(B, bool)
        self.completed = np.zeros(B, bool) if completed is None else completed
        self.result_len = np.zeros(B, np.int32)
        self.last_token = np.zeros(B, np.int32)
        self.prefix_hash = np.zeros(B, np.uint32)

    def done(self) -> bool:
        return bool(np.all(self.completed | self.failed))

    def filtered(self, logits, consts, tids, i, temperature, grammar_reject, gstate,
                 grammar_penalty, default_tid):
        """The ordered logit filters on the device for step i (the per-row
        flags from the host), then the timestamp statistics: (logprobs,
        probs, pt, ptsum, tid), each on the device."""
        B = logits.shape[0]
        last_was_ts = (self.tokens[:, i - 1] >= tids.beg) if i > 0 else np.zeros(B, bool)
        penult_was_ts = ((self.tokens[:, i - 2] >= tids.beg) if i >= 2
                         else np.ones(B, bool))                 # <2 tokens -> true (:6264)
        flags = torch.from_numpy(np.stack(
            [np.full(B, i == 0), last_was_ts, penult_was_ts, self.has_ts])).to(logits.device)
        _, logprobs, probs = apply_filters(
            logits, consts, tids,
            is_initial=flags[0], last_was_ts=flags[1], penult_was_ts=flags[2],
            has_ts=flags[3], seek_delta=torch.from_numpy(self.seek_delta).to(logits.device),
            temperature=temperature,
            grammar_reject=None if grammar_reject is None else grammar_reject[gstate],
            grammar_penalty=grammar_penalty)
        return (logprobs, probs) + tuple(timestamp_stats(probs, tids, default_tid=default_tid))

    def fork(self, src: np.ndarray, tok: np.ndarray) -> None:
        """Beam fork: every per-row datum follows its source row (the cache
        rows follow in the next decoder step, fork_src)."""
        for name in self.FORKED:
            setattr(self, name, getattr(self, name)[src])
        self.prefix_hash = self.prefix_hash[src] * HASH_MULT + tok.astype(np.uint32)

    def append(self, i, live, tok, p_tok, plog_tok, pt, ptsum, tid, tids, seek, seek_end,
               **machine) -> state_machine.StepUpdate:
        """Record step i's token of every live row (a sampled timestamp
        overrides the stats token, :6481-6484) and advance the per-row
        state machine (:7297-7378); `seek` / `seek_end` scalar or per row."""
        is_ts = tok >= tids.beg
        tid = np.where(is_ts, tok, tid).astype(np.int32)
        pt = np.where(is_ts, p_tok, pt)
        for arr, val in ((self.tokens, tok), (self.tok_p, p_tok), (self.tok_plog, plog_tok),
                         (self.tok_pt, pt), (self.tok_ptsum, ptsum), (self.tok_tid, tid)):
            arr[:, i] = np.where(live, val, arr[:, i])
        self.sum_lp = np.where(live, self.sum_lp + plog_tok, self.sum_lp).astype(np.float32)
        upd = state_machine.advance(
            tok, i, live, self.has_ts, self.seek_delta, self.result_len, self.failed,
            self.completed, seek, seek_end, tids, **machine)
        self.has_ts, self.seek_delta, self.result_len = upd.has_ts, upd.seek_delta, upd.result_len
        self.failed, self.completed = upd.failed, upd.completed
        self.last_token = np.where(live, tok, self.last_token).astype(np.int32)
        return upd

    def result(self, n_tokens: int) -> dict:
        """The WindowResult fields of this state but no_speech_prob."""
        return dict(
            tokens=self.tokens, tok_p=self.tok_p, tok_plog=self.tok_plog,
            tok_pt=self.tok_pt, tok_ptsum=self.tok_ptsum, tok_tid=self.tok_tid,
            n_tokens=n_tokens, result_len=np.asarray(self.result_len, np.int32),
            seek_delta=np.asarray(self.seek_delta, np.int32),
            failed=np.asarray(self.failed), completed=np.asarray(self.completed),
            sum_logprobs_all=self.sum_lp)


def fetch_candidates(logprobs, probs, pt, ptsum, tid, k: int, noise=None):
    """Beam candidates of every row on the device, then one copy each way
    of floats and ints to the host: (top_lp, top_p, top_id) (B, k) and
    (pt, ptsum, tid) (B,)."""
    B = logprobs.shape[0]
    top_id = beam_candidates(logprobs, k, noise)
    host_f = torch.stack([logprobs.gather(1, top_id), probs.gather(1, top_id)])
    host_f = torch.cat([host_f.reshape(-1), pt, ptsum]).cpu().numpy()
    host_i = torch.cat([top_id.reshape(-1), tid]).cpu().numpy()
    return (host_f[: B * k].reshape(B, k), host_f[B * k: 2 * B * k].reshape(B, k),
            host_i[: B * k].reshape(B, k), host_f[2 * B * k: 2 * B * k + B],
            host_f[2 * B * k + B:], host_i[B * k:].astype(np.int32))


def fetch_chosen(logprobs, probs, pt, ptsum, tid, tok_d):
    """The chosen token of every row with its probability, log
    probability and timestamp statistics, copied to the host: (tok, p,
    plog, pt, ptsum, tid), each (B,)."""
    B = logprobs.shape[0]
    host_f = torch.cat([probs.gather(1, tok_d[:, None])[:, 0],
                        logprobs.gather(1, tok_d[:, None])[:, 0], pt, ptsum]).cpu().numpy()
    host_i = torch.cat([tok_d, tid]).cpu().numpy().astype(np.int32)
    return (host_i[:B], host_f[:B], host_f[B: 2 * B], host_f[2 * B: 3 * B], host_f[3 * B:],
            host_i[B:])


def grammar_accept(gstate, grammar_trans, src, tok, live2):
    """Each row's DFA transition on its chosen token, from its (forked)
    source state; not for a row whose token tripped the timestamp-regress
    failure (the reference `continue`s past the accept, :7320-7329)."""
    step = torch.from_numpy(np.stack([src, tok, live2]).astype(np.int64)).to(gstate.device)
    g_src = gstate[step[0]]
    return torch.where(step[2].bool(), grammar_trans[g_src, step[1]], g_src)


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
    tp=None,                   # model group of tensor parallelism (models/whisper.py)
) -> WindowResult:
    dev = (cross_k[0] if isinstance(cross_k, tuple) else cross_k).device
    V = tids.n_vocab
    B = n_dec
    k = beam_size
    n_max = hp.n_text_ctx // 2 - 4           # reference :7157

    # ---- prompt pass at batch 1, then one cache copy per decoder: the
    # reference decodes the prompt once on decoder 0 and kv_seq_cp's it
    # (:7115-7154)
    kv1 = KVCache.zeros(hp, 1, dtype, dev, quant=kv_quant, tp=tp)
    prompt_t = torch.as_tensor(np.asarray(prompt), dtype=torch.long, device=dev)[None]
    logits_p, kv1, _ = model_mod.decoder_forward(
        params, hp, prompt_t, 0, kv1, cross_k, cross_v, dtype,
        logit_rows=prompt_len - 1, tp=tp)
    last_row = logits_p[:, 0]                                  # (1, V)
    # no_speech prob BEFORE any filtering (reference :7124-7134)
    no_speech_prob = torch.softmax(last_row[0].float(), -1)[tids.nosp]
    kv = kv1.broadcast(B)
    logits = last_row.expand(B, V).float()

    rows = Rows(B, n_max)                                      # per-decoder state, host side
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
            noise = (gumbel((B, k, V), generator, dev) if beam_multinomial else None)
            top_lp, top_p, top_id, pt_h, ptsum_h, tid_h = fetch_candidates(
                logprobs, probs, pt, ptsum, tid, k, noise)
            src, tok, cand = beam_select(top_lp, top_id, live, rows.sum_lp,
                                         rows.prefix_hash, rows.last_token, i)
            rows.fork(src, tok)
            pt_h, ptsum_h, tid_h = pt_h[src], ptsum_h[src], tid_h[src]
            p_tok, plog_tok = top_p[src, cand], top_lp[src, cand]
        else:
            if strategy == GREEDY_BEST:
                tok_d = probs.argmax(dim=-1)
            else:
                tok_d = sample_gumbel_max(logprobs, gumbel((B, V), generator, dev))
            tok, p_tok, plog_tok, pt_h, ptsum_h, tid_h = fetch_chosen(
                logprobs, probs, pt, ptsum, tid, tok_d)
            src = identity

        upd = rows.append(i, live, tok, p_tok, plog_tok, pt_h, ptsum_h, tid_h, tids,
                          seek, seek_end, **machine)
        if grammar_trans is not None:
            gstate = grammar_accept(gstate, grammar_trans, src, tok, upd.live2)

        i += 1
        if i >= n_max or rows.done():
            break   # the next step's logits would never be read
        # ---- next decode step
        fork = (torch.from_numpy(src).to(dev)
                if strategy == BEAM and not np.array_equal(src, identity) else None)
        lg_next, kv, _ = model_mod.decoder_forward(
            params, hp, torch.from_numpy(rows.last_token).to(dev, torch.long)[:, None],
            prompt_len + i - 1, kv, cross_k, cross_v, dtype, fork_src=fork, tp=tp)
        logits = lg_next[:, 0]

    return WindowResult(**rows.result(i), no_speech_prob=float(no_speech_prob))
