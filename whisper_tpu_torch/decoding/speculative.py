"""Speculative greedy decoding: a draft model proposes, the main model verifies.

Counterpart of whisper_tpu/decoding/speculative.py, with the same
semantics and the same WindowResult as the greedy single-decoder window of
decoding/device_loop.py. A greedy decode step reads every weight of the
main model for one token; here a cheap draft model (e.g. distil-large-v3
against large-v3: the same vocabulary, 2 decoder layers instead of 32)
proposes k - 1 tokens, one step each, and the main model scores the whole
k-token chunk in ONE decoder forward. The longest prefix whose filtered
argmax matches is accepted, so the emitted stream is the main model's own
greedy stream (up to the rounding difference between its T = 1 and T = k
forwards).

The JAX package replays the whole window in one jitted lax.while_loop;
here the loop is a Python loop on the host over device tensors, as in
decoding/device_loop.py. Per round, with i tokens emitted and the chunk
starting at cache position p = prompt_len + i:

- c_0 is the main model's own next token (its filtered argmax, carried
  from the previous round's verify or, first, from the prompt pass);
- draft step j (j = 0..k-1) feeds c_j at position p + j; its filtered
  argmax under the filter inputs of the state after c_j proposes c_{j+1}
  (the last step only fills the draft's cache);
- the main model runs once over the chunk c_0..c_{k-1} at p; row j,
  filtered under the state after c_j, predicts the token after c_j;
- m = the leading run of proposals that equal those predictions; the
  round emits M = min(m + 1, first terminal + 1, n_max - i) tokens, the
  per-token state machine (decoding/state_machine.py) replayed over them
  on the host, and the next c_0 is row M - 1's prediction.

Host reads per round: one token per draft step but the last, and one
copy of the verify's k predictions and the chunk's token statistics. The
(k, V) rows stay on the device.

The caches need no rollback after a rejection: both are position-indexed
and a decoder call reads only the positions below its chunk
(models/whisper.py's split path), and the next round writes its chunk
from the accepted frontier on. The verify chunk writes cache rows up to
prompt_len + n_max - 2 + k; the caches are sized to hold that (the
default 512 slots at n_text_ctx 448 while k <= 61). A chunk of k > 1
rows runs its cross-attention through the flash-attention kernel
(decoder_forward's T > 1 rule); at k = 1 it takes the plain path.

`tp` (the model group of tensor parallelism, models/whisper.py) shards the
main model only, as decode_windows_batch's does: its prompt pass and
verifies run on the rank's heads and shards, and its cache holds the
rank's heads. The draft, a few percent of the main model's weights, runs
whole on every rank, without collectives. The logits come back whole and
the draft is deterministic, so every rank of the group takes the same
decisions. The API routes no mesh here (WhisperContext.attach_draft
refuses a meshed context); tools/tp_evidence.py drives this composition.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from whisper_tpu_torch.config import CHUNK_SIZE, WhisperHParams
from whisper_tpu_torch.decoding import state_machine
from whisper_tpu_torch.decoding.device_loop import WindowResult
from whisper_tpu_torch.decoding.filters import (
    FilterConsts, TokenIds, apply_filters, timestamp_stats)
from whisper_tpu_torch.models import whisper as model_mod
from whisper_tpu_torch.models.whisper import KVCache


class _Fold(NamedTuple):
    """The one decoder's state after a token (the vanilla loop's state
    machine, reference src/whisper.cpp:7297-7378), on the host."""

    has_ts: bool
    seek_delta: int
    result_len: int
    failed: bool
    completed: bool
    last_tok: int      # token at step s - 1 (0 if none)
    penult_tok: int    # token at step s - 2 (0 if none)


def _fold_token(fold: _Fold, tok: int, s: int, tids: TokenIds, seek: int, seek_end: int,
                machine: dict) -> Tuple[_Fold, bool]:
    """The state after the token sampled at step s, and whether that token
    ended the decoder (completed or failed it)."""
    upd = state_machine.advance(
        tok, s, True, fold.has_ts, fold.seek_delta, fold.result_len, fold.failed,
        fold.completed, seek, seek_end, tids, **machine)
    new = _Fold(has_ts=bool(upd.has_ts), seek_delta=int(upd.seek_delta),
                result_len=int(upd.result_len), failed=bool(upd.failed),
                completed=bool(upd.completed), last_tok=tok, penult_tok=fold.last_tok)
    return new, bool(upd.terminal)


def _filtered(logits: torch.Tensor, consts: FilterConsts, tids: TokenIds,
              folds: List[_Fold], steps: List[int]):
    """The greedy filters over rows (n, V), row r sampling step steps[r]
    under the state folds[r] (device_loop's is_initial / last_was_ts /
    penult_was_ts), the flags in one copy to the device: (logprobs, probs)."""
    flags = torch.from_numpy(np.array(
        [[s == 0 for s in steps],
         [s >= 1 and f.last_tok >= tids.beg for f, s in zip(folds, steps)],
         [s < 2 or f.penult_tok >= tids.beg for f, s in zip(folds, steps)],
         [f.has_ts for f in folds],
         [f.seek_delta for f in folds]], np.int64)).to(logits.device)
    _, logprobs, probs = apply_filters(
        logits, consts, tids, is_initial=flags[0].bool(), last_was_ts=flags[1].bool(),
        penult_was_ts=flags[2].bool(), has_ts=flags[3].bool(), seek_delta=flags[4],
        temperature=0.0)
    return logprobs, probs


def _cache(hp: WhisperHParams, rows: int, dtype, dev, quant: bool, tp=None) -> KVCache:
    """A batch-1 cache of the default size, grown (in steps of 256) when
    `rows` positions do not fit; of the rank's heads under `tp`."""
    size = -(-max(hp.n_text_ctx, rows) // 256) * 256
    return KVCache.zeros(hp, 1, dtype, dev, size=size, quant=quant, tp=tp)


def decode_window_speculative(
    params,                    # main model weights
    params_draft,              # draft model weights
    hp: WhisperHParams,
    hp_draft: WhisperHParams,
    consts: FilterConsts,
    cross_k, cross_v,          # main (L, 1, H, Ta, Dh), or (int8 codes, scales)
    draft_ck, draft_cv,        # draft (Ld, 1, Hd, Ta, Dhd), likewise
    prompt,                    # (PROMPT_BUCKET,) int, right-padded
    prompt_len: int,
    seek: int,
    seek_end: int,
    *,
    tids: TokenIds,
    k_spec: int = 8,
    max_tokens: int = 0,
    single_segment: bool = False,
    no_timestamps: bool = False,
    dtype=torch.bfloat16,
    kv_quant: bool = False,
    tp=None,                   # model group of the MAIN model (module docstring)
) -> WindowResult:
    dev = (cross_k[0] if isinstance(cross_k, tuple) else cross_k).device
    k = max(1, k_spec)
    n_max = hp.n_text_ctx // 2 - 4               # reference :7157
    machine = dict(max_tokens=max_tokens, single_segment=single_segment,
                   no_timestamps=no_timestamps, n_max=n_max)
    fwd = model_mod.decoder_forward

    # ---- prompt pass of both models (reference :7115-7154); the draft's
    # only fills its cache
    prompt_t = torch.as_tensor(np.asarray(prompt), dtype=torch.long, device=dev)[None]
    rows_needed = max(prompt_t.shape[1], prompt_len + n_max - 1 + k)
    kv = _cache(hp, rows_needed, dtype, dev, kv_quant, tp)
    logits_p, kv, _ = fwd(params, hp, prompt_t, 0, kv, cross_k, cross_v, dtype,
                          logit_rows=prompt_len - 1, tp=tp)
    last_row = logits_p[:, 0].float()                            # (1, V)
    no_speech_prob = torch.softmax(last_row[0], -1)[tids.nosp]   # before any filter
    dkv = _cache(hp_draft, rows_needed, dtype, dev, kv_quant)
    _, dkv, _ = fwd(params_draft, hp_draft, prompt_t, 0, dkv, draft_ck, draft_cv, dtype,
                    logit_rows=0)

    fold = _Fold(has_ts=False, seek_delta=100 * CHUNK_SIZE, result_len=0, failed=False,
                 completed=False, last_tok=0, penult_tok=0)
    lp, pr = _filtered(last_row, consts, tids, [fold], [0])
    lp0, pr0 = lp[0], pr[0]
    c0 = int(pr0.argmax())

    tokens = np.zeros(n_max, np.int32)
    tok_tid = np.zeros(n_max, np.int32)
    tok_p, tok_plog, tok_pt, tok_ptsum = (np.zeros(n_max, np.float32) for _ in range(4))
    sum_lp = np.float32(0.0)

    i = rounds = 0
    while i < n_max and not (fold.completed or fold.failed):
        p = prompt_len + i                       # cache position of c_0

        # ---- draft: step j feeds c_j at p + j and proposes c_{j+1} under
        # the filter inputs of the state after c_j
        chunk, folds, terms = [c0], [], []
        f = fold
        for j in range(k):
            f, term = _fold_token(f, chunk[j], i + j, tids, seek, seek_end, machine)
            folds.append(f)
            terms.append(term)
            dlog, dkv, _ = fwd(params_draft, hp_draft,
                               torch.tensor([[chunk[j]]], dtype=torch.long, device=dev),
                               p + j, dkv, draft_ck, draft_cv, dtype)
            if j < k - 1:
                _, dpr = _filtered(dlog[:, 0].float(), consts, tids, [f], [i + j + 1])
                chunk.append(int(dpr[0].argmax()))

        # ---- verify: one main forward over the chunk; row j, filtered under
        # the state after c_j, is the main model's token after c_j
        chunk_t = torch.tensor(chunk, dtype=torch.long, device=dev)
        rows, kv, _ = fwd(params, hp, chunk_t[None], p, kv, cross_k, cross_v, dtype, tp=tp)
        v_lp, v_pr = _filtered(rows[0].float(), consts, tids, folds,
                               [i + 1 + j for j in range(k)])
        lp_all = torch.cat([lp0[None], v_lp[: k - 1]])           # (k, V): c_0..c_{k-1}
        pr_all = torch.cat([pr0[None], v_pr[: k - 1]])
        pt, ptsum, tid = timestamp_stats(pr_all, tids)
        host = torch.cat([v_pr.argmax(-1).float(), pr_all.gather(1, chunk_t[:, None])[:, 0],
                          lp_all.gather(1, chunk_t[:, None])[:, 0], pt, ptsum,
                          tid.float()]).cpu().numpy().reshape(6, k)
        a_hat = host[0].astype(np.int32)

        # ---- emitted count: the accepted prefix, cut at a terminal / n_max
        chunk_h = np.array(chunk, np.int32)
        m = int(np.cumprod(chunk_h[1:] == a_hat[: k - 1]).sum())
        M = min(m + 1, (terms.index(True) if True in terms else k) + 1, n_max - i)

        tok = chunk_h[:M]
        is_ts = tok >= tids.beg
        tokens[i: i + M] = tok
        tok_p[i: i + M] = host[1, :M]
        tok_plog[i: i + M] = host[2, :M]
        tok_pt[i: i + M] = np.where(is_ts, host[1, :M], host[3, :M])
        tok_ptsum[i: i + M] = host[4, :M]
        tok_tid[i: i + M] = np.where(is_ts, tok, host[5, :M].astype(np.int32))
        sum_lp = np.float32(sum_lp + host[2, :M].sum(dtype=np.float32))

        fold = folds[M - 1]
        c0, lp0, pr0 = int(a_hat[M - 1]), v_lp[M - 1], v_pr[M - 1]
        i += M
        rounds += 1

    return WindowResult(
        tokens=tokens[None], tok_p=tok_p[None], tok_plog=tok_plog[None], tok_pt=tok_pt[None],
        tok_ptsum=tok_ptsum[None], tok_tid=tok_tid[None], n_tokens=i,
        result_len=np.array([fold.result_len], np.int32),
        seek_delta=np.array([fold.seek_delta], np.int32),
        failed=np.array([fold.failed]), completed=np.array([fold.completed]),
        sum_logprobs_all=np.array([sum_lp], np.float32),
        no_speech_prob=float(no_speech_prob), n_rounds=rounds)
