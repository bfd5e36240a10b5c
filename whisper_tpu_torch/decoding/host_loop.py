"""Host-stepped window decode — the grammar / callback path.

Counterpart of whisper_tpu/decoding/host_loop.py. It mirrors
decoding/device_loop.py step for step but chooses the tokens on the host,
so that the GBNF pushdown machine (a grammar too large for the token DFA)
and a user logits_filter_callback can run between steps. The model runs
where the context lives (on the card, the prompt pass takes the flash
kernel like the device loop's); each step copies the decoders' raw logits
to the host for the callback, runs the ordered filters on the device and
copies the filtered log-probabilities back.

It is also the readable oracle the device loop is held against (greedy
must match exactly), so its step logic is deliberately independent of
device_loop.py and state_machine.advance: never merge them.

Structure follows reference whisper_full_with_state's inner loop
(src/whisper.cpp:7115-7477).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from whisper_tpu_torch.config import CHUNK_SIZE, FullParams
from whisper_tpu_torch.decoding import filters as filters_mod
from whisper_tpu_torch.decoding.device_loop import BEAM, SAMPLE, WindowResult
from whisper_tpu_torch.decoding.state_machine import DELTA_MIN


def _filter_step(logits, consts, tids, dev, i, last_was_ts, penult_was_ts,
                 has_ts, seek_delta, temperature, grammar_reject,
                 grammar_penalty, default_tid):
    """The ordered filters and timestamp statistics on `dev`; the results
    as host numpy arrays (logprobs, probs, pt, ptsum, tid)."""
    B = logits.shape[0]
    flags = torch.from_numpy(np.stack(
        [np.full(B, i == 0), last_was_ts, penult_was_ts, has_ts])).to(dev)
    g_rej = (None if grammar_reject is None
             else torch.from_numpy(grammar_reject).to(dev))
    _, logprobs, probs = filters_mod.apply_filters(
        torch.from_numpy(logits).to(dev), consts, tids,
        is_initial=flags[0], last_was_ts=flags[1], penult_was_ts=flags[2],
        has_ts=flags[3], seek_delta=torch.from_numpy(seek_delta).to(dev),
        temperature=temperature, grammar_reject=g_rej,
        grammar_penalty=grammar_penalty)
    pt, ptsum, tid = filters_mod.timestamp_stats(probs, tids, default_tid=default_tid)
    host_f = torch.cat([logprobs, probs, torch.stack([pt, ptsum], 1)], 1).cpu().numpy()
    V = logits.shape[1]
    return (host_f[:, :V], host_f[:, V: 2 * V], host_f[:, 2 * V], host_f[:, 2 * V + 1],
            tid.cpu().numpy().astype(np.int32))


def decode_window_host(
    state,
    params: FullParams,
    consts,
    tids,
    prompt: List[int],
    t_cur: float,
    seek: int,
    seek_end: int,
    n_dec: int,
    strategy: int,
    rng_seed: int = 0,
    beam_size: int = 5,
) -> WindowResult:
    ctx = state.ctx
    hp = ctx.hparams
    vocab = ctx.vocab
    dev = ctx.device
    B = n_dec
    V = tids.n_vocab
    n_max = hp.n_text_ctx // 2 - 4

    grammars = [None] * B
    if params.grammar_rules is not None:
        grammars = [params.grammar_rules.instance() for _ in range(B)]

    rngs = [np.random.default_rng(rng_seed * 997 + j) for j in range(B)]

    kv = state.new_kv_cache(B)
    logits_all, kv = state.decode(np.asarray(prompt, np.int64), 0, kv, batch=B)
    no_speech_prob = float(torch.softmax(logits_all[0, -1].float(), -1)[vocab.token_nosp])
    logits = logits_all[:, -1].float().cpu().numpy().copy()          # (B, V)

    tokens = np.zeros((B, n_max), np.int32)
    tok_p = np.zeros((B, n_max), np.float32)
    tok_plog = np.zeros((B, n_max), np.float32)
    tok_pt = np.zeros((B, n_max), np.float32)
    tok_ptsum = np.zeros((B, n_max), np.float32)
    tok_tid = np.zeros((B, n_max), np.int32)
    sum_lp = np.zeros(B, np.float64)
    seek_delta = np.full(B, 100 * CHUNK_SIZE, np.int32)
    has_ts = np.zeros(B, bool)
    failed = np.zeros(B, bool)
    completed = np.zeros(B, bool)
    result_len = np.zeros(B, np.int32)
    last_token = np.zeros(B, np.int32)

    prompt_len = len(prompt)
    n_steps = 0
    for i in range(n_max):
        live = ~(completed | failed)
        if not live.any():
            break
        n_steps = i + 1

        # grammar reject masks
        g_reject = None
        if params.grammar_rules is not None:
            g_reject = np.zeros((B, V), bool)
            for j in range(B):
                if live[j] and grammars[j] is not None:
                    g_reject[j, grammars[j].rejected_tokens(vocab)] = True

        # user callback mutates raw logits (reference :6224-6226)
        if params.logits_filter_callback is not None:
            for j in range(B):
                if live[j]:
                    params.logits_filter_callback(
                        ctx, state, tokens[j, :i].tolist(), logits[j])

        last_was_ts = (tokens[:, i - 1] >= vocab.token_beg) if i > 0 else np.zeros(B, bool)
        penult_was_ts = (tokens[:, i - 2] >= vocab.token_beg) if i >= 2 else np.ones(B, bool)

        logprobs, probs, pt, ptsum, tid = _filter_step(
            logits, consts, tids, dev, i, last_was_ts, penult_was_ts, has_ts,
            seek_delta, t_cur, g_reject, params.grammar_penalty,
            vocab.token_beg if strategy == BEAM else 0)

        # ---- sampling ------------------------------------------------------
        toks = np.zeros(B, np.int32)
        if strategy == BEAM:
            # beam candidates: top-k per live decoder, global sort by
            # cumulative logprob, dedup equal sequences, reassign to live
            # slots with KV fork (reference :7239-7290)
            k = beam_size
            cands = []  # (score, src, tok, plog)
            for j in range(B):
                if not live[j]:
                    continue
                if params.beam_search.multinomial_candidates:
                    # k draws from the filtered distribution with this
                    # decoder's rng, like the reference's
                    # std::discrete_distribution(probs)
                    # (whisper_sample_token_topk, src/whisper.cpp:6548-6558)
                    pj = probs[j].astype(np.float64)
                    s = pj.sum()
                    top = (rngs[j].choice(len(pj), size=k, p=pj / s)
                           if s > 0 else np.argsort(-logprobs[j])[:k])
                else:
                    top = np.argsort(-logprobs[j])[:k]
                for tk in top:
                    cands.append((sum_lp[j] + logprobs[j][tk], j, int(tk),
                                  float(logprobs[j][tk])))
            cands.sort(key=lambda c: (-c[0], c[1]))
            live_slots = [j for j in range(B) if live[j]]
            chosen = []
            ci = 0
            # reference cursor machine (:7250-7290): wrap on exhaustion,
            # then skip immediately following candidates whose full token
            # sequence equals the one just taken (equal sequences have
            # equal scores, so they are always adjacent after the sort)
            for _slot in live_slots:
                if ci >= len(cands):
                    ci = 0                                  # wrap (:7260)
                sc, src, tk, pl = cands[ci]
                cur_seq = tokens[src, :i].tolist() + [tk]
                ci += 1
                while ci < len(cands) and i > 0:            # :7265-7267
                    _, src2, tk2, _ = cands[ci]
                    if tokens[src2, :i].tolist() + [tk2] == cur_seq:
                        ci += 1
                    else:
                        break
                chosen.append((src, tk))
            # fork: gather per-decoder state from source beams
            srcs = np.arange(B)
            for slot, (src, tk) in zip(live_slots, chosen):
                srcs[slot] = src
                toks[slot] = tk
            for j in range(B):
                if not live[j]:
                    toks[j] = last_token[j]
            tokens = tokens[srcs]
            tok_p, tok_plog = tok_p[srcs], tok_plog[srcs]
            tok_pt, tok_ptsum, tok_tid = tok_pt[srcs], tok_ptsum[srcs], tok_tid[srcs]
            sum_lp = sum_lp[srcs]
            seek_delta, has_ts, result_len = (seek_delta[srcs], has_ts[srcs],
                                              result_len[srcs])
            probs, logprobs = probs[srcs], logprobs[srcs]
            pt, ptsum, tid = pt[srcs], ptsum[srcs], tid[srcs]
            if params.grammar_rules is not None:
                grammars = [grammars[s].copy() if grammars[s] else None
                            for s in srcs]
            kv = kv.reorder(torch.from_numpy(srcs).to(dev))
        else:
            for j in range(B):
                if not live[j]:
                    toks[j] = last_token[j]
                    continue
                if strategy == SAMPLE and t_cur > 0:
                    pj = probs[j].astype(np.float64)
                    s = pj.sum()
                    toks[j] = int(rngs[j].choice(V, p=pj / s)) if s > 0 else int(np.argmax(pj))
                else:
                    toks[j] = int(np.argmax(probs[j]))

        p_tok = probs[np.arange(B), toks]
        plog_tok = logprobs[np.arange(B), toks]
        is_ts = toks >= vocab.token_beg
        tid = np.where(is_ts, toks, tid).astype(np.int32)
        pt = np.where(is_ts, p_tok, pt)

        for j in range(B):
            if not live[j]:
                continue
            tokens[j, i] = toks[j]
            tok_p[j, i] = p_tok[j]
            tok_plog[j, i] = plog_tok[j]
            tok_pt[j, i] = pt[j]
            tok_ptsum[j, i] = ptsum[j]
            tok_tid[j, i] = tid[j]
            sum_lp[j] += plog_tok[j]

            # state machine (:7297-7378)
            t = int(toks[j])
            if t > vocab.token_beg:
                sd_new = 2 * (t - vocab.token_beg)
                if has_ts[j] and seek_delta[j] > sd_new and result_len[j] < i:
                    failed[j] = True
                    continue
                seek_delta[j] = sd_new
                result_len[j] = i + 1
                has_ts[j] = True

            # grammar accept AFTER the regress continue (:7320-7329)
            if grammars[j] is not None:
                grammars[j].accept_token(vocab, int(toks[j]))

            end_of_audio = has_ts[j] and seek + seek_delta[j] + DELTA_MIN >= seek_end
            if (t == vocab.token_eot
                    or (params.max_tokens > 0 and i >= params.max_tokens)
                    or end_of_audio):
                if result_len[j] == 0 and not params.no_timestamps:
                    if seek + seek_delta[j] + DELTA_MIN >= seek_end:
                        result_len[j] = i + 1
                    else:
                        failed[j] = True
                        continue
                if params.single_segment or params.no_timestamps:
                    result_len[j] = i + 1
                    seek_delta[j] = 100 * CHUNK_SIZE
                completed[j] = True
                continue

            if i == n_max - 1 and (result_len[j] == 0
                                   or seek_delta[j] < 100 * CHUNK_SIZE // 2):
                failed[j] = True

        live = ~(completed | failed)
        if not live.any():
            break

        next_toks = np.where(live, toks, last_token).astype(np.int32)
        last_token = next_toks
        logits_all, kv = state.decode(next_toks[:, None], prompt_len + i, kv, batch=B)
        logits = logits_all[:, -1].float().cpu().numpy().copy()

    return WindowResult(
        tokens=tokens, tok_p=tok_p, tok_plog=tok_plog, tok_pt=tok_pt,
        tok_ptsum=tok_ptsum, tok_tid=tok_tid, n_tokens=n_steps,
        result_len=result_len, seek_delta=seek_delta, failed=failed,
        completed=completed, sum_logprobs_all=sum_lp.astype(np.float32),
        no_speech_prob=no_speech_prob,
    )
