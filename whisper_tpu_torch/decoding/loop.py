"""run_full — the main transcription orchestrator.

Counterpart of whisper_tpu/decoding/loop.py (reference
whisper_full_with_state, src/whisper.cpp:6795-7711): window/seek
bookkeeping, the temperature-fallback ladder, prompt_past management,
ranking, and segment/text emission, with one window decode per
(window x temperature) attempt: decoding/device_loop.py, or
decoding/host_loop.py for a logits_filter_callback or a grammar too large
for the token DFA (decoding/grammar_dfa.py). Both run the model on the
context's device; there is no CPU twin. Language auto-detection,
token-level timestamps (energy heuristic and DTW) and grammars run as in
the JAX package. With a draft model attached, the greedy t = 0 attempt of
a request that can use it (greedy strategy, no grammar, no callback)
decodes speculatively (decoding/speculative.py), on the same device.

With FullParams.vad, the Silero VAD (models/vad.py) runs first, on the
context's device: the audio is cut to its speech segments, spliced with
0.1 s silences, and only that is transcribed; the emitted segments' t0/t1
are mapped back to the original audio's time at the end (reference
whisper_full :7717-7734 and the segment getters, :7882-7960). When VAD
finds no speech, the result is empty.
"""

from __future__ import annotations

import copy
import time
from typing import List, Optional

import numpy as np
import torch

from whisper_tpu_torch import languages
from whisper_tpu_torch.api import Segment, TokenData, WhisperState
from whisper_tpu_torch.config import (
    CHUNK_SIZE,
    MAX_DECODERS,
    FullParams,
    SamplingStrategy,
)
from whisper_tpu_torch.decoding import device_loop, filters, scoring, segments as seg_mod
from whisper_tpu_torch.decoding.language import lang_auto_detect
from whisper_tpu_torch.decoding.state_machine import DELTA_MIN


def run_full(state: WhisperState, params: FullParams,
             samples: Optional[np.ndarray]) -> List[Segment]:
    ctx = state.ctx
    hp = ctx.hparams
    vocab = ctx.vocab

    # A grammar whose reachable state space is finite runs in the device
    # loop as a token DFA (decoding/grammar_dfa.py), its tables on the
    # device once per DFA; any other grammar, and any logits callback, runs
    # the host-stepped loop (decoding/host_loop.py), on the same device
    g_rej = g_trans = None
    grammar_dfa = None
    if params.grammar_rules is not None:
        from whisper_tpu_torch.decoding.grammar_dfa import cached_dfa
        grammar_dfa = cached_dfa(params.grammar_rules, vocab)
        if grammar_dfa is not None:
            g_rej, g_trans = grammar_dfa.device_tables(ctx.device)
    use_host_loop = ((params.grammar_rules is not None and grammar_dfa is None)
                     or params.logits_filter_callback is not None)

    result_all: List[Segment] = []
    state.spec_stats = None          # per-run acceptance counters

    # speculative greedy decoding is usable when a draft is attached, the
    # request has no host-interactive features, and a greedy t=0 attempt can
    # actually occur (GREEDY strategy, ladder starting at 0) — else neither
    # the draft mel nor the per-window draft encoder pass is worth paying
    spec_eligible = (ctx.draft is not None
                     and params.strategy == SamplingStrategy.GREEDY
                     and params.temperature <= 0.0
                     and params.grammar_rules is None
                     and params.logits_filter_callback is None
                     and not ctx.is_stub and not ctx.draft.is_stub)

    # --- VAD preprocessing (reference whisper_full :7717-7734) -------------
    if params.vad:
        from whisper_tpu_torch.models.vad import vad_filter_audio
        t0 = time.perf_counter()
        samples, state.vad_mapping = vad_filter_audio(state, samples, params)
        state.timings.add("vad", time.perf_counter() - t0)
        if samples is None or len(samples) == 0:
            return []
    else:
        state.vad_mapping = None

    # --- mel ---------------------------------------------------------------
    if samples is not None and len(samples) > 0:
        state.pcm_to_mel(samples, debug=params.debug_mode)
        # the draft's own mel (its filterbank / n_mels may differ) from the
        # same (VAD-filtered) samples, unless it shares the main encoder
        if spec_eligible and not ctx.cparams.draft_shares_encoder:
            from whisper_tpu_torch.audio import mel as mel_mod
            state.draft_mel, _, _ = mel_mod.log_mel_spectrogram(
                samples, ctx.draft.mel_filters, ctx.device)
    if state.mel is None:
        raise RuntimeError("no mel: provide samples or call set_mel first")

    use_spec = spec_eligible and (state.draft_mel is not None
                                  or ctx.cparams.draft_shares_encoder)

    # --- language auto-detect (:6814-6830) ----------------------------------
    language = params.language
    if language in (None, "", "auto") or params.detect_language:
        lang_id, _probs = lang_auto_detect(state, 0)
        language = languages.lang_str(lang_id)
        if params.detect_language:
            return []

    # --- signal energy for the token-timestamp heuristic (:6832-6839) -------
    if params.token_timestamps:
        from whisper_tpu_torch.decoding.timestamps import get_signal_energy
        state.t_beg = 0
        state.t_last = 0
        state.tid_last = 0
        if samples is not None and len(samples) > 0:
            t0 = time.perf_counter()
            state.energy = get_signal_energy(np.asarray(samples), 32)
            state.timings.add("energy", time.perf_counter() - t0)

    seek_start = params.offset_ms // 10
    seek_end = (state.n_len_org if params.duration_ms == 0
                else seek_start + params.duration_ms // 10)
    if seek_end < seek_start + DELTA_MIN:
        return []

    temperatures = params.temperatures()
    n_decoders = params.n_decoders
    if n_decoders > MAX_DECODERS:
        raise ValueError(f"too many decoders requested ({n_decoders})")

    # --- prompt state (:6900-6931) ------------------------------------------
    prompt_past: List[int] = [] if params.no_context else list(getattr(state, "prompt_past", []))
    if params.initial_prompt and not params.prompt_tokens:
        params.prompt_tokens = ctx.tokenizer.encode(params.initial_prompt)
    if params.prompt_tokens:
        prompt_past = list(params.prompt_tokens) + prompt_past

    if params.audio_ctx > hp.n_audio_ctx:
        raise ValueError(f"audio_ctx {params.audio_ctx} > max {hp.n_audio_ctx}")
    n_ctx_used = params.audio_ctx if params.audio_ctx > 0 else hp.n_audio_ctx

    # --- task prompt (:6940-6975) -------------------------------------------
    no_timestamps = params.no_timestamps
    is_distil = hp.n_text_layer == 2 and hp.n_vocab != 51866
    if is_distil and not no_timestamps:
        no_timestamps = True

    prompt_init = [vocab.token_sot]
    if hp.is_multilingual:
        lang_id = languages.lang_id(language or "en")
        state.lang_id = lang_id
        prompt_init.append(vocab.token_lang(lang_id))
        prompt_init.append(vocab.token_translate if params.translate
                           else vocab.token_transcribe)
    if no_timestamps:
        prompt_init.append(vocab.token_not)

    prompt_max = hp.n_text_ctx // 2 + 8
    # distil-forced no_timestamps must reach the FILTERS too (the reference
    # mutates its by-value params before whisper_process_logits,
    # src/whisper.cpp:6956-6959)
    fparams = params
    if no_timestamps != params.no_timestamps:
        fparams = copy.copy(params)
        fparams.no_timestamps = True
    consts, tids = filters.build_filter_consts(vocab, hp, fparams, ctx.device)

    def prompt_bucket(n: int) -> int:
        """Pad the prompt to the smallest of three buckets that fits
        (8, 64, n_text_ctx/2+8), as the JAX package does: the first
        window's prompt is the 3-4 token task prefix."""
        for b in sorted({min(8, prompt_max), min(64, prompt_max), prompt_max}):
            if n <= b:
                return b
        return prompt_max

    seek = seek_start
    rng_seed = 0

    # ======================= main window loop (:6986) =======================
    while True:
        if params.progress_callback:
            progress = 100 * (seek - seek_start) // max(1, seek_end - seek_start)
            params.progress_callback(ctx, state, progress)
        if seek + DELTA_MIN >= seek_end:
            break
        if params.encoder_begin_callback:
            if not params.encoder_begin_callback(ctx, state):
                break

        # stub model (no tensors): skip the whole window (:7364-7369)
        if ctx.is_stub:
            seek += 100 * CHUNK_SIZE
            continue

        state.encode(seek, n_ctx_used)
        if use_spec:
            state.encode_draft(seek, n_ctx_used)

        # drop stale prompt near the end (:7013-7016)
        if seek > seek_start and seek + 500 >= seek_end:
            prompt_past = []

        best_idx = 0
        best_result = None
        best_scores = None

        for it, t_cur in enumerate(temperatures):
            # decoders for this attempt (:7024-7044)
            if params.strategy == SamplingStrategy.GREEDY:
                n_dec_cur = params.greedy.best_of if t_cur > 0 else 1
                strat = device_loop.SAMPLE if t_cur > 0 else device_loop.GREEDY_BEST
            else:
                if t_cur > 0:
                    n_dec_cur = params.greedy.best_of
                    strat = device_loop.SAMPLE
                else:
                    n_dec_cur = params.beam_search.beam_size
                    strat = device_loop.BEAM
            n_dec_cur = max(1, n_dec_cur)

            # prompt for this attempt (:7073-7085)
            prompt: List[int] = []
            if prompt_past and t_cur < 0.5 and params.n_max_text_ctx > 0:
                n_take = min(params.n_max_text_ctx, hp.n_text_ctx // 2, len(prompt_past))
                prompt = [vocab.token_prev] + prompt_past[-n_take:]
            prompt = prompt + prompt_init
            prompt = prompt[: prompt_max]
            prompt_len = len(prompt)
            prompt_padded = np.zeros(prompt_bucket(prompt_len), np.int32)
            prompt_padded[:prompt_len] = prompt

            t0 = time.perf_counter()
            if use_host_loop:
                # grammar / user-callback path: host-stepped decode
                # (reference applies these between steps, :6224-6226 + :6360)
                from whisper_tpu_torch.decoding.host_loop import decode_window_host
                result = decode_window_host(
                    state, fparams, consts, tids, prompt, t_cur, seek,
                    seek_end, n_dec_cur, strat, rng_seed + it,
                    beam_size=params.beam_search.beam_size)
            elif use_spec and strat == device_loop.GREEDY_BEST and n_dec_cur == 1:
                # speculative greedy: the draft proposes spec_k tokens, one
                # main forward verifies the chunk; the main model's own stream
                from whisper_tpu_torch.decoding.speculative import (
                    decode_window_speculative)
                result = decode_window_speculative(
                    ctx.params, ctx.draft.params, hp, ctx.draft.hparams, consts,
                    state.cross_k, state.cross_v, state.draft_cross_k, state.draft_cross_v,
                    prompt_padded, prompt_len, seek, seek_end,
                    tids=tids, k_spec=ctx.cparams.spec_k, max_tokens=params.max_tokens,
                    single_segment=params.single_segment, no_timestamps=no_timestamps,
                    dtype=ctx.dtype, kv_quant=ctx.kv_quant)
                prev = state.spec_stats or {"rounds": 0, "tokens": 0}
                state.spec_stats = {"rounds": prev["rounds"] + result.n_rounds,
                                    "tokens": prev["tokens"] + int(result.n_tokens)}
            else:
                generator = torch.Generator(device=ctx.device)
                generator.manual_seed(rng_seed + it)
                result = device_loop.decode_window(
                    ctx.params, hp, consts, state.cross_k, state.cross_v,
                    prompt_padded, prompt_len, t_cur, seek, seek_end, generator,
                    g_rej, g_trans, params.grammar_penalty,
                    tids=tids,
                    n_dec=n_dec_cur,
                    strategy=strat,
                    beam_size=params.beam_search.beam_size,
                    max_tokens=params.max_tokens,
                    single_segment=params.single_segment,
                    no_timestamps=no_timestamps,
                    dtype=ctx.dtype,
                    beam_multinomial=params.beam_search.multinomial_candidates,
                    kv_quant=ctx.kv_quant,
                    tp=ctx.tp,
                )
            n_steps = int(result.n_tokens)
            state.timings.add("decode", time.perf_counter() - t0, max(1, n_steps))
            state.no_speech_prob = float(result.no_speech_prob)

            best_idx, best_scores, failed = scoring.rank_decoders(result, params)
            best_result = result
            sc = best_scores[best_idx]
            fallback = scoring.needs_fallback(
                bool(failed[best_idx]) or sc is None,
                sc.avg_logprobs if sc else float("-inf"),
                state.no_speech_prob,
                params,
                it == len(temperatures) - 1,
            )
            if not fallback:
                break

        # ---------------- emit results for this window (:7546-7675) --------
        result = best_result
        j = best_idx
        seek_delta = int(result.seek_delta[j])
        result_len = int(result.result_len[j])
        sc = best_scores[j]
        avg_logprobs = sc.avg_logprobs if sc else float("-inf")

        # the reference trims the winning sequence to result_len before
        # emission (:7492)
        tokens_cur: List[TokenData] = [
            TokenData(
                id=int(result.tokens[j, i]),
                tid=int(result.tok_tid[j, i]),
                p=float(result.tok_p[j, i]),
                plog=float(result.tok_plog[j, i]),
                pt=float(result.tok_pt[j, i]),
                ptsum=float(result.tok_ptsum[j, i]),
            )
            for i in range(result_len)
        ]

        is_no_speech = (state.no_speech_prob > params.no_speech_thold
                        and avg_logprobs < params.logprob_thold)

        # update prompt_past (:7560-7571)
        new_past: List[int] = []
        if prompt and prompt[0] == vocab.token_prev:
            new_past = prompt[1 : len(prompt) - len(prompt_init)]
        if not is_no_speech:
            new_past += [td.id for td in tokens_cur]
        prompt_past = new_past

        if tokens_cur and not is_no_speech:
            new_segments = seg_mod.emit_segments(
                tokens_cur, seek, seek_delta, vocab, ctx.tokenizer, params,
                state.no_speech_prob)

            if params.token_timestamps and new_segments:
                from whisper_tpu_torch.decoding.timestamps import (
                    compute_token_level_timestamps)
                wrapped: List[Segment] = []
                for s in new_segments:
                    compute_token_level_timestamps(
                        state, s, params.thold_pt, params.thold_ptsum)
                    if params.max_len > 0:
                        wrapped.extend(seg_mod.wrap_segment(
                            s, vocab, params.max_len, params.split_on_word))
                    else:
                        wrapped.append(s)
                new_segments = wrapped

            # DTW token timestamps for this window's segments (:7679-7692)
            if ctx.cparams.dtw_token_timestamps and new_segments:
                from whisper_tpu_torch.decoding.dtw import compute_dtw_timestamps
                n_frames = min(100 * CHUNK_SIZE, seek_delta, seek_end - seek)
                t0 = time.perf_counter()
                compute_dtw_timestamps(state, params, new_segments, seek, n_frames)
                state.timings.add("dtw", time.perf_counter() - t0)

            for s in new_segments:
                result_all.append(s)
                if params.new_segment_callback:
                    params.new_segment_callback(ctx, state, s)

        # single-timestamp ending: skip the whole chunk (:7694-7701)
        if (len(tokens_cur) > 1
                and tokens_cur[-2].id < vocab.token_beg
                and tokens_cur[-1].id > vocab.token_beg):
            seek_delta = min(seek_end - seek, 100 * CHUNK_SIZE)

        seek += seek_delta
        rng_seed += 1000

        if params.abort_callback and params.abort_callback(ctx, state):
            break

    state.prompt_past = prompt_past

    # remap segment times through the VAD mapping (:7882-7960)
    if state.vad_mapping:
        from whisper_tpu_torch.models.vad import remap_segment_times
        for s in result_all:
            remap_segment_times(s, state.vad_mapping)
    return result_all
