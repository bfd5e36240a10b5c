"""run_full_batch — transcribe many utterances at once on one card, with
continuous lane refill.

Counterpart of whisper_tpu/decoding/batch_full.py, the answer to
whisper_full_parallel (reference src/whisper.cpp:7736-7864): instead of N
host threads each walking its own audio chunk, utterances occupy a fixed
set of lanes that advance their 30 s windows in lockstep: per round, one
batched encode of every lane's current window (the encoder's
self-attention through the flash kernel at batch = lanes) and one batched
window decode (decoding/batch_loop.py), whose every decoder call carries
all lanes' rows. Between rounds each freed lane is refilled from the
pending utterances; `stats["lane_occupancy"]` reports the share of lane
rounds that did work.

Each utterance owns K decoder rows (beam_size / best_of) with
block-diagonal beam forks; the temperature ladder reruns only the rows
that need it. DFA-compilable grammars ride along as per-row table
gathers. A logits callback, or a grammar over the DFA's budget, carries
host state the batch loop cannot fold: such a request runs each utterance
through run_full (the JAX package's routing, not a device fallback).

With a mesh (parallel/mesh.py; every rank of it calls with the same
utterances), each data coordinate transcribes its `local_batch_slice` of
the utterances through ceil(n_lanes / n_data) lanes, and the ranks of one
model group run those utterances in lockstep under tensor parallelism. A
context built with ContextParams.mesh_shape holds only this rank's shard
and runs its own mesh. A whole context runs any mesh on a view whose
params are this rank's shard, cut once per mesh on first use when the
model dim is above 1; the view lives beside the whole params, so each
rank's card then holds 1 + 1/n_model of the model. The segments come
back across the data dim (all_gather_object), so every rank returns the
whole list in input order, as the JAX package's single-controller call
does; so do `stats` and `lang_sink`. `timings_sink` takes this rank's
timings only.
"""

from __future__ import annotations

import copy
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from whisper_tpu_torch import languages
from whisper_tpu_torch.api import Segment, TokenData
from whisper_tpu_torch.config import CHUNK_SIZE, MAX_DECODERS, FullParams, SamplingStrategy
from whisper_tpu_torch.decoding import batch_loop, device_loop, filters, scoring
from whisper_tpu_torch.decoding import segments as seg_mod
from whisper_tpu_torch.decoding.state_machine import DELTA_MIN
from whisper_tpu_torch.models import whisper as model_mod


class _RowsView:
    """One utterance's rows of a BatchWindowResult, shaped like a
    WindowResult for scoring.rank_decoders."""

    def __init__(self, tokens, tok_plog, result_len, failed):
        self.tokens = tokens
        self.tok_plog = tok_plog
        self.result_len = result_len
        self.failed = failed


class _Utt:
    """Host-side state of one utterance while it occupies a lane."""

    __slots__ = ("idx", "st", "seek", "seek_end", "prompt_init",
                 "prompt_past", "vad_mapping", "lang_id")

    def __init__(self, idx, st, seek, seek_end, prompt_init, prompt_past,
                 vad_mapping, lang_id):
        self.idx = idx
        self.st = st
        self.seek = seek
        self.seek_end = seek_end
        self.prompt_init = prompt_init
        self.prompt_past = prompt_past
        self.vad_mapping = vad_mapping
        self.lang_id = lang_id

    @property
    def done(self) -> bool:
        return self.seek + DELTA_MIN >= self.seek_end


def _lane(kv, lane: int):
    """One lane's (L, 1, ...) slice of a batched cross K or V, or of both
    parts of an int8 (codes, scales) tuple."""
    if isinstance(kv, tuple):
        return tuple(t[:, lane:lane + 1] for t in kv)
    return kv[:, lane:lane + 1]


def _init_utt(ctx, params: FullParams, idx: int, audio: np.ndarray,
              no_timestamps: bool, language, need_detect: bool) -> _Utt:
    """Admission of one utterance: VAD, mel, energy, language, prompt
    seed and seek bounds, everything run_full does before its window loop
    (reference whisper_full :6814-6995)."""
    hp = ctx.hparams
    vocab = ctx.vocab
    st = ctx.create_state()
    audio = np.asarray(audio, np.float32)

    vad_mapping = None
    if params.vad:
        from whisper_tpu_torch.models.vad import vad_filter_audio
        filtered, vad_mapping = vad_filter_audio(st, audio, params)
        audio = (filtered if filtered is not None and len(filtered)
                 else np.zeros(0, np.float32))

    if len(audio):
        st.pcm_to_mel(audio)
    if params.token_timestamps and len(audio):
        from whisper_tpu_torch.decoding.timestamps import get_signal_energy
        st.t_beg = st.t_last = st.tid_last = 0
        st.energy = get_signal_energy(audio, 32)

    lang_id = 0
    if hp.is_multilingual:
        if need_detect:
            if st.mel is not None:
                from whisper_tpu_torch.decoding.language import lang_auto_detect
                lang_id, _ = lang_auto_detect(st, 0)
        else:
            lang_id = languages.lang_id(language)
    st.lang_id = int(lang_id)

    prompt_init = [vocab.token_sot]
    if hp.is_multilingual:
        prompt_init.append(vocab.token_lang(int(lang_id)))
        prompt_init.append(vocab.token_translate if params.translate
                           else vocab.token_transcribe)
    if no_timestamps:
        prompt_init.append(vocab.token_not)

    seek_start = params.offset_ms // 10
    seek_end = (0 if st.mel is None                   # VAD removed everything
                else st.n_len_org if params.duration_ms == 0
                else seek_start + params.duration_ms // 10)

    # the initial prompt seeds the past (reference :6906-6931)
    prompt_past: List[int] = (list(params.prompt_tokens)
                              if params.prompt_tokens else [])
    return _Utt(idx, st, seek_start, seek_end, prompt_init, prompt_past,
                vad_mapping, int(lang_id))


def run_full_batch(
    ctx,
    params: FullParams,
    audios: Sequence[np.ndarray],
    mesh=None,
    timings_sink=None,
    lang_sink: Optional[List[int]] = None,
    n_lanes: Optional[int] = None,
    stats: Optional[dict] = None,
) -> List[List[Segment]]:
    if mesh is not None:
        return _run_meshed(ctx, params, audios, mesh, timings_sink, lang_sink,
                           n_lanes, stats)
    hp = ctx.hparams
    vocab = ctx.vocab
    dev = ctx.device
    n_utt = len(audios)
    if n_utt == 0:
        return []
    if params.n_decoders > MAX_DECODERS:
        # the reference errors rather than clamping (src/whisper.cpp:6881-6883)
        raise ValueError(f"too many decoders requested ({params.n_decoders})")
    B = max(1, min(n_lanes or n_utt, n_utt))      # lane count (device batch)

    # DFA-compilable grammars fold into the lockstep loop as per-row table
    # gathers (decoding/grammar_dfa.py); logits callbacks and over-budget
    # grammars run each utterance through run_full (host loop as loop.py
    # decides), with the same merge semantics
    grammar_dfa = None
    g_rej = g_trans = None
    if params.grammar_rules is not None:
        from whisper_tpu_torch.decoding.grammar_dfa import cached_dfa
        grammar_dfa = cached_dfa(params.grammar_rules, vocab)
        if grammar_dfa is not None:
            g_rej, g_trans = grammar_dfa.device_tables(dev)
    if ((params.grammar_rules is not None and grammar_dfa is None)
            or params.logits_filter_callback is not None):
        from whisper_tpu_torch.decoding.loop import run_full
        out = []
        for audio in audios:
            st = ctx.create_state()
            out.append(run_full(st, params, audio))
            if timings_sink is not None:
                for phase, stat in st.timings.phases.items():
                    timings_sink.add(phase, stat.total_s, stat.calls)
        return out

    prompt_max = hp.n_text_ctx // 2 + 8
    temperatures = params.temperatures()

    no_timestamps = params.no_timestamps
    # distil models force no_timestamps (run_full's is_distil rule,
    # reference src/whisper.cpp:6954-6959), and the filters must see it
    if hp.n_text_layer == 2 and hp.n_vocab != 51866 and not no_timestamps:
        no_timestamps = True
    fparams = params
    if no_timestamps != params.no_timestamps:
        fparams = copy.copy(params)
        fparams.no_timestamps = True
    consts, tids = filters.build_filter_consts(vocab, hp, fparams, dev)

    if params.initial_prompt and not params.prompt_tokens:
        params.prompt_tokens = ctx.tokenizer.encode(params.initial_prompt)

    language = params.language
    need_detect = (language in (None, "", "auto") or params.detect_language)

    results: List[List[Segment]] = [[] for _ in range(n_utt)]
    seek_start = params.offset_ms // 10

    # language-detect-only calls report every utterance and stop
    # (reference :6814-6830)
    if params.detect_language:
        for i, audio in enumerate(audios):
            u = _init_utt(ctx, params, i, audio, no_timestamps, language,
                          need_detect)
            if lang_sink is not None:
                lang_sink.append(u.lang_id)
        return results

    # ---- lanes and the admission queue (continuous batching) ------------
    pending = list(range(n_utt))
    lanes: List[Optional[_Utt]] = [None] * B
    done_states: List[_Utt] = []
    rounds = 0
    lane_rounds_active = 0
    n_admit = 0

    def admit():
        nonlocal n_admit
        for lane in range(B):
            while True:
                if lanes[lane] is not None and lanes[lane].done:
                    done_states.append(lanes[lane])
                    lanes[lane] = None
                if lanes[lane] is None and pending:
                    i = pending.pop(0)
                    u = _init_utt(ctx, params, i, audios[i], no_timestamps,
                                  language, need_detect)
                    if lang_sink is not None:
                        lang_sink.append(u.lang_id)
                    lanes[lane] = u
                    n_admit += 1
                    continue   # a freshly admitted utterance may be done
                break

    attn_fn = None
    if ctx.use_flash:
        from whisper_tpu_torch.ops.flash_attention import flash_attention
        attn_fn = flash_attention

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng_seed = 0
    while True:
        admit()
        active = np.array([u is not None and not u.done for u in lanes])
        if not active.any():
            break
        rounds += 1
        lane_rounds_active += int(active.sum())

        seek = np.array([u.seek if u else 0 for u in lanes], np.int32)
        seek_end = np.array([u.seek_end if u else 0 for u in lanes], np.int32)

        # ---- batched encode of every lane's current window --------------
        t0 = time.perf_counter()
        windows = [
            (u.st.mel_window(int(u.seek))[0]
             if u is not None and u.st.mel is not None
             else torch.zeros(hp.n_mels, 2 * hp.n_audio_ctx, device=dev))
            for u in lanes]
        mel_batch = torch.stack(windows)                   # (B, n_mels, 3000)
        embed = model_mod.encoder_forward(ctx.params, hp, mel_batch, ctx.dtype, attn_fn,
                                          tp=ctx.tp)
        ck, cv = model_mod.cross_attention_kv(ctx.params, hp, embed, quant=ctx.kv_quant,
                                              tp=ctx.tp)
        sync()
        # one batched call covers every active lane: each lane's state gets
        # an even share of the wall time (amortized batch cost)
        for lane, u in enumerate(lanes):
            if u is not None and active[lane]:
                u.st.timings.add("encode", (time.perf_counter() - t0) / max(1, active.sum()))

        # drop the stale prompt near the end (reference :7013-7016)
        for u in lanes:
            if (u is not None and not u.done and u.seek > seek_start
                    and u.seek + 500 >= u.seek_end):
                u.prompt_past = []

        # ---- decode attempts over the temperature ladder ----------------
        # each utterance owns K rows per attempt: beam_size under
        # BEAM_SEARCH at t = 0, best_of when sampling at t > 0 (the
        # reference's n_decoders_cur, src/whisper.cpp:7024-7044)
        needy = active.copy()
        best = [None] * B          # per lane (result, winning row, score, prompt)
        for it, t_cur in enumerate(temperatures):
            if not needy.any():
                break
            if params.strategy == SamplingStrategy.GREEDY:
                strat = device_loop.SAMPLE if t_cur > 0 else device_loop.GREEDY_BEST
                K = params.greedy.best_of if t_cur > 0 else 1
            elif t_cur > 0:
                strat = device_loop.SAMPLE
                K = params.greedy.best_of
            else:
                strat = device_loop.BEAM
                K = params.beam_search.beam_size
            K = max(1, K)

            # per-lane prompts for this attempt: past-text conditioning only
            # below t = 0.5 (reference :7076), padded to the smallest of the
            # three buckets that fits every lane (as loop.py pads)
            plens = np.ones(B, np.int64)
            row_prompts: List[List[int]] = []
            for lane, u in enumerate(lanes):
                pr: List[int] = []
                if u is not None:
                    if (u.prompt_past and t_cur < 0.5
                            and params.n_max_text_ctx > 0):
                        n_take = min(params.n_max_text_ctx, hp.n_text_ctx // 2,
                                     len(u.prompt_past))
                        pr = [vocab.token_prev] + u.prompt_past[-n_take:]
                    pr = (pr + u.prompt_init)[:prompt_max]
                row_prompts.append(pr)
                plens[lane] = max(1, len(pr))
            buckets = sorted({min(8, prompt_max), min(64, prompt_max), prompt_max})
            bucket = next(b for b in buckets if plens.max() <= b)
            prompts = np.zeros((B, bucket), np.int64)
            for lane in range(B):
                prompts[lane, : len(row_prompts[lane])] = row_prompts[lane]

            t0 = time.perf_counter()
            generator = torch.Generator(device=dev)
            generator.manual_seed(rng_seed + it)
            res = batch_loop.decode_windows_batch(
                ctx.params, hp, consts, ck, cv, prompts, plens, t_cur, seek,
                seek_end, needy, generator, g_rej, g_trans, params.grammar_penalty,
                tids=tids, n_utt=B, n_per_utt=K, strategy=strat,
                max_tokens=params.max_tokens,
                single_segment=params.single_segment,
                no_timestamps=no_timestamps, dtype=ctx.dtype,
                kv_quant=ctx.kv_quant,
                beam_multinomial=params.beam_search.multinomial_candidates,
                tp=ctx.tp)
            n_steps = int(res.n_tokens)
            for lane, u in enumerate(lanes):
                if u is not None and needy[lane]:
                    u.st.timings.add("decode",
                                     (time.perf_counter() - t0) / max(1, needy.sum()),
                                     max(1, n_steps))

            for lane, u in enumerate(lanes):
                if not needy[lane] or u is None:
                    continue
                rows = slice(lane * K, (lane + 1) * K)
                view = _RowsView(
                    tokens=res.tokens[rows], tok_plog=res.tok_plog[rows],
                    result_len=res.result_len[rows], failed=res.failed[rows])
                j, row_scores, row_failed = scoring.rank_decoders(view, params)
                sc = row_scores[j]
                all_failed = bool(row_failed[j]) or sc is None
                fallback = scoring.needs_fallback(
                    all_failed,
                    sc.avg_logprobs if sc else float("-inf"),
                    float(res.no_speech_prob[lane]),
                    params, it == len(temperatures) - 1)
                best[lane] = (res, lane * K + j,
                              sc or scoring.score_sequence(
                                  np.zeros(0, np.int32), np.zeros(0, np.float32),
                                  params.length_penalty),
                              row_prompts[lane])
                if not fallback:
                    needy[lane] = False
            # lanes still needy rerun at the next temperature

        # ---- emit per-lane segments --------------------------------------
        for lane, u in enumerate(lanes):
            if u is None or not active[lane]:
                continue
            res, rb, sc, win_prompt = best[lane]
            result_len = int(res.result_len[rb])
            sd = int(res.seek_delta[rb])
            nsp = float(res.no_speech_prob[lane])   # per utterance
            u.st.no_speech_prob = nsp

            tokens_cur = [
                TokenData(id=int(res.tokens[rb, i]), tid=int(res.tok_tid[rb, i]),
                          p=float(res.tok_p[rb, i]), plog=float(res.tok_plog[rb, i]),
                          pt=float(res.tok_pt[rb, i]), ptsum=float(res.tok_ptsum[rb, i]))
                for i in range(result_len)
            ]
            is_no_speech = (nsp > params.no_speech_thold
                            and sc.avg_logprobs < params.logprob_thold)

            # prompt_past from the winning attempt's prompt (reference
            # :7563-7571)
            new_past: List[int] = []
            if win_prompt and win_prompt[0] == vocab.token_prev:
                new_past = win_prompt[1: len(win_prompt) - len(u.prompt_init)]
            if not is_no_speech:
                new_past += [td.id for td in tokens_cur]
            u.prompt_past = new_past

            if tokens_cur and not is_no_speech:
                segs = seg_mod.emit_segments(
                    tokens_cur, int(u.seek), sd, vocab, ctx.tokenizer, params, nsp)
                if params.token_timestamps and segs:
                    from whisper_tpu_torch.decoding.timestamps import (
                        compute_token_level_timestamps)
                    wrapped = []
                    for s in segs:
                        compute_token_level_timestamps(
                            u.st, s, params.thold_pt, params.thold_ptsum)
                        if params.max_len > 0:
                            wrapped.extend(seg_mod.wrap_segment(
                                s, vocab, params.max_len, params.split_on_word))
                        else:
                            wrapped.append(s)
                    segs = wrapped
                # DTW token timestamps, as run_full (:7679-7692): the
                # collecting pass reads the state's cross K/V, so the state
                # gets this lane's slice of the batched one
                if ctx.cparams.dtw_token_timestamps and segs:
                    from whisper_tpu_torch.decoding.dtw import compute_dtw_timestamps
                    u.st.cross_k, u.st.cross_v = _lane(ck, lane), _lane(cv, lane)
                    n_frames = min(100 * CHUNK_SIZE, sd, int(u.seek_end - u.seek))
                    compute_dtw_timestamps(u.st, params, segs, int(u.seek), n_frames)
                results[u.idx].extend(segs)

            if (result_len > 1
                    and tokens_cur and len(tokens_cur) > 1
                    and tokens_cur[-2].id < vocab.token_beg
                    and tokens_cur[-1].id > vocab.token_beg):
                sd = min(int(u.seek_end - u.seek), 100 * CHUNK_SIZE)
            u.seek += sd
        rng_seed += 1000

    done_states.extend(u for u in lanes if u is not None)

    # remap segment times through each utterance's VAD mapping
    # (reference :7882-7960, as in run_full)
    if params.vad:
        from whisper_tpu_torch.models.vad import remap_segment_times
        for u in done_states:
            if u.vad_mapping:
                for s in results[u.idx]:
                    remap_segment_times(s, u.vad_mapping)

    if timings_sink is not None:
        # the sum of the utterances' timings (reference whisper_full_parallel
        # sums its workers', src/whisper.cpp:7849-7858)
        for u in done_states:
            for phase, stat in u.st.timings.phases.items():
                timings_sink.add(phase, stat.total_s, stat.calls)
    if stats is not None:
        stats["n_lanes"] = B
        stats["rounds"] = rounds
        stats["admitted"] = n_admit
        stats["lane_occupancy"] = (
            lane_rounds_active / (rounds * B) if rounds else 1.0)
    return results


def mesh_view(ctx, mesh):
    """(DeviceMesh, context) of `mesh` as this rank runs it. `mesh` is a
    DeviceMesh of parallel/mesh.py or an (n_data, n_model) shape, made into
    one by make_mesh. A context built for a mesh (ContextParams.mesh_shape)
    runs that mesh only. Otherwise the context is `ctx` itself when the
    model dim is 1, else a copy whose params are this rank's shard and
    whose `tp` is the model group; it has no draft (full_batch never
    speculates). Both are made once per mesh (or shape) and kept on
    `ctx`."""
    from torch.distributed.device_mesh import DeviceMesh

    from whisper_tpu_torch.parallel import mesh as mesh_mod

    if not isinstance(mesh, (DeviceMesh, tuple)):
        raise TypeError(f"mesh: a DeviceMesh or an (n_data, n_model) shape, "
                        f"got {type(mesh).__name__}")
    if ctx.mesh is not None:
        if mesh is ctx.mesh or (isinstance(mesh, tuple)
                                and mesh == tuple(ctx.cparams.mesh_shape)):
            return ctx.mesh, ctx
        raise ValueError(f"the context holds the shard of its mesh_shape "
                         f"{tuple(ctx.cparams.mesh_shape)}; it runs no other mesh")
    key = mesh if isinstance(mesh, tuple) else id(mesh)
    hit = ctx.mesh_views.get(key)
    if hit is not None and (isinstance(mesh, tuple) or hit[0] is mesh):
        return hit
    if isinstance(mesh, tuple):
        mesh = mesh_mod.make_mesh(*mesh, device_type=ctx.device.type)
    view = ctx
    if mesh.size(1) > 1:
        view = copy.copy(ctx)
        view.mesh_views = {}
        view.draft = None
        view.params = mesh_mod.shard_params(ctx.params, mesh, ctx.hparams)
        view.tp = mesh_mod.model_group(mesh)
    # the mesh is kept alive with its view, so its id stays its own
    ctx.mesh_views[key] = (mesh, view)
    return mesh, view


def _run_meshed(ctx, params, audios, mesh, timings_sink, lang_sink, n_lanes, stats):
    """run_full_batch over a mesh (module docstring; mesh_view)."""
    import torch.distributed as dist

    from whisper_tpu_torch.parallel import distributed

    mesh, view = mesh_view(ctx, mesh)
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh}")
    n_data = mesh.size(0)
    part = distributed.local_batch_slice(len(audios), n_data, coord[0])
    lanes = -(-(n_lanes or len(audios)) // n_data)
    local_stats = {} if stats is not None else None
    local_langs = [] if lang_sink is not None else None
    local = run_full_batch(view, params, list(audios)[part],
                           timings_sink=timings_sink, lang_sink=local_langs,
                           n_lanes=lanes, stats=local_stats)
    parts = [None] * n_data
    dist.all_gather_object(
        parts, (part.start, local, local_langs, local_stats),
        group=mesh.get_group("data"))

    results: List[List[Segment]] = [[] for _ in audios]
    merged = {"n_lanes": 0, "rounds": 0, "admitted": 0}
    active = 0
    for start, segs, langs, st in parts:
        results[start: start + len(segs)] = segs
        if lang_sink is not None:
            lang_sink.extend(langs)
        if st:
            merged["n_lanes"] += st["n_lanes"]
            merged["rounds"] = max(merged["rounds"], st["rounds"])
            merged["admitted"] += st["admitted"]
            active += st["lane_occupancy"] * st["rounds"] * st["n_lanes"]
    if stats is not None:
        stats.update(merged)
        stats["lane_occupancy"] = (
            active / sum(st["rounds"] * st["n_lanes"] for *_, st in parts if st)
            if merged["rounds"] else 1.0)
        stats["n_data"], stats["n_model"] = mesh.size(0), mesh.size(1)
    return results
