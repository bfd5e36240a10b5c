"""whisper-tpu-torch CLI — batch transcriber.

Counterpart of whisper_tpu/serving/cli.py (reference examples/cli/cli.cpp:
flag surface :38-197, main flow :923-1295): the same flags, defaults,
output files and exit codes (1: no input, 3: the context failed to
initialise). The model runs on the first CUDA device; -ng runs it on the
CPU. The JAX package's --jax-cache-dir (XLA's compile cache) has no
counterpart: the port's kernels build once into whisper_tpu_torch/_build.

Usage:  python -m whisper_tpu_torch.serving.cli -m model.bin -f audio.wav -otxt
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


# xterm-256 codes approximating the reference's red->green confidence ramp
# (examples/common.h k_colors; exact RGB mapped to the 6x6x6 cube)
_K_COLORS = [196, 202, 208, 214, 220, 114, 71]


def _token_text(ctx, tid: int) -> str:
    t = ctx.tokenizer.token_str(tid)
    return t if t is not None else ""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="whisper-tpu-torch",
        description="Whisper transcriber on PyTorch and CUDA "
                    "(whisper-cli compatible surface)")
    a = p.add_argument
    a("-t", "--threads", type=int, default=4)
    a("-p", "--processors", type=int, default=1,
      help="parallel utterance batch size (data-parallel windows)")
    a("-ot", "--offset-t", type=int, default=0, help="time offset in ms")
    a("-on", "--offset-n", type=int, default=0, help="segment index offset")
    a("-d", "--duration", type=int, default=0, help="duration to process in ms")
    a("-mc", "--max-context", type=int, default=-1)
    a("-ml", "--max-len", type=int, default=0)
    a("-sow", "--split-on-word", action="store_true")
    a("-bo", "--best-of", type=int, default=5)
    a("-bs", "--beam-size", type=int, default=-1)
    a("-ac", "--audio-ctx", type=int, default=0)
    a("-wt", "--word-thold", type=float, default=0.01)
    a("-et", "--entropy-thold", type=float, default=2.40)
    a("-lpt", "--logprob-thold", type=float, default=-1.0)
    a("-nth", "--no-speech-thold", type=float, default=0.6)
    a("-tp", "--temperature", type=float, default=0.0)
    a("-tpi", "--temperature-inc", type=float, default=0.2)
    a("-debug", "--debug-mode", action="store_true")
    a("-tr", "--translate", action="store_true")
    a("-di", "--diarize", action="store_true", help="stereo diarization")
    a("-tdrz", "--tinydiarize", action="store_true")
    a("-nf", "--no-fallback", action="store_true")
    a("-otxt", "--output-txt", action="store_true")
    a("-ovtt", "--output-vtt", action="store_true")
    a("-osrt", "--output-srt", action="store_true")
    a("-olrc", "--output-lrc", action="store_true")
    a("-owts", "--output-words", action="store_true")
    a("-fp", "--font-path", default="/System/Library/Fonts/Supplemental/Courier New Bold.ttf")
    a("-ocsv", "--output-csv", action="store_true")
    a("-oj", "--output-json", action="store_true")
    a("-ojf", "--output-json-full", action="store_true")
    a("-of", "--output-file", default=None, help="output path without extension")
    a("-np", "--no-prints", action="store_true")
    a("-ps", "--print-special", action="store_true")
    a("-pc", "--print-colors", action="store_true")
    a("--print-confidence", action="store_true")
    a("-pp", "--print-progress", action="store_true")
    a("-nt", "--no-timestamps", action="store_true")
    a("-l", "--language", default="en")
    a("-dl", "--detect-language", action="store_true")
    a("--prompt", default=None)
    a("-m", "--model", default="models/ggml-base.en.bin")
    a("-f", "--file", nargs="*", default=[], help="input WAV file(s)")
    a("-oved", "--ov-e-device", default="CPU")   # accepted for parity; unused
    a("-dtw", "--dtw", default="", help="alignment-heads preset for DTW timestamps")
    a("-ls", "--log-score", action="store_true")
    a("-ng", "--no-gpu", action="store_true", help="run the model on the CPU")
    a("-fa", "--flash-attn", action="store_true")
    a("-sns", "--suppress-nst", action="store_true")
    a("--suppress-regex", default=None)
    a("--grammar", default=None, help="GBNF grammar to guide decoding")
    a("--grammar-rule", default="root")
    a("--profile-dir", default=None,
      help="capture a torch.profiler Chrome trace into this dir")
    a("--draft-model", default=None,
      help="draft checkpoint for speculative greedy decoding (same vocab, "
           "e.g. distil-large-v3 against large-v3) — see PERF.md")
    a("--spec-k", type=int, default=8,
      help="speculative chunk length (draft tokens per main-model verify)")
    a("--draft-shares-encoder", action="store_true",
      help="draft keeps the teacher's frozen encoder (distil models): skip "
           "its encoder pass and reuse the main model's encoder output")
    a("--kv-int8", action="store_true",
      help="int8 self- and cross-KV cache with per-row scales: halves the "
           "cache's device memory")
    a("--warmup", action="store_true",
      help="run a throwaway transcription before the first file (timings "
           "then exclude the kernels' build and first-use costs)")
    a("--grammar-penalty", type=float, default=100.0)
    # VAD
    a("--vad", action="store_true")
    a("-vm", "--vad-model", default=None)
    a("-vt", "--vad-threshold", type=float, default=0.5)
    a("-vspd", "--vad-min-speech-duration-ms", type=int, default=250)
    a("-vsd", "--vad-min-silence-duration-ms", type=int, default=100)
    a("-vmsd", "--vad-max-speech-duration-s", type=float, default=float("inf"))
    a("-vp", "--vad-speech-pad-ms", type=int, default=30)
    a("-vo", "--vad-samples-overlap", type=float, default=0.1)
    return p


def params_from_args(args) -> "FullParams":
    from whisper_tpu_torch.config import (BeamSearchParams, FullParams, GreedyParams,
                                          SamplingStrategy, VadParams)

    strategy = (SamplingStrategy.BEAM_SEARCH if args.beam_size > 1
                else SamplingStrategy.GREEDY)
    p = FullParams.default(strategy)
    p.n_threads = args.threads
    p.offset_ms = args.offset_t
    p.duration_ms = args.duration
    if args.max_context >= 0:
        p.n_max_text_ctx = args.max_context
    # -owts without -ml: 60-char karaoke lines (cli.cpp:1169)
    p.max_len = (60 if args.output_words and args.max_len == 0
                 else args.max_len)
    p.split_on_word = args.split_on_word
    p.greedy = GreedyParams(best_of=args.best_of)
    if args.beam_size > 1:
        p.beam_search = BeamSearchParams(beam_size=args.beam_size)
    p.audio_ctx = args.audio_ctx
    p.thold_pt = args.word_thold
    p.entropy_thold = args.entropy_thold
    p.logprob_thold = args.logprob_thold
    p.no_speech_thold = args.no_speech_thold
    p.temperature = args.temperature
    p.temperature_inc = 0.0 if args.no_fallback else args.temperature_inc
    p.debug_mode = args.debug_mode
    p.translate = args.translate
    p.tdrz_enable = args.tinydiarize
    p.language = None if args.detect_language or args.language == "auto" else args.language
    p.detect_language = args.detect_language
    p.initial_prompt = args.prompt
    p.print_special = args.print_special
    p.print_progress = args.print_progress
    p.no_timestamps = args.no_timestamps
    # full-JSON also carries per-token timing (cli.cpp:1167)
    p.token_timestamps = (args.output_words or args.output_json_full
                          or args.max_len > 0)
    p.suppress_nst = args.suppress_nst
    p.suppress_regex = args.suppress_regex
    if args.grammar:
        import os

        from whisper_tpu_torch.decoding.grammar import parse_gbnf
        src = args.grammar
        if os.path.isfile(src):          # file path or inline text (cli.cpp:1033)
            with open(src) as f:
                src = f.read()
        p.grammar_rules = parse_gbnf(src, args.grammar_rule)
        p.grammar_penalty = args.grammar_penalty
    p.vad = args.vad
    p.vad_model_path = args.vad_model
    p.vad_params = VadParams(
        threshold=args.vad_threshold,
        min_speech_duration_ms=args.vad_min_speech_duration_ms,
        min_silence_duration_ms=args.vad_min_silence_duration_ms,
        max_speech_duration_s=args.vad_max_speech_duration_s,
        speech_pad_ms=args.vad_speech_pad_ms,
        samples_overlap=args.vad_samples_overlap,
    )
    return p


def _dtw_params(args):
    from whisper_tpu_torch.config import AlignmentHeadsPreset, ContextParams, DtwParams
    cp = ContextParams()
    if args.no_gpu:
        cp.use_gpu = False
    cp.flash_attn = args.flash_attn or cp.flash_attn
    if getattr(args, "kv_int8", False):
        cp.kv_dtype = "int8"          # halve the KV cache's device memory
    if getattr(args, "draft_model", None):
        cp.draft_model = args.draft_model
        cp.spec_k = args.spec_k
        cp.draft_shares_encoder = args.draft_shares_encoder
    if args.dtw:
        name = args.dtw.replace(".", "_").replace("-", "_").upper()
        try:
            preset = AlignmentHeadsPreset[name]
        except KeyError:
            raise SystemExit(f"error: unknown DTW preset '{args.dtw}'")
        cp.dtw_token_timestamps = True
        cp.dtw = DtwParams(mode=preset)
    return cp


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if not args.file:
        print("error: no input files specified", file=sys.stderr)
        return 1

    from whisper_tpu_torch.api import WhisperContext
    from whisper_tpu_torch.audio.io import read_audio_data
    from whisper_tpu_torch.serving import writers

    cp = _dtw_params(args)
    try:
        ctx = WhisperContext.new_with_params(args.model, cp)
    except (OSError, ValueError) as e:
        print(f"error: failed to initialize whisper context: {e}", file=sys.stderr)
        return 3

    params = params_from_args(args)

    if args.warmup:
        ctx.warmup(params)

    import contextlib

    from whisper_tpu_torch.utils.profiling import trace as profiler_trace
    stack = contextlib.ExitStack()
    stack.enter_context(profiler_trace(args.profile_dir))

    for fname in args.file:
        try:
            samples, pcmf32s = read_audio_data(fname, stereo=args.diarize)
        except Exception as e:
            print(f"error: failed to read audio file '{fname}': {e}", file=sys.stderr)
            continue

        state = ctx.create_state()
        if args.processors > 1:
            # reference cli.cpp routes -p N through whisper_full_parallel
            # (:1199); the port batches the chunks (api.full_parallel)
            rc_full = state.full_parallel(params, samples, args.processors)
        else:
            rc_full = state.full(params, samples)
        if rc_full != 0:
            print(f"error: failed to process audio '{fname}'", file=sys.stderr)
            continue

        if not args.no_prints:
            for s in state.segments:
                if args.no_timestamps:
                    print(s.text, end="", flush=True)
                else:
                    from whisper_tpu_torch.decoding.segments import to_timestamp
                    spk = ""
                    if pcmf32s is not None:
                        spk = writers.estimate_diarization_speaker(pcmf32s, s.t0, s.t1)
                    trailing = " [SPEAKER_TURN]" if s.speaker_turn_next else ""
                    if args.print_colors:
                        # confidence coloring (reference cli.cpp:376-391:
                        # col = p^3 * len(k_colors), red -> green)
                        body = "".join(
                            f"\033[38;5;{_K_COLORS[max(0, min(len(_K_COLORS) - 1, int(t.p ** 3 * len(_K_COLORS))))]}m"
                            f"{_token_text(ctx, t.id)}\033[0m"
                            for t in s.tokens
                            if args.print_special or t.id < ctx.vocab.token_eot)
                    elif args.print_confidence:
                        # reference cli.cpp:392-410: inverse (<0.33),
                        # underline (<0.66), dim (high confidence)
                        def _style(p_):
                            return "\033[7m" if p_ < 0.33 else (
                                "\033[4m" if p_ < 0.66 else "\033[2m")
                        body = "".join(
                            f"{_style(t.p)}{_token_text(ctx, t.id)}\033[0m"
                            for t in s.tokens
                            if args.print_special or t.id < ctx.vocab.token_eot)
                    else:
                        body = s.text
                    print(f"[{to_timestamp(s.t0)} --> {to_timestamp(s.t1)}]  "
                          f"{spk}{body}{trailing}")
            if args.no_timestamps:
                print()

        base = args.output_file or fname
        outs = {
            "txt": args.output_txt, "vtt": args.output_vtt, "srt": args.output_srt,
            "lrc": args.output_lrc, "csv": args.output_csv,
        }
        for fmt, enabled in outs.items():
            if enabled:
                with open(f"{base}.{fmt}", "w", encoding="utf-8") as f:
                    if fmt == "srt":
                        # reference cli.cpp output_srt numbers from
                        # offset_n + 1 (the -on flag)
                        writers.write_srt(state.segments, f, args, pcmf32s,
                                          offset_n=args.offset_n)
                    else:
                        writers.WRITERS[fmt](state.segments, f, args, pcmf32s)
        if args.output_json or args.output_json_full:
            with open(f"{base}.json", "w", encoding="utf-8") as f:
                writers.write_json(
                    state.segments, ctx, f, args, pcmf32s,
                    full=args.output_json_full, model_path=args.model,
                    language=args.language, translate=args.translate,
                    lang_id=state.lang_id)
        if args.output_words:
            with open(f"{base}.wts", "w", encoding="utf-8") as f:
                writers.write_wts(state.segments, ctx, f, fname_inp=fname,
                                  t_sec=len(samples) / 16000.0,
                                  fname_out=f"{base}.mp4",
                                  font_path=args.font_path)
        if args.log_score:
            with open(f"{base}.score.txt", "w", encoding="utf-8") as f:
                writers.write_score(state.segments, ctx, f)

        if not args.no_prints:
            print(state.print_timings(), file=sys.stderr)

    stack.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
