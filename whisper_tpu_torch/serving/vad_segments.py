"""Standalone VAD speech-segment printer.

Counterpart of whisper_tpu/serving/vad_segments.py, which reproduces the
reference example `examples/vad-speech-segments/speech.cpp`: load a
Silero-VAD ggml model, compute per-window speech probabilities, run the
hysteresis segmenter, and print

    Detected N speech segments:
    Speech segment 0: start = 1.28, end = 2.56
    ...

Flags mirror speech.cpp:11-23 (threshold / min-speech / min-silence /
max-speech / pad / overlap). The model runs on the first CUDA device;
`-ng` / `--no-gpu` (whisper-cli's flag) runs it on the CPU.

Usage:
  python -m whisper_tpu_torch.serving.vad_segments -f audio.wav -vm ggml-vad.bin
"""

from __future__ import annotations

import argparse
import sys

from whisper_tpu_torch.config import VadParams


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vad-speech-segments",
        description="detect speech segments with Silero-VAD "
                    "(reference examples/vad-speech-segments)")
    a = p.add_argument
    a("-f", "--file", required=True, help="input audio file path")
    a("-vm", "--vad-model", required=True, help="VAD model path (ggml)")
    a("-vt", "--vad-threshold", type=float, default=0.5)
    a("-vspd", "--vad-min-speech-duration-ms", type=int, default=250)
    a("-vsd", "--vad-min-silence-duration-ms", type=int, default=100)
    a("-vmsd", "--vad-max-speech-duration-s", type=float, default=float("inf"))
    a("-vp", "--vad-speech-pad-ms", type=int, default=30)
    a("-vo", "--vad-samples-overlap", type=float, default=0.1)
    a("-np", "--no-prints", action="store_true",
      help="print nothing but the results")
    a("-ng", "--no-gpu", action="store_true", help="run the model on the CPU")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from whisper_tpu_torch.audio.io import read_audio_data
    from whisper_tpu_torch.models import vad as vad_mod

    try:
        samples, _ = read_audio_data(args.file)
    except Exception as e:
        print(f"error: failed to read audio data from {args.file}: {e}",
              file=sys.stderr)
        return 2

    try:
        vctx = vad_mod.VadContext.init_from_file_with_params(
            args.vad_model, vad_mod.VadContextParams(use_gpu=not args.no_gpu))
    except Exception as e:
        print(f"error: failed to load VAD model: {e}", file=sys.stderr)
        return 1

    params = VadParams(
        threshold=args.vad_threshold,
        min_speech_duration_ms=args.vad_min_speech_duration_ms,
        min_silence_duration_ms=args.vad_min_silence_duration_ms,
        max_speech_duration_s=args.vad_max_speech_duration_s,
        speech_pad_ms=args.vad_speech_pad_ms,
        samples_overlap=args.vad_samples_overlap,
    )
    segments = vctx.segments_from_samples(params, samples)

    # output format: speech.cpp:132-139 (times in seconds, 2 decimals)
    print()
    print(f"Detected {len(segments)} speech segments:")
    for i, seg in enumerate(segments):
        print(f"Speech segment {i}: start = {seg.start / 100.0:.2f}, "
              f"end = {seg.end / 100.0:.2f}")
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
