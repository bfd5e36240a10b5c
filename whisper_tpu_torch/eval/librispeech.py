"""LibriSpeech WER evaluation runner.

Counterpart of whisper_tpu/eval/librispeech.py. reference
tests/librispeech/{eval.mk,eval.py}: transcribe every utterance under a
LibriSpeech-layout directory, compare against the *.trans.txt references
with the English normalizer, print corpus WER.

Usage:
  python -m whisper_tpu_torch.eval.librispeech -m ggml-tiny.bin -d LibriSpeech/test-clean

The model runs on the first CUDA device; -ng runs it on the CPU.

Audio: LibriSpeech ships .flac; .wav siblings are preferred when present,
otherwise flac decodes through read_audio_data's ffmpeg path (the
reference's eval.mk shells out to convert too).
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys
from typing import Dict, List

from whisper_tpu_torch.eval.common import add_eval_args, build_eval_context
from whisper_tpu_torch.eval.wer import wer


def load_references(root: str) -> Dict[str, str]:
    refs: Dict[str, str] = {}
    for path in glob.glob(os.path.join(root, "**", "*.trans.txt"), recursive=True):
        with open(path) as fp:
            for line in fp:
                code, _, text = line.strip().partition(" ")
                refs[code] = text
    return refs


def find_audio(root: str) -> List[str]:
    out = glob.glob(os.path.join(root, "**", "*.wav"), recursive=True)
    out += glob.glob(os.path.join(root, "**", "*.flac"), recursive=True)
    return sorted(p for p in out if not p.endswith(".flac") or
                  not os.path.exists(p[:-5] + ".wav"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="whisper-tpu-torch-librispeech-eval")
    add_eval_args(ap)
    ap.add_argument("-d", "--dataset", required=True, help="LibriSpeech split dir")
    ap.add_argument("--hyp-dir", default=None,
                    help="write per-utterance hypothesis .txt next to audio")
    args = ap.parse_args(argv)

    from whisper_tpu_torch.audio.io import read_audio_data

    refs = load_references(args.dataset)
    files = find_audio(args.dataset)
    if args.max_files:
        files = files[: args.max_files]
    if not files:
        print("no audio found (convert .flac to .wav first)", file=sys.stderr)
        return 1

    ctx, p = build_eval_context(args)

    hyps, used_refs = [], []
    for i, path in enumerate(files):
        code = os.path.splitext(os.path.basename(path))[0]
        if code not in refs:
            continue
        try:
            samples, _ = read_audio_data(path)   # .flac decodes via ffmpeg
        except (FileNotFoundError, OSError, ValueError,
                subprocess.CalledProcessError):
            print(f"skipping {path} (unreadable/undecodable)", file=sys.stderr)
            continue
        st = ctx.create_state()
        st.full(p, samples)
        text = st.full_get_all_text()
        hyps.append(text)
        used_refs.append(refs[code])
        if args.hyp_dir:
            os.makedirs(args.hyp_dir, exist_ok=True)
            with open(os.path.join(args.hyp_dir, code + ".txt"), "w") as f:
                f.write(text)
        print(f"[{i + 1}/{len(files)}] {code}: {text[:60]!r}", file=sys.stderr)

    score = wer(used_refs, hyps, normalize=True)
    print(f"WER: {score * 100:.2f}%  ({len(hyps)} utterances)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
