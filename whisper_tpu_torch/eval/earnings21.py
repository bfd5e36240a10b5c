"""Earnings-21 WER evaluation runner.

Counterpart of whisper_tpu/eval/earnings21.py. reference
tests/earnings21/{eval.mk,eval.py}: transcribe each media file, compare
against the speech-datasets `.nlp` references (first pipe-separated field
of every line after the header is a reference token, eval.py:17-27),
normalize with the English normalizer, print corpus WER.

Usage:
  python -m whisper_tpu_torch.eval.earnings21 -m ggml-tiny.bin \
      -d speech-datasets/earnings21 [--metadata metadata.csv]

The model runs on the first CUDA device; -ng runs it on the CPU.
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


def load_nlp_reference(path: str) -> str:
    """One `.nlp` file -> reference transcript (eval.py:19-26)."""
    buf: List[str] = []
    with open(path, encoding="utf-8", errors="ignore") as fp:
        fp.readline()                       # header
        for line in fp:
            token = line.split("|", maxsplit=1)[0]
            if token:
                buf.append(token)
    return " ".join(buf)


def load_references(root: str) -> Dict[str, str]:
    refs: Dict[str, str] = {}
    pat = os.path.join(root, "transcripts", "nlp_references", "*.nlp")
    for path in glob.glob(pat):
        code = os.path.basename(path)[: -len(".nlp")]
        refs[code] = load_nlp_reference(path)
    return refs


def load_codes(metadata_csv: str) -> List[str]:
    """File codes from the dataset metadata CSV (eval.py:38-44)."""
    codes = []
    with open(metadata_csv) as fp:
        fp.readline()
        for line in fp:
            codes.append(line.split(",")[0])
    return sorted(codes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="whisper-tpu-torch-earnings21-eval")
    add_eval_args(ap)
    ap.add_argument("-d", "--dataset", required=True,
                    help="speech-datasets/earnings21 root")
    ap.add_argument("--metadata", default=None,
                    help="metadata CSV restricting the file set")
    args = ap.parse_args(argv)

    from whisper_tpu_torch.audio.io import read_audio_data

    refs = load_references(args.dataset)
    codes = (load_codes(args.metadata) if args.metadata
             else sorted(refs.keys()))
    if args.max_files:
        codes = codes[: args.max_files]

    media_dir = os.path.join(args.dataset, "media")
    ctx, p = build_eval_context(args)

    hyps, used_refs = [], []
    for i, code in enumerate(codes):
        if code not in refs:
            continue
        paths = glob.glob(os.path.join(media_dir, code + ".*"))
        media = [q for q in paths if not q.endswith(".txt")]
        if not media:
            print(f"skipping {code} (no media)", file=sys.stderr)
            continue
        try:
            samples, _ = read_audio_data(media[0])
        except (FileNotFoundError, OSError, ValueError,
                subprocess.CalledProcessError):
            print(f"skipping {media[0]} (no ffmpeg)", file=sys.stderr)
            continue
        st = ctx.create_state()
        st.full(p, samples)
        text = st.full_get_all_text()
        hyps.append(text)
        used_refs.append(refs[code])
        print(f"[{i + 1}/{len(codes)}] {code}: {text[:60]!r}", file=sys.stderr)

    if not hyps:
        print("no files evaluated", file=sys.stderr)
        return 1
    score = wer(used_refs, hyps, normalize=True)
    print(f"WER: {score * 100:.2f}%  ({len(hyps)} files)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
