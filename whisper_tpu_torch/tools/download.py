"""Model download helper.

Counterpart of the JAX package's tools/download.py (reference
models/download-ggml-model.sh :36-65): fetches ggml checkpoints from the
ggerganov/whisper.cpp HuggingFace mirror. It validates names, prints the
URLs (--list, --url-only) and downloads where the network allows. The
checkpoints are the port's as they are: it reads the same .bin files.
"""

from __future__ import annotations

import argparse
import os
import sys
import urllib.request

HOST = "https://huggingface.co/ggerganov/whisper.cpp/resolve/main"
VAD_HOST = "https://huggingface.co/ggml-org/whisper-vad/resolve/main"

# reference download-ggml-model.sh:36-65
MODELS = [
    "tiny", "tiny.en", "tiny-q5_1", "tiny.en-q5_1", "tiny-q8_0",
    "base", "base.en", "base-q5_1", "base.en-q5_1", "base-q8_0",
    "small", "small.en", "small.en-tdrz", "small-q5_1", "small.en-q5_1",
    "small-q8_0",
    "medium", "medium.en", "medium-q5_0", "medium.en-q5_0", "medium-q8_0",
    "large-v1", "large-v2", "large-v2-q5_0", "large-v2-q8_0",
    "large-v3", "large-v3-q5_0",
    "large-v3-turbo", "large-v3-turbo-q5_0", "large-v3-turbo-q8_0",
]
VAD_MODELS = ["silero-v5.1.2"]


def model_url(name: str) -> str:
    if name in VAD_MODELS:
        return f"{VAD_HOST}/ggml-{name}.bin"
    if name not in MODELS:
        raise ValueError(
            f"invalid model '{name}'; available: {', '.join(MODELS + VAD_MODELS)}")
    return f"{HOST}/ggml-{name}.bin"


def download(name: str, dest_dir: str = "models", quiet: bool = False) -> str:
    url = model_url(name)
    os.makedirs(dest_dir, exist_ok=True)
    dest = os.path.join(dest_dir, f"ggml-{name}.bin")
    if os.path.exists(dest):
        if not quiet:
            print(f"{dest} already exists")
        return dest
    if not quiet:
        print(f"downloading {url} -> {dest}")
    # download to a temp name + atomic rename: an interrupted transfer
    # must not leave a truncated file the exists-check would trust
    tmp = dest + ".part"
    try:
        urllib.request.urlretrieve(url, tmp)  # noqa: S310
        os.replace(tmp, dest)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    return dest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="whisper-tpu-download")
    ap.add_argument("model", nargs="?", help="model name (e.g. tiny, large-v3-q5_0)")
    ap.add_argument("dest", nargs="?", default="models")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--url-only", action="store_true")
    args = ap.parse_args(argv)

    if args.list or not args.model:
        print("available models:")
        for m in MODELS + VAD_MODELS:
            print(f"  {m}")
        return 0
    try:
        if args.url_only:
            print(model_url(args.model))
            return 0
        download(args.model, args.dest)
        return 0
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except Exception as e:
        print(f"error: download failed: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
