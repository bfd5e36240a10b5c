"""Shared WER-runner setup (librispeech.py / earnings21.py).

Counterpart of whisper_tpu/eval/common.py. Both harnesses build the same
context and decode params from the same CLI surface; one helper keeps them
from drifting. The model runs on the first CUDA device; `-ng` /
`--no-gpu` (whisper-cli's flag) runs it on the CPU. Without that flag and
with no CUDA device, building the context raises InitError.
"""

from __future__ import annotations

import argparse
import sys
from typing import Tuple


def add_eval_args(ap: argparse.ArgumentParser) -> None:
    """The flags both runners share."""
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-bs", "--beam-size", type=int, default=-1)
    ap.add_argument("--draft-model", default=None,
                    help="speculative-decoding draft checkpoint (greedy runs)")
    ap.add_argument("-n", "--max-files", type=int, default=0)
    ap.add_argument("-ng", "--no-gpu", action="store_true",
                    help="run the model on the CPU")


def build_eval_context(args) -> Tuple[object, object]:
    """(WhisperContext, FullParams) from the shared eval CLI args
    (--model / --beam-size / --draft-model / --no-gpu)."""
    from whisper_tpu_torch.api import WhisperContext
    from whisper_tpu_torch.config import ContextParams, FullParams, SamplingStrategy

    if args.draft_model and args.beam_size > 1:
        print("warning: --draft-model ignored (speculative decoding "
              "is greedy-only)", file=sys.stderr)
        args.draft_model = None
    cp = ContextParams(use_gpu=not args.no_gpu, draft_model=args.draft_model)
    ctx = WhisperContext.new_with_params(args.model, cp)
    p = FullParams.default(SamplingStrategy.BEAM_SEARCH if args.beam_size > 1
                           else SamplingStrategy.GREEDY)
    if args.beam_size > 1:
        p.beam_search.beam_size = args.beam_size
    p.print_progress = False
    return ctx, p
