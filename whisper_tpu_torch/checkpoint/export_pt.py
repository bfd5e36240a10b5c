"""ggml .bin -> torch state dict exporter (the reverse of convert_hf).

Counterpart of the JAX package's checkpoint/export_pt.py and of the
reference's `models/ggml_to_pt.py`: parse a ggml checkpoint, dequantize
every tensor to float32 and emit a torch state dict in HuggingFace
`WhisperForConditionalGeneration` naming (the inverse of
checkpoint/convert_hf.py's maps), so the result loads with
`model.load_state_dict(sd, strict=False)` (HF's tied `proj_out.weight` is
derived from `embed_tokens`).

Usage:
  python -m whisper_tpu_torch.checkpoint.export_pt ggml-tiny.bin out-dir/
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Tuple

import numpy as np

from whisper_tpu_torch.checkpoint import ggml_io
from whisper_tpu_torch.checkpoint.convert_hf import _LAYER_PART, _TOP_MAP
from whisper_tpu_torch.config import WhisperHParams

_TOP_INV = {v: k for k, v in _TOP_MAP.items()}
_PART_INV = {v: k for k, v in _LAYER_PART.items()}


def _hf_name(ggml_name: str):
    if ggml_name in _TOP_INV:
        return _TOP_INV[ggml_name]
    parts = ggml_name.split(".")
    # {encoder|decoder}.blocks.N.<part>.{weight|bias}
    if len(parts) >= 5 and parts[1] == "blocks":
        mapped = _PART_INV.get(".".join(parts[3:-1]))
        if mapped is None:
            return None
        return f"model.{parts[0]}.layers.{parts[2]}.{mapped}.{parts[-1]}"
    return None


def export_hf_state_dict(path_or_ckpt) -> Tuple[Dict[str, np.ndarray], WhisperHParams]:
    """ggml checkpoint -> {HF tensor name: float32 ndarray}, hparams."""
    ckpt = (path_or_ckpt if isinstance(path_or_ckpt, ggml_io.GgmlCheckpoint)
            else ggml_io.read_ggml(path_or_ckpt))
    sd: Dict[str, np.ndarray] = {}
    skipped = []
    for name, rt in ckpt.tensors.items():
        hf = _hf_name(name)
        if hf is None:
            skipped.append(name)
            continue
        arr = rt.to_float32().reshape(rt.shape)
        if name in ("encoder.conv1.bias", "encoder.conv2.bias"):
            # stored [n, 1] in the ggml format (convert-pt-to-ggml.py:299-301);
            # torch wants the plain [n] bias back (reference ggml_to_pt.py)
            arr = arr.reshape(-1)
        sd[hf] = arr
    if skipped:
        print(f"note: {len(skipped)} unmapped tensors skipped: "
              f"{skipped[:4]}...", file=sys.stderr)
    return sd, ckpt.hparams


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    if len(args) < 2:
        print("usage: export_pt model.bin dir-output", file=sys.stderr)
        return 1
    import torch

    sd_np, hp = export_hf_state_dict(args[0])
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd_np.items()}
    os.makedirs(args[1], exist_ok=True)
    out = os.path.join(args[1], "torch-model.pt")
    torch.save({"state_dict": sd, "dims": hp.__dict__}, out)
    print(f"wrote {out} ({len(sd)} tensors)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
