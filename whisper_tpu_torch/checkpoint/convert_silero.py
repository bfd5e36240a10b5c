"""Silero-VAD torch -> ggml converter.

Counterpart of whisper_tpu/checkpoint/convert_silero.py, the mirror of
the reference `models/convert-silero-vad-to-ggml.py`: take the
`silero_vad` package's torch model (or a saved state dict / TorchScript
file), clean the keys (drop the 8 kHz branch, normalize the `_model.`
prefix, convert-silero-vad-to-ggml.py:13-20), collect the 11 tensors the
engine loads (encoder reparam convs, LSTM cell, final conv, STFT basis,
:82-108), and write them in the silero-16k ggml container that
models/vad.read_vad_ggml parses.

Usage:
  python -m whisper_tpu_torch.checkpoint.convert_silero --output ggml-vad.bin \
      [--state-dict silero.pt | --jit silero.jit]   # default: silero_vad pkg
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np
import torch

from whisper_tpu_torch.models.vad import VadHParams, VadModel, write_vad_ggml

TENSOR_KEYS = (
    ["_model.encoder.%d.reparam_conv.weight" % i for i in range(4)]
    + ["_model.encoder.%d.reparam_conv.bias" % i for i in range(4)]
    + ["_model.decoder.rnn.weight_ih", "_model.decoder.rnn.weight_hh",
       "_model.decoder.rnn.bias_ih", "_model.decoder.rnn.bias_hh",
       "_model.decoder.decoder.2.weight", "_model.decoder.decoder.2.bias",
       "_model.stft.forward_basis_buffer"]
)


def clean_state_dict(state_dict) -> Dict[str, np.ndarray]:
    """Key cleanup (convert-silero-vad-to-ggml.py:12-20): drop `_8k`
    tensors, ensure the `_model.` prefix, torch -> numpy float32."""
    cleaned: Dict[str, np.ndarray] = {}
    for key, value in state_dict.items():
        if "_8k" in key:
            continue
        if not key.startswith("_model."):
            key = "_model." + key
        arr = value.detach().cpu().numpy() if hasattr(value, "detach") else value
        cleaned[key] = np.asarray(arr, np.float32)
    return cleaned


def convert_silero_state_dict(state_dict, version: str = "5.0.0") -> VadModel:
    """torch state dict -> VadModel (validated shapes, converter layout)."""
    cleaned = clean_state_dict(state_dict)
    hp = VadHParams()
    params: Dict[str, np.ndarray] = {}
    missing = []
    for key in TENSOR_KEYS:
        if key not in cleaned:
            missing.append(key)
            continue
        arr = cleaned[key]
        if key == "_model.stft.forward_basis_buffer":
            # keep 3-D (258, 1, 256) — the engine reads it as a conv basis
            arr = arr.reshape(2 * (hp.encoder_in_channels[0]), 1, -1)
        elif key == "_model.decoder.decoder.2.weight":
            arr = arr.reshape(hp.final_conv_out, hp.final_conv_in, 1)
        elif "reparam_conv.weight" not in key and "rnn.weight" not in key:
            arr = arr.squeeze()
        params[key] = np.ascontiguousarray(arr, np.float32)
    if missing:
        raise ValueError(f"state dict is missing VAD tensors: {missing}")

    # shape validation against the fixed silero-16k architecture
    for i in range(hp.n_encoder_layers):
        w = params[f"_model.encoder.{i}.reparam_conv.weight"]
        want = (hp.encoder_out_channels[i], hp.encoder_in_channels[i],
                hp.kernel_sizes[i])
        if tuple(w.shape) != want:
            raise ValueError(f"encoder.{i} weight shape {w.shape} != {want}")
    H = hp.lstm_hidden_size
    if params["_model.decoder.rnn.weight_ih"].shape != (4 * H, H):
        raise ValueError("bad LSTM weight_ih shape")
    return VadModel(hp, params, version=version)


def load_torch_model(state_dict_path=None, jit_path=None):
    if jit_path:
        return torch.jit.load(jit_path, map_location="cpu").state_dict()
    if state_dict_path:
        obj = torch.load(state_dict_path, map_location="cpu",
                         weights_only=False)
        return obj.state_dict() if hasattr(obj, "state_dict") else obj
    from silero_vad import load_silero_vad   # an optional package
    return load_silero_vad().state_dict()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="convert-silero-vad-to-ggml")
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--state-dict", default=None, help="torch .pt state dict")
    p.add_argument("--jit", default=None, help="TorchScript model file")
    p.add_argument("--version", default="5.0.0")
    args = p.parse_args(argv)

    try:
        sd = load_torch_model(args.state_dict, args.jit)
    except ImportError as e:
        print(f"error: {e} (pass --state-dict or --jit)", file=sys.stderr)
        return 1
    model = convert_silero_state_dict(sd, version=args.version)
    write_vad_ggml(args.output, model)
    print(f"wrote {args.output} ({len(model.params)} tensors)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
