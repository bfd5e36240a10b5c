"""Carry the JAX package's parameters across into the port's layout.

The JAX package (whisper_tpu) keeps its weights as a pytree whose
per-layer leaves are stacked along a leading layer axis (for lax.scan),
linear weights as [in, out] and conv weights as "WIO" (k, in, out). The
port keeps a list of per-layer dicts, linear weights as [out, in] and conv
weights as (out, in, k) — see checkpoint/loader.py. Quantized linear
leaves (keep_quantized: "q" int8, "d" and "m" float32) keep the JAX
layout in both packages and cross as they are, q still int8. This module
takes that
pytree with numpy leaves (`jax.tree_util.tree_map(np.asarray, params)`)
and needs no JAX itself; the tests use it to feed both packages the same
weights.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from whisper_tpu_torch.checkpoint.loader import Params, place_params
from whisper_tpu_torch.config import WhisperHParams


def _f32(a) -> np.ndarray:
    # bfloat16 leaves (ml_dtypes) widen exactly to float32
    return np.asarray(a, dtype=np.float32)


def _layer_leaf(key: str, a) -> np.ndarray:
    if key == "w":
        return _f32(a).T                   # [in, out] -> [out, in]
    if key == "q":
        return np.asarray(a, dtype=np.int8)
    return _f32(a)


def _unstack(stacked: Dict[str, Any], n_layer: int):
    """{name: {leaf: (L, ...)}} -> [ {name: {leaf: (...)}} ] * L, with
    dense linear weights turned from [in, out] to [out, in]."""
    return [{name: {k: _layer_leaf(k, v[i]) for k, v in leaves.items()}
             for name, leaves in stacked.items()}
            for i in range(n_layer)]


def _conv(p) -> Dict[str, np.ndarray]:
    return {"w": _f32(p["w"]).transpose(2, 1, 0),      # WIO -> (out, in, k)
            "b": _f32(p["b"])}


def params_from_jax(params_np: Params, hp: WhisperHParams,
                    dtype="float32", device="cpu") -> Params:
    """The JAX package's parameter pytree (numpy leaves) -> the port's
    tensor tree, in `dtype` on `device`."""
    enc, dec = params_np["encoder"], params_np["decoder"]
    tree = {
        "encoder": {
            "pos_embed": _f32(enc["pos_embed"]),
            "conv1": _conv(enc["conv1"]),
            "conv2": _conv(enc["conv2"]),
            "ln_post": {k: _f32(v) for k, v in enc["ln_post"].items()},
            "blocks": _unstack(enc["blocks"], hp.n_audio_layer),
        },
        "decoder": {
            "pos_embed": _f32(dec["pos_embed"]),
            "token_embed": _f32(dec["token_embed"]),
            "ln": {k: _f32(v) for k, v in dec["ln"].items()},
            "blocks": _unstack(dec["blocks"], hp.n_text_layer),
        },
    }
    return place_params(tree, dtype, device)
