"""ggml checkpoint -> the port's parameter tree of torch tensors.

Counterpart of whisper_tpu/checkpoint/loader.py. The reference streams
tensors into per-backend ggml buffers keyed by exact tensor names
(src/whisper.cpp:1729-1965). The port's layout is PyTorch's own:

- per-layer weights stay per layer: `params[part]["blocks"]` is a list of
  dicts, one per layer, in place of the JAX package's stacked scan axis;
- linear weights keep ggml's native [out, in] order, which is what
  `torch.nn.functional.linear` takes, so no transpose is needed;
- conv weights keep ggml's (out, in, k) order, which is `conv1d`'s;
- matmul weights and embeddings are in the compute dtype (bfloat16 by
  default); LayerNorm parameters and biases stay float32;
- with keep_quantized, a linear weight in a block format stays int8 blocks
  for the quant_matmul kernels, in the JAX package's layout and NOT [out,
  in]: {"q": (in, out) int8, "d": (in//bs, out) float32 block scales} plus
  "m" (in//bs, out) float32 block offsets for the offset formats (see
  ops/quant_matmul.py). Token embedding, convolutions and LayerNorms stay
  dense.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from whisper_tpu_torch.checkpoint import ggml_io, quant
from whisper_tpu_torch.config import WhisperHParams
from whisper_tpu_torch.ops.quant_matmul import repack_blocks
from whisper_tpu_torch.tokenizer import WhisperVocab

Params = Dict[str, Any]

# leaves held in the compute dtype; every other leaf stays float32
COMPUTE_KEYS = ("w", "pos_embed", "token_embed")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(dtype) -> torch.dtype:
    """"bfloat16" / "float32" (ContextParams.dtype) or a torch.dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported compute dtype {dtype!r}") from None


@dataclasses.dataclass
class LoadedModel:
    hparams: WhisperHParams
    params: Params                 # tree of torch tensors (see module doc)
    mel_filters: np.ndarray        # (n_mel, n_fft_bins) float32
    vocab: WhisperVocab
    n_loaded: int                  # tensors loaded; 0 = stub model (tests)


def place_params(tree, dtype, device) -> Any:
    """Move a parameter tree to `device`: int8 leaves (quantized weight
    blocks) stay int8, COMPUTE_KEYS leaves take `dtype`, the rest float32.
    Numpy leaves are converted; a tensor already in place is returned as
    is."""
    dtype = torch_dtype(dtype)
    if isinstance(tree, dict):
        return {k: (_leaf(v, dtype if k in COMPUTE_KEYS else torch.float32, device)
                    if not isinstance(v, (dict, list)) else
                    place_params(v, dtype, device))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [place_params(v, dtype, device) for v in tree]
    return tree


def _leaf(x, dtype, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        if x.dtype == np.int8:
            x = torch.from_numpy(np.ascontiguousarray(x))
        else:
            # a copy, via float32: numpy has no bfloat16 without ml_dtypes
            x = torch.tensor(np.asarray(x, dtype=np.float32))
    if x.dtype == torch.int8:
        return x.to(device=device)
    return x.to(device=device, dtype=dtype)


def _get(t: Dict[str, ggml_io.RawTensor], name: str) -> Optional[np.ndarray]:
    rt = t.get(name)
    return None if rt is None else rt.to_float32()


# block formats that can stay quantized on the device (int8 + per-block
# scale, plus a per-block offset for the asymmetric codecs)
_KEEPQ_TYPES = (quant.GGML_TYPE_Q4_0, quant.GGML_TYPE_Q4_1,
                quant.GGML_TYPE_Q5_0, quant.GGML_TYPE_Q5_1,
                quant.GGML_TYPE_Q8_0) + quant.K_QUANT_TYPES
# the formats with a per-block offset: decided by FORMAT, never by the
# values, so every layer of a model has the same leaves
OFFSET_TYPES = (quant.GGML_TYPE_Q4_1, quant.GGML_TYPE_Q5_1, quant.GGML_TYPE_Q2_K,
                quant.GGML_TYPE_Q4_K, quant.GGML_TYPE_Q5_K)


def quantized_leaves(raw, ttype: int, n_out: int, n_in: int) -> Dict[str, np.ndarray]:
    """int8 blocks of an [out, in] weight held as ggml bytes in block format
    `ttype`, in quant_matmul's layout: "q", "d" and, for OFFSET_TYPES, "m";
    their qblock is quant.int8_block_size(ttype)."""
    q, d, m = quant.dequantize_to_int8_blocks(raw, ttype, n_out * n_in)
    return dict(zip("qdm", repack_blocks(q, d, n_out, n_in,
                                         m if ttype in OFFSET_TYPES else None,
                                         qblock=quant.int8_block_size(ttype))))


def _linear(t, prefix: str, has_bias: bool = True,
            keep_quantized: bool = False) -> Optional[Dict[str, np.ndarray]]:
    rt = t.get(prefix + ".weight")
    if rt is None:
        return None
    if (keep_quantized and rt.ttype in _KEEPQ_TYPES and len(rt.ne) == 2
            and rt.ne[0] % quant.block_size(rt.ttype) == 0):
        out = quantized_leaves(rt.data, rt.ttype, *rt.shape)   # shape [out, in]
    else:
        out = {"w": rt.to_float32()}       # numpy row-major [out, in]
    if has_bias:
        b = _get(t, prefix + ".bias")
        out["b"] = b if b is not None else np.zeros(rt.shape[0], np.float32)
    return out


def _ln(t, prefix: str) -> Optional[Dict[str, np.ndarray]]:
    w = _get(t, prefix + ".weight")
    if w is None:
        return None
    return {"scale": w, "bias": _get(t, prefix + ".bias")}


def _blocks(t, part: str, n_layer: int, names,
            keep_quantized: bool = False) -> List[Dict[str, Any]]:
    out = []
    for il in range(n_layer):
        p = f"{part}.blocks.{il}"
        blk = {}
        for key, name, kind in names:
            blk[key] = (_ln(t, f"{p}.{name}") if kind == "ln"
                        else _linear(t, f"{p}.{name}", has_bias=kind == "linear",
                                     keep_quantized=keep_quantized))
        if any(v is None for v in blk.values()):
            return []
        out.append(blk)
    return out


# (pytree key, checkpoint name, kind); kind "linear_nobias" = key projection
_ENC_NAMES = (
    ("attn_ln", "attn_ln", "ln"),
    ("attn_q", "attn.query", "linear"),
    ("attn_k", "attn.key", "linear_nobias"),
    ("attn_v", "attn.value", "linear"),
    ("attn_out", "attn.out", "linear"),
    ("mlp_ln", "mlp_ln", "ln"),
    ("mlp_0", "mlp.0", "linear"),
    ("mlp_2", "mlp.2", "linear"),
)
_DEC_NAMES = _ENC_NAMES[:5] + (
    ("cross_ln", "cross_attn_ln", "ln"),
    ("cross_q", "cross_attn.query", "linear"),
    ("cross_k", "cross_attn.key", "linear_nobias"),
    ("cross_v", "cross_attn.value", "linear"),
    ("cross_out", "cross_attn.out", "linear"),
) + _ENC_NAMES[5:]


def params_from_checkpoint(
    ckpt: ggml_io.GgmlCheckpoint,
    compute_dtype: str = "bfloat16",
    keep_quantized: bool = False,
    device="cpu",
) -> LoadedModel:
    hp = ckpt.hparams
    t = ckpt.tensors

    enc_blocks = _blocks(t, "encoder", hp.n_audio_layer, _ENC_NAMES, keep_quantized)
    dec_blocks = _blocks(t, "decoder", hp.n_text_layer, _DEC_NAMES, keep_quantized)
    conv1_w = _get(t, "encoder.conv1.weight")  # (d, n_mels, 3) = conv1d's layout
    conv2_w = _get(t, "encoder.conv2.weight")

    params: Params = {}
    if conv1_w is not None and enc_blocks and dec_blocks:
        params = {
            "encoder": {
                "pos_embed": _get(t, "encoder.positional_embedding"),
                # conv biases are stored [n, 1] in the reference format
                # (convert-pt-to-ggml.py:299-301) — flatten either layout
                "conv1": {"w": conv1_w,
                          "b": _get(t, "encoder.conv1.bias").reshape(-1)},
                "conv2": {"w": conv2_w,
                          "b": _get(t, "encoder.conv2.bias").reshape(-1)},
                "ln_post": _ln(t, "encoder.ln_post"),
                "blocks": enc_blocks,
            },
            "decoder": {
                "pos_embed": _get(t, "decoder.positional_embedding"),
                "token_embed": _get(t, "decoder.token_embedding.weight"),
                "ln": _ln(t, "decoder.ln"),
                "blocks": dec_blocks,
            },
        }
        params = place_params(params, compute_dtype, device)

    return LoadedModel(
        hparams=hp,
        params=params,
        mel_filters=ckpt.mel_filters,
        vocab=WhisperVocab(hp.n_vocab, ckpt.vocab_tokens),
        n_loaded=len(ckpt.tensors),
    )


def load_model(path: str, compute_dtype: str = "bfloat16",
               keep_quantized: bool = False, device="cpu") -> LoadedModel:
    """One-call load: parse .bin + build the tensor tree (reference call
    stack whisper_init_from_file_with_params -> whisper_model_load,
    src/whisper.cpp:3640-3721 + 1503)."""
    return params_from_checkpoint(ggml_io.read_ggml(path), compute_dtype,
                                  keep_quantized, device)
