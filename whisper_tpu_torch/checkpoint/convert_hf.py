"""HuggingFace transformers Whisper -> ggml .bin converter.

Counterpart of the JAX package's checkpoint/convert_hf.py and of the
reference's model conversion scripts (models/convert-pt-to-ggml.py — writer
format at :268-334 — and convert-h5-to-ggml.py, which maps exactly these HF
tensor names). The result is a checkpoint the port's loader (and
whisper.cpp itself) reads. `transformers` is imported only inside the
functions that need it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from whisper_tpu_torch.audio.mel import mel_filterbank
from whisper_tpu_torch.checkpoint import ggml_io, quant
from whisper_tpu_torch.config import WhisperHParams

# HF name -> ggml name (reference convert-h5-to-ggml.py conv_map);
# checkpoint/export_pt.py inverts both maps
_TOP_MAP = {
    "model.encoder.conv1.weight": "encoder.conv1.weight",
    "model.encoder.conv1.bias": "encoder.conv1.bias",
    "model.encoder.conv2.weight": "encoder.conv2.weight",
    "model.encoder.conv2.bias": "encoder.conv2.bias",
    "model.encoder.embed_positions.weight": "encoder.positional_embedding",
    "model.encoder.layer_norm.weight": "encoder.ln_post.weight",
    "model.encoder.layer_norm.bias": "encoder.ln_post.bias",
    "model.decoder.embed_tokens.weight": "decoder.token_embedding.weight",
    "model.decoder.embed_positions.weight": "decoder.positional_embedding",
    "model.decoder.layer_norm.weight": "decoder.ln.weight",
    "model.decoder.layer_norm.bias": "decoder.ln.bias",
}

_LAYER_PART = {
    "self_attn.q_proj": "attn.query",
    "self_attn.k_proj": "attn.key",
    "self_attn.v_proj": "attn.value",
    "self_attn.out_proj": "attn.out",
    "self_attn_layer_norm": "attn_ln",
    "encoder_attn.q_proj": "cross_attn.query",
    "encoder_attn.k_proj": "cross_attn.key",
    "encoder_attn.v_proj": "cross_attn.value",
    "encoder_attn.out_proj": "cross_attn.out",
    "encoder_attn_layer_norm": "cross_attn_ln",
    "fc1": "mlp.0",
    "fc2": "mlp.2",
    "final_layer_norm": "mlp_ln",
}


def _map_name(hf_name: str) -> Optional[str]:
    if hf_name in _TOP_MAP:
        return _TOP_MAP[hf_name]
    parts = hf_name.split(".")
    # model.{encoder|decoder}.layers.N.<part>.{weight|bias}
    if len(parts) >= 6 and parts[0] == "model" and parts[2] == "layers":
        mapped = _LAYER_PART.get(".".join(parts[4:-1]))
        if mapped is None:
            return None
        return f"{parts[1]}.blocks.{parts[3]}.{mapped}.{parts[-1]}"
    return None


def hparams_from_hf_config(cfg) -> WhisperHParams:
    return WhisperHParams(
        n_vocab=cfg.vocab_size,
        n_audio_ctx=cfg.max_source_positions,
        n_audio_state=cfg.d_model,
        n_audio_head=cfg.encoder_attention_heads,
        n_audio_layer=cfg.encoder_layers,
        n_text_ctx=cfg.max_target_positions,
        n_text_state=cfg.d_model,
        n_text_head=cfg.decoder_attention_heads,
        n_text_layer=cfg.decoder_layers,
        n_mels=cfg.num_mel_bins,
        ftype=1,
    )


def convert_hf_to_ggml(
    model,
    out_path: str,
    ftype: int = quant.GGML_TYPE_F16,
    vocab_tokens=None,
) -> WhisperHParams:
    """Convert a transformers WhisperForConditionalGeneration (instance or
    pretrained path) to a ggml .bin the loader reads.

    Like the reference converter: 1-D tensors and convolution biases stay
    f32; conv weights f16; 2-D matmul weights take `ftype`
    (convert-pt-to-ggml.py:290-310)."""
    if isinstance(model, str):
        from transformers import WhisperForConditionalGeneration
        model = WhisperForConditionalGeneration.from_pretrained(model)

    hp = hparams_from_hf_config(model.config)
    hp = WhisperHParams(**{**hp.__dict__, "ftype": quant.TYPE_TO_FTYPE.get(ftype, 1)})

    tensors: Dict[str, Tuple[np.ndarray, int]] = {}
    for hf_name, tensor in model.state_dict().items():
        name = _map_name(hf_name)
        if name is None:
            continue
        arr = tensor.detach().cpu().float().numpy()
        if name in ("encoder.conv1.bias", "encoder.conv2.bias"):
            # the reference stores conv biases as [n, 1] (ggml ne=[1,n]) AND
            # as f32; whisper.cpp's loader shape/type-checks reject plain
            # [n] or f16 (convert-pt-to-ggml.py:299-313)
            tensors[name] = (arr.reshape(arr.shape[0], 1), quant.GGML_TYPE_F32)
            continue
        if arr.ndim == 1:
            ttype = quant.GGML_TYPE_F32
        elif name.endswith("conv1.weight") or name.endswith("conv2.weight"):
            ttype = quant.GGML_TYPE_F16
        elif "positional_embedding" in name:
            ttype = quant.GGML_TYPE_F32
        elif (arr.ndim == 2 and min(arr.shape) >= 32
              and arr.shape[-1] % quant.block_size(ftype) == 0):
            # rows must divide the codec's block (32 legacy, 256 K-quants:
            # super-blocks may not straddle rows; the reference loader
            # asserts ne[0] % blck_size, as tools/quantize.py does)
            ttype = ftype
        else:
            ttype = quant.GGML_TYPE_F16
        tensors[name] = (arr, ttype)

    if vocab_tokens is None:
        vocab_tokens = _vocab_from_hf(model, hp.n_vocab)

    ggml_io.write_ggml(out_path, hp, mel_filterbank(hp.n_mels), vocab_tokens, tensors)
    return hp


def _vocab_from_hf(model, n_vocab: int):
    """The byte-level vocab of a tokenizer attached to the model as
    `_whisper_tpu_tokenizer`, else the synthetic vocab (tests use random
    models with no tokenizer)."""
    tok = getattr(model, "_whisper_tpu_tokenizer", None)
    if tok is not None:
        byte_decoder = {v: k for k, v in tok.byte_encoder.items()}
        return [bytes(byte_decoder.get(c, ord(c)) for c in tok.convert_ids_to_tokens(i))
                for i in range(min(n_vocab, tok.vocab_size))]
    from whisper_tpu_torch.tokenizer import synthetic_vocab
    return synthetic_vocab(n_vocab).id_to_token[:50256]
