"""Random parameter initialization for tests and benchmarks.

Counterpart of whisper_tpu/checkpoint/init.py. No real weights ship with
this repo, mirroring the reference's own CI which exercises the full
pipeline with stub models (sys/whisper.cpp/tests/CMakeLists.txt:18-91).

The draws are the JAX package's: the same numpy generator, the same
shapes, in the same order, so one seed gives the same weights in both
packages. Each draw is then laid out the port's way (linear [out, in],
conv (out, in, k)) and converted with torch, since numpy has no bfloat16
of its own. The JAX package rounds its float64 draws to bfloat16 in one
step, the port through float32; the two agree except where a value lies
within float32 rounding of a bfloat16 tie.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from whisper_tpu_torch.audio.mel import mel_filterbank
from whisper_tpu_torch.checkpoint.loader import LoadedModel, Params, torch_dtype
from whisper_tpu_torch.config import PRESET_HPARAMS, WhisperHParams
from whisper_tpu_torch.tokenizer import synthetic_vocab


def random_params(
    hp: WhisperHParams,
    seed: int = 0,
    compute_dtype: str = "bfloat16",
    device="cpu",
) -> Params:
    rng = np.random.default_rng(seed)
    d_a, d_t = hp.n_audio_state, hp.n_text_state
    cdt = torch_dtype(compute_dtype)

    def put(a: np.ndarray, dtype=cdt) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device=device, dtype=dtype)

    def normal(shape, scale) -> np.ndarray:
        return rng.standard_normal(shape) * scale

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=device)

    def linear(n_in, n_out, bias=True):
        # drawn [in, out] like the JAX package, stored [out, in]
        out = {"w": put(normal((n_in, n_out), n_in ** -0.5).T)}
        if bias:
            out["b"] = zeros(n_out)
        return out

    def ln(n):
        return {"scale": torch.ones(n, dtype=torch.float32, device=device),
                "bias": zeros(n)}

    def enc_block():
        return {
            "attn_ln": ln(d_a),
            "attn_q": linear(d_a, d_a),
            "attn_k": linear(d_a, d_a, bias=False),
            "attn_v": linear(d_a, d_a),
            "attn_out": linear(d_a, d_a),
            "mlp_ln": ln(d_a),
            "mlp_0": linear(d_a, 4 * d_a),
            "mlp_2": linear(4 * d_a, d_a),
        }

    def dec_block():
        return {
            "attn_ln": ln(d_t),
            "attn_q": linear(d_t, d_t),
            "attn_k": linear(d_t, d_t, bias=False),
            "attn_v": linear(d_t, d_t),
            "attn_out": linear(d_t, d_t),
            "cross_ln": ln(d_t),
            "cross_q": linear(d_t, d_t),
            "cross_k": linear(d_t, d_t, bias=False),
            "cross_v": linear(d_t, d_t),
            "cross_out": linear(d_t, d_t),
            "mlp_ln": ln(d_t),
            "mlp_0": linear(d_t, 4 * d_t),
            "mlp_2": linear(4 * d_t, d_t),
        }

    # conv weights drawn (k, in, out) like the JAX package's WIO, stored
    # (out, in, k) for conv1d
    encoder = {
        "pos_embed": put(sinusoid_position_embedding(hp.n_audio_ctx, d_a)),
        "conv1": {"w": put(normal((3, hp.n_mels, d_a), hp.n_mels ** -0.5)
                           .transpose(2, 1, 0)),
                  "b": zeros(d_a)},
        "conv2": {"w": put(normal((3, d_a, d_a), d_a ** -0.5).transpose(2, 1, 0)),
                  "b": zeros(d_a)},
        "ln_post": ln(d_a),
        "blocks": [enc_block() for _ in range(hp.n_audio_layer)],
    }
    decoder = {
        "pos_embed": put(normal((hp.n_text_ctx, d_t), 0.01)),
        "token_embed": put(normal((hp.n_vocab, d_t), d_t ** -0.5)),
        "ln": ln(d_t),
        "blocks": [dec_block() for _ in range(hp.n_text_layer)],
    }
    return {"encoder": encoder, "decoder": decoder}


def sinusoid_position_embedding(length: int, channels: int) -> np.ndarray:
    """OpenAI Whisper's encoder sinusoids (checkpoint tensor
    encoder.positional_embedding is exactly this)."""
    assert channels % 2 == 0
    log_timescale_increment = np.log(10000) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(np.float32)


def random_model(
    preset: str = "tiny",
    seed: int = 0,
    compute_dtype: str = "bfloat16",
    hp: Optional[WhisperHParams] = None,
    device="cpu",
) -> LoadedModel:
    """Random-weight LoadedModel for tests/benches (stub-model analogue)."""
    hp = hp or PRESET_HPARAMS[preset]
    return LoadedModel(
        hparams=hp,
        params=random_params(hp, seed, compute_dtype, device),
        mel_filters=mel_filterbank(hp.n_mels),
        vocab=synthetic_vocab(hp.n_vocab),
        n_loaded=-1,  # sentinel: random init, not a real checkpoint
    )


def tiny_test_hparams(n_vocab: int = 51864, n_mels: int = 80) -> WhisperHParams:
    """A micro model (2 audio / 3 text layers, 64-dim) for fast unit tests.

    THREE decoder layers on purpose: n_text_layer == 2 with a non-51866
    vocab trips the distil-whisper detection (loop.py is_distil, reference
    src/whisper.cpp:6954-6959), which force-disables timestamps."""
    return WhisperHParams(
        n_vocab=n_vocab, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2,
        n_audio_layer=2, n_text_ctx=448, n_text_state=64, n_text_head=2,
        n_text_layer=3, n_mels=n_mels,
    )
