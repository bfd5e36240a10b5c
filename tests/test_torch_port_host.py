"""Host-side modules of the PyTorch port against the JAX package:
tokenizer, parameter defaults, ggml container and quant codecs, weights
(random init, the ggml loader, params_from_jax) and the log-mel frontend.
The port keeps its own copies of these modules; every check here feeds
both packages the same inputs."""

import dataclasses
import enum
import io

import jax
import numpy as np
import pytest
import torch

import whisper_tpu.config as jcfg
import whisper_tpu_torch.config as pcfg
from whisper_tpu.audio import mel as jmel
from whisper_tpu.checkpoint import ggml_io as jggml
from whisper_tpu.checkpoint import init as jinit
from whisper_tpu.checkpoint import loader as jloader
from whisper_tpu.checkpoint import quant as jquant
from whisper_tpu.tokenizer import Tokenizer as JTokenizer
from whisper_tpu.tokenizer import synthetic_vocab as j_synthetic_vocab
from whisper_tpu_torch.audio import mel as pmel
from whisper_tpu_torch.checkpoint import ggml_io as pggml
from whisper_tpu_torch.checkpoint import init as pinit
from whisper_tpu_torch.checkpoint import loader as ploader
from whisper_tpu_torch.checkpoint import quant as pquant
from whisper_tpu_torch.checkpoint.from_jax import params_from_jax
from whisper_tpu_torch.tokenizer import Tokenizer as PTokenizer
from whisper_tpu_torch.tokenizer import synthetic_vocab as p_synthetic_vocab

from test_ggml_io import _make_test_tensors

CORPUS = [" the country", "Zq9@#!", "héllo wörld 中文", "hi",
          "ask not what your country can do for you.",
          "it's 1984, isn't it? _under_score café -- ♪", "   spaced   out  "]


@pytest.mark.parametrize("n_vocab", [51864, 51865, 51866])
def test_tokenizer_ids_match(n_vocab):
    jv, pv = j_synthetic_vocab(n_vocab), p_synthetic_vocab(n_vocab)
    assert pv.id_to_token == jv.id_to_token
    for name in ("eot", "sot", "translate", "transcribe", "solm", "prev",
                 "nosp", "not", "beg"):
        assert getattr(pv, f"token_{name}") == getattr(jv, f"token_{name}")
    jt, ptok = JTokenizer(jv), PTokenizer(pv)
    for text in CORPUS:
        ids = ptok.encode(text)
        assert ids == jt.encode(text)
        assert ptok.decode(ids) == jt.decode(ids)


def _plain(value):
    """Dataclass / enum values in a form comparable across the packages."""
    if dataclasses.is_dataclass(value):
        return {f.name: _plain(getattr(value, f.name)) for f in dataclasses.fields(value)}
    if isinstance(value, enum.Enum):
        return (type(value).__name__, value.name, value.value)
    return value


def test_param_defaults_match():
    jc, pc = _plain(jcfg.ContextParams()), _plain(pcfg.ContextParams())
    assert pc == jc
    assert [f.name for f in dataclasses.fields(pcfg.ContextParams)] == \
        [f.name for f in dataclasses.fields(jcfg.ContextParams)]
    for strategy in ("GREEDY", "BEAM_SEARCH"):
        jf = jcfg.FullParams.default(getattr(jcfg.SamplingStrategy, strategy))
        pf = pcfg.FullParams.default(getattr(pcfg.SamplingStrategy, strategy))
        assert _plain(pf) == _plain(jf)
        assert pf.temperatures() == jf.temperatures()
        assert pf.n_decoders == jf.n_decoders
    assert {k: _plain(v) for k, v in pcfg.PRESET_HPARAMS.items()} == \
        {k: _plain(v) for k, v in jcfg.PRESET_HPARAMS.items()}
    for name in ("SAMPLE_RATE", "N_FFT", "HOP_LENGTH", "CHUNK_SIZE",
                 "N_SAMPLES_PER_CHUNK", "MAX_DECODERS", "N_FRAMES_PER_CHUNK"):
        assert getattr(pcfg, name) == getattr(jcfg, name)


def _checkpoint_bytes(mod, hp, tensors):
    buf = io.BytesIO()
    vocab = j_synthetic_vocab(hp.n_vocab)
    mod.write_ggml(buf, hp, jmel.mel_filterbank(hp.n_mels),
                   vocab.id_to_token[:50256], tensors)
    return buf.getvalue()


def test_ggml_roundtrip_matches():
    hp = jinit.tiny_test_hparams()
    tensors = _make_test_tensors(hp, ttype=jquant.GGML_TYPE_F16)
    data = _checkpoint_bytes(pggml, hp, tensors)
    assert data == _checkpoint_bytes(jggml, hp, tensors)
    pc = pggml.read_ggml(io.BytesIO(data))
    jc = jggml.read_ggml(io.BytesIO(data))
    assert _plain(pc.hparams) == _plain(jc.hparams)
    assert pc.qnt_version == jc.qnt_version
    assert pc.vocab_tokens == jc.vocab_tokens
    np.testing.assert_array_equal(pc.mel_filters, jc.mel_filters)
    assert pc.tensors.keys() == jc.tensors.keys()
    for name, rt in pc.tensors.items():
        assert (rt.ne, rt.ttype, rt.data) == (jc.tensors[name].ne,
                                              jc.tensors[name].ttype,
                                              jc.tensors[name].data)


CODECS = [jquant.GGML_TYPE_F32, jquant.GGML_TYPE_F16, jquant.GGML_TYPE_Q4_0,
          jquant.GGML_TYPE_Q4_1, jquant.GGML_TYPE_Q5_0, jquant.GGML_TYPE_Q5_1,
          jquant.GGML_TYPE_Q8_0, jquant.GGML_TYPE_Q2_K, jquant.GGML_TYPE_Q3_K,
          jquant.GGML_TYPE_Q4_K, jquant.GGML_TYPE_Q5_K, jquant.GGML_TYPE_Q6_K]


@pytest.mark.parametrize("ttype", CODECS)
def test_quant_codecs_bit_exact(ttype):
    # 8192 elements: below the size at which the JAX package hands
    # dequantization to its native runtime, so both sides run numpy
    x = (np.random.default_rng(ttype).standard_normal((16, 512)) * 0.1).astype(np.float32)
    raw = pquant.quantize(x, ttype)
    assert raw == jquant.quantize(x, ttype)
    np.testing.assert_array_equal(pquant.dequantize(raw, ttype, x.size),
                                  jquant.dequantize(raw, ttype, x.size))
    if ttype not in (jquant.GGML_TYPE_F32, jquant.GGML_TYPE_F16):
        for a, b in zip(pquant.dequantize_to_int8_blocks(raw, ttype, x.size),
                        jquant.dequantize_to_int8_blocks(raw, ttype, x.size)):
            np.testing.assert_array_equal(a, b)


def assert_trees_equal(got, want, path="params"):
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert torch.equal(got, want), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_random_params_match_jax_draws(dtype):
    hp = jinit.tiny_test_hparams()
    jparams = jax.tree_util.tree_map(np.asarray, jinit.random_params(hp, 5, dtype))
    assert_trees_equal(pinit.random_params(hp, 5, dtype),
                       params_from_jax(jparams, hp, dtype))


@pytest.mark.parametrize("ttype", [jquant.GGML_TYPE_F32, jquant.GGML_TYPE_Q8_0])
def test_loader_matches_jax_loader(ttype):
    hp = jinit.tiny_test_hparams()
    data = _checkpoint_bytes(jggml, hp, _make_test_tensors(hp, ttype=ttype))
    pm = ploader.params_from_checkpoint(pggml.read_ggml(io.BytesIO(data)), "float32")
    jm = jloader.params_from_checkpoint(jggml.read_ggml(io.BytesIO(data)), "float32")
    assert pm.n_loaded == jm.n_loaded
    assert pm.vocab.id_to_token == jm.vocab.id_to_token
    np.testing.assert_array_equal(pm.mel_filters, jm.mel_filters)
    assert_trees_equal(pm.params, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), hp, "float32"))
    # the port's layout: linear [out, in], conv (out, in, k), per-layer list
    d = hp.n_audio_state
    assert pm.params["encoder"]["conv1"]["w"].shape == (d, hp.n_mels, 3)
    assert pm.params["encoder"]["blocks"][0]["mlp_0"]["w"].shape == (4 * d, d)
    assert len(pm.params["decoder"]["blocks"]) == hp.n_text_layer


def test_loader_dtypes_and_unported_options():
    hp = jinit.tiny_test_hparams()
    data = _checkpoint_bytes(jggml, hp, _make_test_tensors(hp))
    m = ploader.params_from_checkpoint(pggml.read_ggml(io.BytesIO(data)))
    blk = m.params["decoder"]["blocks"][0]
    assert blk["attn_q"]["w"].dtype == torch.bfloat16
    assert m.params["decoder"]["token_embed"].dtype == torch.bfloat16
    assert blk["attn_q"]["b"].dtype == torch.float32
    assert blk["attn_ln"]["scale"].dtype == torch.float32
    # keep_quantized is this slice's now: an f32 checkpoint has no block
    # format to keep, so its weights stay dense
    mq = ploader.params_from_checkpoint(pggml.read_ggml(io.BytesIO(data)),
                                        keep_quantized=True)
    assert "w" in mq.params["decoder"]["blocks"][0]["attn_q"]


def test_mel_host_helpers_match():
    np.testing.assert_array_equal(pmel.hann_window(), jmel.hann_window())
    for n_mels in (80, 128):
        np.testing.assert_array_equal(pmel.mel_filterbank(n_mels),
                                      jmel.mel_filterbank(n_mels))
    for n in (0, 1, 150, 199, 200, 16000, 480000, 16000 * 35 + 7):
        assert pmel.frame_counts(n) == jmel.frame_counts(n)


# lengths: < 200 samples (the C-truncating n_len_org), < 30 s, exactly 30 s,
# and past one 30 s frame bucket
@pytest.mark.parametrize("n", [150, 16000 * 11, 480000, 16000 * 35 + 7])
def test_log_mel_matches_jax_and_reference(n):
    rng = np.random.default_rng(n)
    t = np.arange(n) / 16000
    x = (0.2 * np.sin(2 * np.pi * 220 * t) * (t % 2 < 1.5)
         + 0.01 * rng.standard_normal(n)).astype(np.float32)
    fb = jmel.mel_filterbank(80)
    got, n_len, n_len_org = pmel.log_mel_spectrogram(x, fb)
    want, jn_len, jn_len_org = jmel.log_mel_spectrogram(x, fb)
    assert (n_len, n_len_org) == (jn_len, jn_len_org)
    got = got.numpy()
    assert got.shape == (80, n_len) and got.dtype == np.float32
    # float32 FFTs of two libraries: summation order only
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
    # the float64 oracle, at the JAX package's own tolerance (test_mel.py)
    ref = pmel.log_mel_reference(x, fb)
    np.testing.assert_array_equal(ref, jmel.log_mel_reference(x, fb))
    assert np.abs(got - ref).max() < 2e-3
