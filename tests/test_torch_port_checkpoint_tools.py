"""The port's checkpoint tools against the JAX package's: GGUF
(checkpoint/gguf.py), the HF converter (convert_hf.py), the HF state-dict
exporter (export_pt.py), the native cache (native_cache.py) and the
download helper (tools/download.py). Files written by either package must
be byte-identical and load to equal parameters; no test reaches the
network."""

import json
import os
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from whisper_tpu.audio.mel import mel_filterbank
from whisper_tpu.checkpoint import convert_hf as j_convert
from whisper_tpu.checkpoint import export_pt as j_export
from whisper_tpu.checkpoint import ggml_io as j_ggml_io
from whisper_tpu.checkpoint import gguf as j_gguf
from whisper_tpu.checkpoint import native_cache as j_cache
from whisper_tpu.checkpoint import quant
from whisper_tpu.checkpoint.init import tiny_test_hparams
from whisper_tpu.errors import InvalidModelFormat as JInvalid
from whisper_tpu.tokenizer import synthetic_vocab
from whisper_tpu.tools import download as j_download
from whisper_tpu_torch.checkpoint import convert_hf as p_convert
from whisper_tpu_torch.checkpoint import export_pt as p_export
from whisper_tpu_torch.checkpoint import gguf as p_gguf
from whisper_tpu_torch.checkpoint import native_cache as p_cache
from whisper_tpu_torch.checkpoint.from_jax import params_from_jax
from whisper_tpu_torch.checkpoint.loader import load_model as p_load_model
from whisper_tpu_torch.errors import InvalidModelFormat as PInvalid
from whisper_tpu_torch.tools import download as p_download

from test_ggml_io import _make_test_tensors


def assert_trees_equal(got, want, path=""):
    """Two port parameter trees: the same structure, bit-equal leaves."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}.{i}")
    else:
        assert got.dtype == want.dtype and torch.equal(got, want), path


def jax_as_port(model):
    """A JAX LoadedModel's params in the port's layout."""
    return params_from_jax(jax.tree_util.tree_map(np.asarray, model.params), model.hparams)


# ------------------------------------------------------------------ GGUF

@pytest.mark.parametrize("ttype,keep_quantized", [(quant.GGML_TYPE_F32, False),
                                                  (quant.GGML_TYPE_Q5_1, True)])
def test_gguf_bytes_and_loads_equal(tmp_path, ttype, keep_quantized):
    hp = tiny_test_hparams()
    tensors = _make_test_tensors(hp, ttype=ttype)
    vocab = synthetic_vocab(hp.n_vocab).id_to_token[:50256]
    jpath, ppath = tmp_path / "j.gguf", tmp_path / "p.gguf"
    j_gguf.write_gguf(str(jpath), hp, mel_filterbank(hp.n_mels), vocab, tensors)
    p_gguf.write_gguf(str(ppath), hp, mel_filterbank(hp.n_mels), vocab, tensors)
    data = jpath.read_bytes()
    assert ppath.read_bytes() == data
    assert len(data) % p_gguf.ALIGNMENT == 0

    jc, pc = j_gguf.read_gguf(str(ppath)), p_gguf.read_gguf(str(jpath))
    assert pc.hparams.__dict__ == jc.hparams.__dict__ == hp.__dict__
    assert pc.vocab_tokens == jc.vocab_tokens == vocab
    np.testing.assert_array_equal(pc.mel_filters, jc.mel_filters)
    assert list(pc.tensors) == list(jc.tensors) == list(tensors)
    for name, rt in jc.tensors.items():
        assert (pc.tensors[name].ne, pc.tensors[name].ttype, pc.tensors[name].data) == \
            (rt.ne, rt.ttype, rt.data), name

    jm = j_gguf.load_model_gguf(str(jpath), "float32", keep_quantized)
    pm = p_gguf.load_model_gguf(str(ppath), "float32", keep_quantized)
    assert_trees_equal(pm.params, jax_as_port(jm))
    assert pm.vocab.id_to_token == jm.vocab.id_to_token
    if keep_quantized:
        assert pm.params["decoder"]["blocks"][0]["mlp_0"]["m"].dtype == torch.float32


def test_gguf_bad_magic(tmp_path):
    bad = tmp_path / "bad.gguf"
    bad.write_bytes(b"\x00" * 64)
    with pytest.raises(JInvalid, match="bad GGUF magic"):
        j_gguf.read_gguf(str(bad))
    with pytest.raises(PInvalid, match="bad GGUF magic"):
        p_gguf.read_gguf(str(bad))


# -------------------------------------------------------- HF <-> ggml

@pytest.fixture(scope="module")
def hf_model():
    """A randomly initialised transformers Whisper, built from a config."""
    from transformers import WhisperConfig, WhisperForConditionalGeneration
    cfg = WhisperConfig(vocab_size=51864, num_mel_bins=80, d_model=64,
                        encoder_layers=2, decoder_layers=3, encoder_attention_heads=2,
                        decoder_attention_heads=2, encoder_ffn_dim=256, decoder_ffn_dim=256,
                        max_source_positions=1500, max_target_positions=448)
    torch.manual_seed(0)
    return WhisperForConditionalGeneration(cfg).eval()


@pytest.mark.parametrize("ftype", [quant.GGML_TYPE_F16, quant.GGML_TYPE_Q5_1])
def test_convert_hf_bytes_equal(tmp_path, hf_model, ftype):
    jpath, ppath = tmp_path / "j.bin", tmp_path / "p.bin"
    jhp = j_convert.convert_hf_to_ggml(hf_model, str(jpath), ftype)
    php = p_convert.convert_hf_to_ggml(hf_model, str(ppath), ftype)
    assert php.__dict__ == jhp.__dict__
    assert ppath.read_bytes() == jpath.read_bytes()
    ckpt = j_ggml_io.read_ggml(str(ppath))
    assert ckpt.tensors["decoder.blocks.0.mlp.0.weight"].ttype == ftype
    assert p_convert._TOP_MAP == j_convert._TOP_MAP
    assert p_convert._LAYER_PART == j_convert._LAYER_PART


def test_export_hf_state_dict_equal(tmp_path, hf_model, capsys):
    path = tmp_path / "m.bin"
    p_convert.convert_hf_to_ggml(hf_model, str(path), quant.GGML_TYPE_F16)
    jsd, jhp = j_export.export_hf_state_dict(str(path))
    psd, php = p_export.export_hf_state_dict(str(path))
    assert php.__dict__ == jhp.__dict__
    assert list(psd) == list(jsd)
    for k in jsd:
        np.testing.assert_array_equal(psd[k], jsd[k], err_msg=k)
    # the dict loads back into the HF model (f16 rounding of the weights)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in psd.items()}
    missing, unexpected = hf_model.load_state_dict(
        {**hf_model.state_dict(), **sd}, strict=False)
    assert not unexpected
    assert p_export.main([str(path), str(tmp_path / "out")]) == 0
    saved = torch.load(tmp_path / "out" / "torch-model.pt", weights_only=True)
    assert set(saved["state_dict"]) == set(psd) and saved["dims"] == jhp.__dict__
    assert "torch-model.pt" in capsys.readouterr().out


# ---------------------------------------------------------- native cache

def _write_bin(path, hp, seed, ttype=quant.GGML_TYPE_F32):
    j_ggml_io.write_ggml(str(path), hp, mel_filterbank(hp.n_mels),
                         synthetic_vocab(hp.n_vocab).id_to_token[:50256],
                         _make_test_tensors(hp, ttype=ttype, seed=seed))


@pytest.mark.parametrize("keep_quantized", [False, True])
def test_native_cache_roundtrip(tmp_path, keep_quantized):
    hp = tiny_test_hparams()
    path = tmp_path / "model.bin"
    _write_bin(path, hp, 0, quant.GGML_TYPE_Q5_0)
    cache = tmp_path / "cache"
    parsed = p_cache.load_model_cached(str(path), "bfloat16", keep_quantized,
                                       cache_dir=str(cache))
    assert sorted(os.listdir(cache)) == ["mel_filters.f32", "meta.json", "params.pt"]
    cached = p_cache.load_native(str(cache), source_path=str(path))
    assert cached is not None
    assert cached.hparams == parsed.hparams and cached.n_loaded == parsed.n_loaded
    assert_trees_equal(cached.params, parsed.params)
    np.testing.assert_array_equal(cached.mel_filters, parsed.mel_filters)
    assert cached.vocab.id_to_token == parsed.vocab.id_to_token
    again = p_cache.load_model_cached(str(path), "bfloat16", keep_quantized,
                                      cache_dir=str(cache))
    assert_trees_equal(again.params, parsed.params)
    # the default cache sits beside the .bin, apart from the JAX package's
    p_cache.load_model_cached(str(path), "float32")
    assert (tmp_path / "model.bin.native-torch-float32" / "meta.json").exists()


def test_native_cache_matches_jax_cache(tmp_path):
    """Both packages' caches of one .bin restore the same hparams, vocab
    (truncated alike) and parameters."""
    hp = tiny_test_hparams()
    path = tmp_path / "model.bin"
    _write_bin(path, hp, 3)
    for mod, d in ((j_cache, "jc"), (p_cache, "pc"), (j_cache, "jc"), (p_cache, "pc")):
        mod.load_model_cached(str(path), "float32", cache_dir=str(tmp_path / d))
    jm = j_cache.load_native(str(tmp_path / "jc"), source_path=str(path))
    pm = p_cache.load_native(str(tmp_path / "pc"), source_path=str(path))
    assert pm.hparams.__dict__ == jm.hparams.__dict__
    assert pm.vocab.id_to_token == jm.vocab.id_to_token
    metas = [json.loads((tmp_path / d / "meta.json").read_text()) for d in ("pc", "jc")]
    assert metas[0] == metas[1]
    assert (tmp_path / "pc" / "mel_filters.f32").read_bytes() == \
        (tmp_path / "jc" / "mel_filters.f32").read_bytes()
    assert_trees_equal(pm.params, jax_as_port(jm))


def test_native_cache_invalidated_on_source_change(tmp_path):
    hp = tiny_test_hparams()
    path, cache = tmp_path / "m.bin", str(tmp_path / "cache")
    _write_bin(path, hp, 1)
    m1 = p_cache.load_model_cached(str(path), "float32", cache_dir=cache)
    assert p_cache.load_native(cache, source_path=str(path)) is not None
    time.sleep(0.01)                # a distinct mtime_ns
    _write_bin(path, hp, 2)
    assert p_cache.load_native(cache, source_path=str(path)) is None
    m2 = p_cache.load_model_cached(str(path), "float32", cache_dir=cache)
    assert not torch.equal(m1.params["decoder"]["token_embed"],
                           m2.params["decoder"]["token_embed"])
    assert_trees_equal(m2.params, p_load_model(str(path), "float32").params)
    # a cache without its meta.json is no cache
    os.remove(os.path.join(cache, "meta.json"))
    assert p_cache.load_native(cache) is None


# -------------------------------------------------------------- download

def test_download_lists_and_urls_equal(capsys):
    assert p_download.MODELS == j_download.MODELS
    assert p_download.VAD_MODELS == j_download.VAD_MODELS
    for name in p_download.MODELS + p_download.VAD_MODELS:
        assert p_download.model_url(name) == j_download.model_url(name)
    outs = []
    for mod in (j_download, p_download):
        for argv in (["--list"], [], ["--url-only", "large-v3-q5_0"],
                     ["--url-only", "silero-v5.1.2"], ["--url-only", "nope"], ["nope"]):
            rc = mod.main(argv)
            cap = capsys.readouterr()
            outs.append((rc, cap.out, cap.err))
    half = len(outs) // 2
    assert outs[half:] == outs[:half]
    assert [o[0] for o in outs[:half]] == [0, 0, 0, 0, 1, 1]


def test_download_exits_without_network(tmp_path, monkeypatch, capsys):
    """An existing file is kept; a failed transfer exits 2 and leaves no
    partial file (urlretrieve replaced: no test reaches the network)."""
    def refuse(url, dest):
        with open(dest, "wb") as f:
            f.write(b"partial")
        raise OSError("network unreachable")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    for mod in (j_download, p_download):
        d = tmp_path / mod.__name__
        assert mod.main(["tiny", str(d)]) == 2
        assert "download failed: network unreachable" in capsys.readouterr().err
        assert not os.listdir(d)
        (d / "ggml-tiny.bin").write_bytes(b"x")
        assert mod.download("tiny", str(d), quiet=True) == str(d / "ggml-tiny.bin")
