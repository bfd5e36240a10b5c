"""Token-level timestamps in the PyTorch port against the JAX package: the
energy heuristic (decoding/timestamps.py), DTW (decoding/dtw.py) and the
cross-attention probabilities DTW reads (decoder_forward with
collect_cross_qk).

Both packages compute the signal energy and the DTW path in their host
C++ runtimes (the same source) when those are built, else on numpy. The
`no_native` tests hold the port's numpy paths against the JAX package's
(`get_lib` returns None in both packages for the test); the `both_native`
tests beside them hold the two runtimes' paths.

Tolerances: collect_cross_qk probabilities within 1e-5 in float32; in
bfloat16 within 2e-2, as the JAX package's bf16 comparisons are (rounding
of the bf16 activations differs with the summation order). Token ids,
t0/t1 and t_dtw are integers and must be equal (float32, the decisive
config)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu as wt
import whisper_tpu_torch as pt
from whisper_tpu import config as jcfg
from whisper_tpu.checkpoint import init as jinit
from whisper_tpu.decoding import dtw as jdtw
from whisper_tpu.decoding import timestamps as jts
from whisper_tpu.models import whisper as jm
from whisper_tpu.runtime import native
from whisper_tpu_torch import config as pcfg
from whisper_tpu_torch.checkpoint.from_jax import params_from_jax
from whisper_tpu_torch.decoding import dtw as pdtw
from whisper_tpu_torch.decoding import timestamps as pts
from whisper_tpu_torch.models import whisper as pm
from whisper_tpu_torch.runtime import native as pnative

from test_torch_port_e2e import port_context

QK_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture
def no_native(monkeypatch):
    """Both packages on their numpy paths (no host C++ runtime)."""
    monkeypatch.setattr(native, "get_lib", lambda: None)
    monkeypatch.setattr(pnative, "get_lib", lambda: None)


@pytest.fixture
def both_native():
    """Both packages on their host runtimes (skips where one did not build)."""
    if not (native.available() and pnative.available()):
        pytest.skip("a host C++ runtime did not build (no g++?)")


def test_voice_length_matches():
    for text in ["", " the", "1984,", "what?!", "café", "日本語", " ...", "a b c"]:
        assert pts.voice_length(text) == jts.voice_length(text)


@pytest.mark.parametrize("hw", [1, 32, 2000])
def test_signal_energy_bit_equal(no_native, hw):
    x = np.random.default_rng(hw).standard_normal(16000 * 2 + 17).astype(np.float32)
    got, want = pts.get_signal_energy(x, hw), jts.get_signal_energy(x, hw)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("hw", [1, 32, 2000])
def test_signal_energy_bit_equal_native(both_native, hw):
    test_signal_energy_bit_equal(None, hw)


@pytest.mark.parametrize("width", [3, 7, 9])
def test_median_filter_matches(width):
    x = np.random.default_rng(width).standard_normal((4, 6, 50)).astype(np.float32)
    np.testing.assert_array_equal(pdtw.median_filter_reflect(x, width),
                                  jdtw.median_filter_reflect(x, width))


@pytest.mark.parametrize("n,m", [(1, 1), (5, 5), (7, 40), (30, 12), (40, 300)])
def test_dtw_path_matches(no_native, n, m):
    x = np.random.default_rng(n * m).standard_normal((n, m))
    for a, b in zip(pdtw.dtw_path(x), jdtw.dtw_path(x)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,m", [(1, 1), (7, 40), (40, 300), (200, 750)])
def test_dtw_path_matches_native(both_native, n, m):
    test_dtw_path_matches(None, n, m)


def test_resolve_alignment_heads_matches():
    hp = jinit.tiny_test_hparams()
    for preset in jcfg.AlignmentHeadsPreset:
        for n_top in (-1, 2):
            jc = jcfg.ContextParams(dtw=jcfg.DtwParams(mode=preset, n_top=n_top,
                                                       custom_aheads=((0, 1), (2, 0))))
            pc = pcfg.ContextParams(dtw=pcfg.DtwParams(
                mode=pcfg.AlignmentHeadsPreset[preset.name], n_top=n_top,
                custom_aheads=((0, 1), (2, 0))))
            assert pdtw.resolve_alignment_heads(pc, hp) == jdtw.resolve_alignment_heads(jc, hp)


# ---------------------------------------------------------------- cross QK

@pytest.fixture(scope="module")
def model():
    hp = jinit.tiny_test_hparams()
    jp = jax.tree_util.tree_map(jnp.asarray, jinit.random_params(hp, 4, "float32"))
    rng = np.random.default_rng(2)
    mel = rng.standard_normal((1, hp.n_mels, 2 * hp.n_audio_ctx)).astype(np.float32)
    return hp, jp, mel


def tt(a):
    return torch.from_numpy(np.array(a, np.float32) if a.dtype == jnp.bfloat16 else np.array(a))


@pytest.mark.parametrize("dtype,cross_int8,batch", [
    ("float32", False, 1), ("float32", True, 1), ("float32", False, 3),
    ("float32", True, 3), ("bfloat16", False, 1), ("bfloat16", True, 1)],
    ids=["f32", "f32-int8-cross", "f32-folded", "f32-int8-folded", "bf16", "bf16-int8-cross"])
def test_collect_cross_qk_matches_jax(model, dtype, cross_int8, batch):
    """The DTW pass's probabilities, (L, B, H, T, Ta) float32, against the
    JAX package's plain path: dense and int8 cross-KV, and the folded
    case (one encoder copy shared by B decoder rows)."""
    hp, jp, mel = model
    jdt, pdt = jnp.dtype(dtype), getattr(torch, dtype)
    enc = jm.encoder_forward(jp, hp, jnp.asarray(mel), jdt)
    ck_j, cv_j = jm.cross_attention_kv(jp, hp, enc, quant=cross_int8)
    conv = (lambda kv: tuple(tt(a) for a in kv)) if cross_int8 else tt
    pp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), hp, dtype)
    toks = np.random.default_rng(batch).integers(0, 50000, (batch, 11)).astype(np.int32)
    kv_j = jm.KVCache.zeros(hp, batch, jdt, size=128)
    lg_j, _, qk_j = jm.decoder_forward(jp, hp, jnp.asarray(toks), jnp.int32(0), kv_j,
                                       ck_j, cv_j, jdt, collect_cross_qk=True,
                                       logit_rows=jnp.int32(0))
    kv_p = pm.KVCache.zeros(hp, batch, pdt, size=128)
    lg_p, _, qk_p = pm.decoder_forward(pp, hp, torch.from_numpy(toks).long(), 0, kv_p,
                                       conv(ck_j), conv(cv_j), pdt, collect_cross_qk=True,
                                       logit_rows=0)
    qk_j = np.asarray(qk_j)
    assert qk_p.dtype == torch.float32 and qk_j.dtype == np.float32
    assert tuple(qk_p.shape) == qk_j.shape == (hp.n_text_layer, batch, hp.n_text_head, 11,
                                              hp.n_audio_ctx)
    tol = QK_TOL[dtype]
    np.testing.assert_allclose(qk_p.numpy(), qk_j, rtol=0, atol=tol)
    assert lg_p.shape == (batch, 1, hp.n_vocab)
    np.testing.assert_allclose(lg_p.numpy(), np.asarray(lg_j), rtol=0,
                               atol=1e-4 if dtype == "float32" else 0.5)


# ---------------------------------------------------------------- full()

def full_audio(seconds=12, seed=11):
    rng = np.random.default_rng(seed)
    t = np.arange(seconds * 16000) / 16000
    sig = np.sin(2 * np.pi * 180 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 1.3 * t))
    return (0.3 * sig + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)


def dtw_contexts(n_vocab, mode, kv_dtype="bfloat16"):
    heads = ((1, 0), (2, 1))
    jctx = wt.WhisperContext.random(
        hp=jinit.tiny_test_hparams(n_vocab=n_vocab),
        params=jcfg.ContextParams(
            dtype="float32", kv_dtype=kv_dtype, dtw_token_timestamps=mode is not None,
            dtw=jcfg.DtwParams(mode=jcfg.AlignmentHeadsPreset[mode or "NONE"],
                               custom_aheads=heads)), seed=3)
    pctx = port_context(jctx)
    pctx.cparams = pcfg.ContextParams(
        use_gpu=False, dtype="float32", kv_dtype=kv_dtype,
        dtw_token_timestamps=mode is not None,
        dtw=pcfg.DtwParams(mode=pcfg.AlignmentHeadsPreset[mode or "NONE"],
                           custom_aheads=heads))
    pctx.kv_quant = kv_dtype == "int8"
    return jctx, pctx


def ts_params(mod, strategy, max_len=0):
    p = mod.FullParams.default(getattr(mod.SamplingStrategy, strategy))
    p.beam_search.beam_size = 5
    p.temperature_inc = 0.0
    p.print_progress = False
    p.max_tokens = 10
    p.suppress_regex = r"<syn\d\d\d+>"
    p.token_timestamps = True
    p.max_len = max_len
    return p


def token_segments(st):
    return [(s.text, s.t0, s.t1, [(t.id, t.t0, t.t1, t.t_dtw) for t in s.tokens])
            for s in st.segments]


@pytest.mark.parametrize("strategy", ["GREEDY", "BEAM_SEARCH"])
@pytest.mark.parametrize("mode,n_vocab", [("N_TOP_MOST", 51864), ("CUSTOM", 51865),
                                          (None, 51864)],
                         ids=["dtw-top-most", "dtw-custom-multilingual", "energy-only"])
def test_full_token_timestamps_match(no_native, strategy, mode, n_vocab):
    jctx, pctx = dtw_contexts(n_vocab, mode)
    audio = full_audio()
    js, ps = jctx.create_state(), pctx.create_state()
    js.full(ts_params(wt, strategy), audio)
    ps.full(ts_params(pt, strategy), audio)
    got, want = token_segments(ps), token_segments(js)
    assert got == want and got
    toks = [t for s in ps.segments for t in s.tokens]
    assert all(t.t0 >= 0 and t.t1 >= t.t0 for t in toks)
    if mode is not None:
        stamped = [t.t_dtw for t in toks if t.id < pctx.vocab.token_eot]
        assert stamped and all(d >= 0 for d in stamped)
    else:
        assert all(t.t_dtw == -1 for t in toks)


def test_full_token_timestamps_match_native(both_native):
    """Greedy with energy timestamps and DTW, both packages on their host
    runtimes."""
    test_full_token_timestamps_match(None, "GREEDY", "N_TOP_MOST", 51864)


def test_full_max_len_wrap_and_int8_kv_match(no_native):
    """max_len wrapping of the timestamped segments, with the int8 KV
    cache (the DTW pass still decodes with a fresh compute-dtype cache)."""
    jctx, pctx = dtw_contexts(51864, "N_TOP_MOST", kv_dtype="int8")
    audio = full_audio(9, seed=4)
    js, ps = jctx.create_state(), pctx.create_state()
    pj, pp = ts_params(wt, "GREEDY", max_len=4), ts_params(pt, "GREEDY", max_len=4)
    pj.no_timestamps = pp.no_timestamps = True     # one long segment to wrap
    js.full(pj, audio)
    ps.full(pp, audio)
    assert token_segments(ps) == token_segments(js)
    assert ps.full_n_segments() >= 3
