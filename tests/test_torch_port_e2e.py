"""The PyTorch port's main path against the JAX package, end to end.

`WhisperState.full` on ~35 s of seeded audio (two windows), greedy and
beam-5, with the temperature ladder off and the decisive config (a
suppress_regex that shrinks the candidate set, no timestamps, max_tokens;
CLAUDE.md), on the same weights carried across with params_from_jax: the
segments must be equal — text, t0, t1 and token ids. Both packages run in
float32 on the CPU."""

import jax
import numpy as np
import pytest

import whisper_tpu as wt
import whisper_tpu_torch as pt
from whisper_tpu.checkpoint.init import tiny_test_hparams
from whisper_tpu_torch.checkpoint.from_jax import params_from_jax
from whisper_tpu_torch.checkpoint.loader import LoadedModel


def port_context(jctx, dtype="float32"):
    """A CPU port context on the JAX context's weights."""
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jctx.params),
                             jctx.hparams, dtype)
    model = LoadedModel(jctx.hparams, params, jctx.mel_filters, jctx.vocab, -1)
    return pt.WhisperContext(model, pt.ContextParams(use_gpu=False, dtype=dtype))


@pytest.fixture(scope="module")
def contexts():
    jctx = wt.WhisperContext.random(
        hp=tiny_test_hparams(), params=wt.ContextParams(dtype="float32"), seed=3)
    return jctx, port_context(jctx)


@pytest.fixture(scope="module")
def audio_35s():
    rng = np.random.default_rng(11)
    sr = 16000
    t = np.arange(35 * sr) / sr
    sig = np.sin(2 * np.pi * 180 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 1.3 * t))
    return (0.3 * sig + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)


def decisive(mod, strategy_name, beam=5):
    p = mod.FullParams.default(getattr(mod.SamplingStrategy, strategy_name))
    p.beam_search.beam_size = beam
    p.temperature_inc = 0.0
    p.print_progress = False
    p.no_timestamps = True
    p.max_tokens = 10
    p.suppress_regex = r"<syn\d\d\d+>"
    return p


@pytest.mark.parametrize("strategy", ["GREEDY", "BEAM_SEARCH"])
def test_full_segments_match(contexts, audio_35s, strategy):
    jctx, pctx = contexts
    js, ps = jctx.create_state(), pctx.create_state()
    js.full(decisive(wt, strategy), audio_35s)
    ps.full(decisive(pt, strategy), audio_35s)
    assert js.full_n_segments() >= 2          # two windows
    want = [(s.text, s.t0, s.t1, [t.id for t in s.tokens]) for s in js.segments]
    got = [(s.text, s.t0, s.t1, [t.id for t in s.tokens]) for s in ps.segments]
    assert got == want
    # token probabilities agree too (float32, summation order only)
    for sj, sp in zip(js.segments, ps.segments):
        np.testing.assert_allclose([t.plog for t in sp.tokens],
                                   [t.plog for t in sj.tokens], rtol=0, atol=1e-4)


@pytest.mark.parametrize("entry", ["new_with_params", "from_buffer"])
def test_checkpoint_entry_points_match(tmp_path, audio_35s, entry):
    """A ggml checkpoint loaded by each package's entry point transcribes
    to the same segments (greedy, decisive config, first 12 s)."""
    from test_ggml_io import _make_test_tensors, _write_checkpoint
    hp = tiny_test_hparams()
    data = _write_checkpoint(hp, _make_test_tensors(hp, seed=4)).getvalue()
    path = tmp_path / "tiny.bin"
    path.write_bytes(data)
    arg = str(path) if entry == "new_with_params" else data
    jctx = getattr(wt.WhisperContext, entry)(arg, wt.ContextParams(dtype="float32"))
    pctx = getattr(pt.WhisperContext, entry)(
        arg, pt.ContextParams(dtype="float32", use_gpu=False))
    audio = audio_35s[: 12 * 16000]
    js, ps = jctx.create_state(), pctx.create_state()
    js.full(decisive(wt, "GREEDY"), audio)
    ps.full(decisive(pt, "GREEDY"), audio)
    assert [(s.text, s.t0, s.t1) for s in ps.segments] == \
        [(s.text, s.t0, s.t1) for s in js.segments]
    assert js.full_n_segments() > 0


def test_low_level_decode_and_logits(contexts, audio_35s):
    """encode() + decode() + get_logits() through the state API."""
    jctx, pctx = contexts
    js, ps = jctx.create_state(), pctx.create_state()
    js.pcm_to_mel(audio_35s)
    ps.pcm_to_mel(audio_35s)
    assert (ps.n_len, ps.n_len_org) == (js.n_len, js.n_len_org)
    np.testing.assert_allclose(ps.encode(3000).numpy(), np.asarray(js.encode(3000)),
                               rtol=1e-4, atol=1e-4)
    toks = [jctx.vocab.token_sot, jctx.vocab.token_not, 300]
    _, kv_j = js.decode(toks, 0, js.new_kv_cache(2), batch=2)
    _, kv_p = ps.decode(toks, 0, ps.new_kv_cache(2), batch=2)
    js.decode([[11], [12]], 3, kv_j)
    ps.decode([[11], [12]], 3, kv_p)
    got, want = ps.get_logits(), js.get_logits()
    assert got.shape == want.shape == (2, jctx.hparams.n_vocab)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert ps.get_timings()["prompt"]["calls"] == 1
    assert ps.get_timings()["decode"]["calls"] == 1


def test_warmup_runs_every_prompt_bucket(contexts):
    _, pctx = contexts
    pctx.warmup(decisive(pt, "GREEDY"))           # three full() calls on silence
