"""Language auto-detection in the PyTorch port against the JAX package.

Both packages run a tiny random-weight model in float32 on the CPU, with
the same weights (params_from_jax) and the same seeded audio:
`lang_detect` gives the same language id and probabilities within 1e-4;
`full` with language="auto" decodes the same segments under the detected
language, and detect_language stops after setting lang_id; the offset
bounds raise the same errors."""

import numpy as np
import pytest

import whisper_tpu as wt
import whisper_tpu_torch as pt
from whisper_tpu.checkpoint.init import tiny_test_hparams

from test_torch_port_e2e import port_context

PROB_TOL = 1e-4


def seeded_audio(seconds, seed=5):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    sig = np.sin(2 * np.pi * 210 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 0.9 * t))
    return (0.3 * sig + 0.03 * rng.standard_normal(t.shape)).astype(np.float32)


@pytest.fixture(scope="module", params=[51864, 51865, 51866],
                ids=["english", "multilingual-99", "multilingual-100"])
def contexts(request):
    jctx = wt.WhisperContext.random(
        hp=tiny_test_hparams(n_vocab=request.param),
        params=wt.ContextParams(dtype="float32"), seed=7)
    return jctx, port_context(jctx)


@pytest.mark.parametrize("offset_ms", [0, 3000, 11000])
def test_lang_detect_matches_jax(contexts, offset_ms):
    jctx, pctx = contexts
    audio = seeded_audio(12)
    js, ps = jctx.create_state(), pctx.create_state()
    js.pcm_to_mel(audio)
    ps.pcm_to_mel(audio)
    jid, jprobs = js.lang_detect(offset_ms)
    pid, pprobs = ps.lang_detect(offset_ms)
    assert pid == jid == js.lang_id == ps.lang_id
    assert pprobs.shape == jprobs.shape == (100,)
    assert pprobs.dtype == np.float32
    np.testing.assert_allclose(pprobs, jprobs, rtol=0, atol=PROB_TOL)
    assert abs(float(pprobs.sum()) - 1.0) < 1e-5


def auto_params(mod, detect_only=False):
    p = mod.FullParams.default()
    p.language = "auto"
    p.detect_language = detect_only
    p.temperature_inc = 0.0
    p.print_progress = False
    p.no_timestamps = True
    p.max_tokens = 8
    p.suppress_regex = r"<syn\d\d\d+>"
    return p


def test_full_auto_language_matches_jax(contexts):
    jctx, pctx = contexts
    audio = seeded_audio(8, seed=6)
    js, ps = jctx.create_state(), pctx.create_state()
    js.full(auto_params(wt), audio)
    ps.full(auto_params(pt), audio)
    assert ps.full_lang_id() == js.full_lang_id()
    want = [(s.text, s.t0, s.t1, [t.id for t in s.tokens]) for s in js.segments]
    got = [(s.text, s.t0, s.t1, [t.id for t in s.tokens]) for s in ps.segments]
    assert got == want and got
    # the extra encode of the detection shows in the timings
    assert ps.get_timings()["encode"]["calls"] == js.get_timings()["encode"]["calls"] == 2


@pytest.mark.parametrize("language", [None, "", "auto"])
def test_detect_language_stops_after_detection(contexts, language):
    jctx, pctx = contexts
    audio = seeded_audio(4, seed=8)
    js, ps = jctx.create_state(), pctx.create_state()
    pj, pp = auto_params(wt, detect_only=True), auto_params(pt, detect_only=True)
    pj.language = pp.language = language
    assert js.full(pj, audio) == ps.full(pp, audio) == 0
    assert ps.full_n_segments() == js.full_n_segments() == 0
    assert ps.full_lang_id() == js.full_lang_id()
    assert ps.get_timings()["encode"]["calls"] == 1


def test_lang_detect_error_bounds(contexts):
    """Before the start, past the unpadded end, and with no mel: the same
    exceptions from both packages."""
    jctx, pctx = contexts
    js, ps = jctx.create_state(), pctx.create_state()
    for st in (js, ps):
        with pytest.raises(RuntimeError, match="pcm_to_mel"):
            st.lang_detect(0)
    audio = seeded_audio(2)
    js.pcm_to_mel(audio)
    ps.pcm_to_mel(audio)
    n = js.n_len_org
    assert ps.n_len_org == n and ps.n_len > n   # the mel is padded past n
    for st in (js, ps):
        with pytest.raises(ValueError, match="before the start"):
            st.lang_detect(-10)
        with pytest.raises(ValueError, match="past the end"):
            st.lang_detect(10 * n)          # seek n: the unpadded length
        st.lang_detect(10 * (n - 1))        # the last unpadded frame is in bounds
