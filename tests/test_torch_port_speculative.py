"""Speculative greedy decoding in the PyTorch port against the JAX package.

`decode_window_speculative` (decoding/speculative.py) against
whisper_tpu/decoding/speculative.py on the same weights (carried across
with params_from_jax) and the same cross K/V: every WindowResult field,
the tokens, counts and decoder state exactly, the float statistics within
1e-5 (float32 on the CPU). Then the port's own speculative window against
its vanilla one (the longest prompt: the verify chunk's cache rows stay
inside the cache), and `full()` with a draft against `full()` without one
(multi-window with context carry, spec_stats per run, a shared encoder, a
keep_quantized Q5_0 main model whose draft inherits it), the requests that
must not speculate, and attach_draft's checks.

As in tests/test_speculative.py, the decoder token embedding is scaled by
8 so that the argmaxes are decisive between the T = 1 and T = k forwards
and between the two packages; the draft is another seed's model (the
worst case for acceptance, which must not change the stream) unless a
case says otherwise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu as wt
import whisper_tpu_torch as pt
from whisper_tpu.checkpoint import ggml_io as jggml
from whisper_tpu.checkpoint import quant as jquant
from whisper_tpu.checkpoint.init import tiny_test_hparams
from whisper_tpu.decoding import filters as jf
from whisper_tpu.decoding.speculative import decode_window_speculative as j_spec
from whisper_tpu_torch.decoding import device_loop as pdl
from whisper_tpu_torch.decoding import filters as pf
from whisper_tpu_torch.decoding import speculative as pspec
from whisper_tpu_torch.errors import InitError
from whisper_tpu_torch.models import whisper as pm

from test_ggml_io import _make_test_tensors
from test_torch_port_e2e import port_context
from test_torch_port_host import _checkpoint_bytes

FLOAT_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny model's ops are too small to gain from intra-op threads,
    and beside other test workers their spinning threads cost more than
    they give."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sharp_jax(seed):
    ctx = wt.WhisperContext.random(hp=tiny_test_hparams(),
                                   params=wt.ContextParams(dtype="float32"), seed=seed)
    dec = dict(ctx.params["decoder"])
    dec["token_embed"] = dec["token_embed"] * 8.0
    ctx.params = {**ctx.params, "decoder": dec}
    return ctx


@pytest.fixture(scope="module")
def models():
    """(JAX main, JAX draft, port main, port draft): seeds 0 and 123."""
    jm, jd = _sharp_jax(0), _sharp_jax(123)
    return jm, jd, port_context(jm), port_context(jd)


def _cross(jctx, audio):
    st = jctx.create_state()
    st.pcm_to_mel(audio)
    st.encode(0)
    return st.cross_k, st.cross_v, st.n_len_org


def _params(mod, no_timestamps=False, max_tokens=0):
    p = mod.FullParams.default()
    p.no_timestamps = no_timestamps
    p.max_tokens = max_tokens
    return p


def _prompt(vocab, no_timestamps, bucket=8):
    prompt = [vocab.token_sot] + ([vocab.token_not] if no_timestamps else [])
    padded = np.zeros(bucket, np.int32)
    padded[: len(prompt)] = prompt
    return padded, len(prompt)


def _port_window(pmain, pdraft, pck, pcv, dck, dcv, padded, plen, seek_end, k, p):
    consts, tids = pf.build_filter_consts(pmain.vocab, pmain.hparams, p)
    return pspec.decode_window_speculative(
        pmain.params, pdraft.params, pmain.hparams, pdraft.hparams, consts, pck, pcv,
        dck, dcv, padded, plen, 0, seek_end, tids=tids, k_spec=k,
        max_tokens=p.max_tokens, no_timestamps=p.no_timestamps, dtype=torch.float32)


def _port_vanilla(pmain, pck, pcv, padded, plen, seek_end, p):
    consts, tids = pf.build_filter_consts(pmain.vocab, pmain.hparams, p)
    return pdl.decode_window(
        pmain.params, pmain.hparams, consts, pck, pcv, padded, plen, 0.0, 0, seek_end,
        tids=tids, n_dec=1, strategy=pdl.GREEDY_BEST, max_tokens=p.max_tokens,
        no_timestamps=p.no_timestamps, dtype=torch.float32)


def _assert_same_stream(got, want):
    """The emitted stream and decoder state equal, the statistics within
    FLOAT_TOL (the port's speculative window against its vanilla one)."""
    n = int(want.n_tokens)
    assert int(got.n_tokens) == n > 0
    np.testing.assert_array_equal(got.tokens[:, :n], want.tokens[:, :n])
    np.testing.assert_array_equal(got.tok_tid[:, :n], want.tok_tid[:, :n])
    for name in ("result_len", "seek_delta", "completed", "failed"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    for name in ("tok_p", "tok_plog", "tok_pt", "tok_ptsum"):
        np.testing.assert_allclose(getattr(got, name)[:, :n], getattr(want, name)[:, :n],
                                   err_msg=name, **FLOAT_TOL)
    np.testing.assert_allclose(got.sum_logprobs_all, want.sum_logprobs_all, rtol=1e-5,
                               atol=1e-4)


# (k, seconds of audio, no_timestamps, max_tokens, self-draft): one JAX
# compile per (k, no_timestamps, max_tokens); the 1.2 s window and the
# self-draft reuse k = 8's. max_tokens bounds the random weights' windows
# (they decode to n_max otherwise)
WINDOW_CASES = {
    "k1_ts": (1, 3.0, False, 32, False),
    "k4_ts": (4, 3.0, False, 32, False),
    "k8_ts": (8, 3.0, False, 32, False),
    "k4_no_ts": (4, 3.0, True, 24, False),
    "k8_max_tokens_mid_chunk": (8, 3.0, True, 3, False),
    "k8_ts_1.2s": (8, 1.2, False, 32, False),
    "k8_ts_self_draft": (8, 3.0, False, 32, True),
}


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_window_matches_jax(models, jfk_like_audio, case):
    k, seconds, no_ts, max_tokens, self_draft = WINDOW_CASES[case]
    jmain, jdraft, pmain, pdraft = models
    if self_draft:
        jdraft, pdraft = jmain, pmain
    audio = jfk_like_audio[: int(16000 * seconds)]
    jck, jcv, seek_end = _cross(jmain, audio)
    jdck, jdcv, _ = _cross(jdraft, audio)
    padded, plen = _prompt(jmain.vocab, no_ts)
    jp = _params(wt, no_ts, max_tokens)
    jconsts, tids = jf.build_filter_consts(jmain.vocab, jmain.hparams, jp)
    jr = jax.tree_util.tree_map(np.asarray, j_spec(
        jmain.params, jdraft.params, jmain.hparams, jdraft.hparams, jconsts, jck, jcv,
        jdck, jdcv, jnp.asarray(padded), jnp.int32(plen), jnp.int32(0),
        jnp.int32(seek_end), tids=tids, k_spec=k, max_tokens=max_tokens,
        no_timestamps=no_ts, dtype=jnp.float32))
    t = lambda a: torch.from_numpy(np.array(a))
    pr = _port_window(pmain, pdraft, t(jck), t(jcv), t(jdck), t(jdcv), padded, plen,
                      seek_end, k, _params(pt, no_ts, max_tokens))

    n = int(jr.n_tokens)
    assert pr.n_tokens == n > 0
    assert pr.n_rounds == int(jr.n_rounds)
    for name in ("tokens", "tok_tid"):
        np.testing.assert_array_equal(getattr(pr, name)[:, :n], getattr(jr, name)[:, :n],
                                      err_msg=name)
    for name in ("result_len", "seek_delta", "completed", "failed"):
        np.testing.assert_array_equal(getattr(pr, name), getattr(jr, name), err_msg=name)
    for name in ("tok_p", "tok_plog", "tok_pt", "tok_ptsum"):
        np.testing.assert_allclose(getattr(pr, name)[:, :n], getattr(jr, name)[:, :n],
                                   err_msg=name, **FLOAT_TOL)
    np.testing.assert_allclose(pr.sum_logprobs_all, jr.sum_logprobs_all, **FLOAT_TOL)
    np.testing.assert_allclose(pr.no_speech_prob, float(jr.no_speech_prob), **FLOAT_TOL)
    assert n <= max_tokens + 1
    if self_draft and n >= 8:
        assert pr.n_rounds < n        # a self-draft accepts more than one token a round


def test_longest_prompt_stays_in_cache(models, jfk_like_audio, monkeypatch):
    """A prompt of n_text_ctx/2 + 8 tokens and a window decoded to n_max
    tokens (timestamps off, end-of-text suppressed), with a self-draft:
    the last verify chunk writes cache rows up to prompt_len + n_max - 2 +
    k, inside the cache, and the stream equals the vanilla window's."""
    pmain = models[2]
    hp, vocab = pmain.hparams, pmain.vocab
    st = pmain.create_state()
    st.pcm_to_mel(jfk_like_audio[: 16000 * 3])
    st.encode(0)
    prompt_max = hp.n_text_ctx // 2 + 8
    rng = np.random.default_rng(3)
    prompt = ([vocab.token_prev] + rng.integers(0, vocab.token_eot, prompt_max - 3).tolist()
              + [vocab.token_sot, vocab.token_not])
    padded = np.array(prompt, np.int32)
    p = _params(pt, no_timestamps=True)
    p.suppress_regex = r"\[_EOT_\]"
    k = 8

    writes = []
    fwd = pm.decoder_forward

    def spy(params, hp_, tokens, pos0, kv, *a, **kw):
        writes.append((int(pos0) + tokens.shape[1], kv.k.shape[3]))
        return fwd(params, hp_, tokens, pos0, kv, *a, **kw)

    monkeypatch.setattr(pm, "decoder_forward", spy)
    spec = _port_window(pmain, pmain, st.cross_k, st.cross_v, st.cross_k, st.cross_v,
                        padded, len(prompt), st.n_len_org, k, p)
    monkeypatch.undo()
    n_max = hp.n_text_ctx // 2 - 4
    assert spec.n_tokens == n_max
    assert all(end <= size for end, size in writes)
    assert max(end for end, _ in writes) >= len(prompt) + n_max - 1
    van = _port_vanilla(pmain, st.cross_k, st.cross_v, padded, len(prompt),
                        st.n_len_org, p)
    _assert_same_stream(spec, van)


def _segments(st):
    return [(s.t0, s.t1, [t.id for t in s.tokens]) for s in st.segments]


def _full_params(max_tokens=12):
    p = pt.FullParams.default()
    p.temperature_inc = 0.0          # decisive: no sampling fallback
    p.no_timestamps = True           # random weights rarely sample a valid
    p.max_tokens = max_tokens        # timestamp pair: emission guaranteed
    p.print_progress = False
    return p


def test_full_with_draft_matches_multiwindow(models):
    """35 s (two windows, [PREV] + past as the second prompt): full() with
    a draft equals full() without; spec_stats counts one run, and a second
    full() on the same state gives the same counts."""
    _, _, pmain, pdraft = models
    rng = np.random.default_rng(9)
    audio = (0.1 * rng.standard_normal(16000 * 35)).astype(np.float32)
    p = _full_params(10)
    p.no_context = False
    st = pmain.create_state()
    st.full(p, audio)
    base = _segments(st)
    assert len(base) >= 2 and st.spec_stats is None
    pmain.attach_draft(pdraft)
    try:
        st2 = pmain.create_state()
        st2.full(p, audio)
        assert _segments(st2) == base
        assert st2.spec_stats["rounds"] >= 2
        # the counts of one run: a second identical run (no prompt carried
        # in from the first) on the same state gives the same counts
        p.no_context = True
        st2.full(p, audio)
        first = dict(st2.spec_stats)
        st2.full(p, audio)
        assert st2.spec_stats == first
    finally:
        pmain.draft = None


def test_full_draft_shares_encoder(models, jfk_like_audio):
    """draft_shares_encoder: no draft mel and no draft encoder; for a
    draft whose encoder is the main model's, the same stream as the
    non-shared path."""
    _, jdraft, pmain, _ = models
    draft = port_context(jdraft)
    draft.params = {**draft.params, "encoder": pmain.params["encoder"]}
    audio = jfk_like_audio[: 16000 * 3]

    def run(shares):
        pmain.cparams = dataclasses.replace(pmain.cparams, draft_shares_encoder=shares)
        pmain.attach_draft(draft)
        try:
            st = pmain.create_state()
            st.full(_full_params(16), audio)
        finally:
            pmain.draft = None
            pmain.cparams = dataclasses.replace(pmain.cparams, draft_shares_encoder=False)
        assert (st.draft_mel is None) == shares
        assert st.spec_stats is not None
        assert ("encode_draft" in st.get_timings())
        return _segments(st)

    assert run(True) == run(False)


def test_full_keep_quantized_draft_inherits(tmp_path, jfk_like_audio):
    """A keep_quantized Q5_0 main model loaded with draft_model (itself):
    the draft is int8-resident too, and full() equals the same model's
    full() without a draft."""
    hp = tiny_test_hparams()
    tensors = _make_test_tensors(hp, ttype=jquant.GGML_TYPE_Q5_0, seed=4)
    arr, tt = tensors["decoder.token_embedding.weight"]
    tensors["decoder.token_embedding.weight"] = (arr * 8.0, tt)
    path = tmp_path / "q5_0.bin"
    path.write_bytes(_checkpoint_bytes(jggml, hp, tensors))
    audio = jfk_like_audio[: 16000 * 3]
    cp = pt.ContextParams(use_gpu=False, dtype="float32", keep_quantized=True)

    ctx = pt.WhisperContext.new_with_params(str(path), cp)
    st = ctx.create_state()
    st.full(_full_params(16), audio)
    base = _segments(st)

    ctx_s = pt.WhisperContext.new_with_params(
        str(path), dataclasses.replace(cp, draft_model=str(path), spec_k=4))
    assert ctx_s.draft is not None
    assert "q" in ctx_s.draft.params["decoder"]["blocks"][0]["mlp_0"]
    st2 = ctx_s.create_state()
    st2.full(_full_params(16), audio)
    assert _segments(st2) == base and len(base) > 0
    assert st2.spec_stats["rounds"] >= 1


@pytest.mark.parametrize("request_kind", ["beam_search", "grammar"])
def test_no_speculation(models, jfk_like_audio, request_kind):
    """A beam-search request and a grammar request with a draft attached
    never speculate, and never pay the draft encoder."""
    from whisper_tpu_torch.decoding.grammar import parse_gbnf
    _, _, pmain, pdraft = models
    if request_kind == "beam_search":
        p = _full_params(6)
        p.strategy = pt.SamplingStrategy.BEAM_SEARCH
        p.beam_search.beam_size = 2
    else:
        p = _full_params(6)
        p.grammar_rules = parse_gbnf('root ::= [a-z ]*\n')
    pmain.attach_draft(pdraft)
    try:
        st = pmain.create_state()
        st.full(p, jfk_like_audio[: 16000 * 2])
    finally:
        pmain.draft = None
    assert st.spec_stats is None
    assert st.draft_mel is None and st.draft_cross_k is None


def test_attach_draft_refuses_mismatch(models):
    _, _, pmain, _ = models
    other = pt.WhisperContext.random(
        hp=dataclasses.replace(tiny_test_hparams(), n_vocab=51865 + 1),
        params=pt.ContextParams(use_gpu=False, dtype="float32"))
    with pytest.raises(InitError, match="vocab"):
        pmain.attach_draft(other)
    assert pmain.draft is None
