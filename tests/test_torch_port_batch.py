"""Continuous batching in the PyTorch port against the JAX package:
`decoder_forward` with per-row positions, `decode_windows_batch`,
`run_full_batch` (through WhisperContext.full_batch, with lane refill) and
WhisperState.full_parallel, on the same weights (params_from_jax) and the
same seeded inputs, in float32 on the CPU. Token streams and segments must
be equal under the decisive config (a suppress_regex that shrinks the
candidate set, no timestamps, max_tokens; tests/test_batch_full.py);
sampling is checked by structure and distribution only (the two PRNGs
never draw the same numbers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu as wt
import whisper_tpu_torch as pt
from whisper_tpu.checkpoint import init as jinit
from whisper_tpu.decoding import batch_loop as jbl
from whisper_tpu.decoding import device_loop as jdl
from whisper_tpu.decoding import filters as jf
from whisper_tpu.decoding.grammar import parse_gbnf as j_parse_gbnf
from whisper_tpu.models import vad as jvad
from whisper_tpu.models import whisper as jm
from whisper_tpu_torch.checkpoint.from_jax import params_from_jax
from whisper_tpu_torch.decoding import batch_loop as pbl
from whisper_tpu_torch.decoding import filters as pf
from whisper_tpu_torch.decoding.grammar import parse_gbnf as p_parse_gbnf
from whisper_tpu_torch.models import vad as pvad
from whisper_tpu_torch.models import whisper as pm

from test_torch_port_e2e import port_context
from test_torch_port_vad import safe_threshold, speech_like, spread_vad_model


@pytest.fixture(scope="module")
def contexts():
    jctx = wt.WhisperContext.random(
        hp=jinit.tiny_test_hparams(), params=wt.ContextParams(dtype="float32"), seed=3)
    return jctx, port_context(jctx)


@pytest.fixture(scope="module")
def audios():
    rng = np.random.default_rng(5)
    return [(0.1 * rng.standard_normal(16000 * 2)).astype(np.float32),
            (0.2 * rng.standard_normal(16000 * 4)).astype(np.float32),
            (0.05 * rng.standard_normal(16000 * 3)).astype(np.float32)]


def decisive(mod, beam=0):
    p = mod.FullParams.default(mod.SamplingStrategy.BEAM_SEARCH if beam
                               else mod.SamplingStrategy.GREEDY)
    p.beam_search.beam_size = max(beam, 1)
    p.greedy.best_of = 1
    p.print_progress = False
    p.temperature_inc = 0.0
    p.no_timestamps = True
    p.max_tokens = 12
    p.suppress_regex = r"<syn\d\d\d+>"
    return p


def seg_key(segs):
    return [(s.text, s.t0, s.t1, [t.id for t in s.tokens]) for s in segs]


def t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------ per-row decoder positions

@pytest.mark.parametrize("kv_int8", [False, True])
def test_decoder_per_row_positions(kv_int8):
    """A batched prompt pass at positions 0 with a different real length
    per row (garbage padding above it), then T=1 steps at per-row positions
    prompt_len[b] + i with a beam fork: logits within 3e-3 of the JAX
    package's merged path (float32; they agree to ~1e-5), and the cache
    rows equal (dense within 1e-4; int8 codes within one step of rounding
    where a float32 value lies at a midpoint, compared dequantized).

    With an int8 cache the merged path quantizes a step's own K/V rows
    before it attends to them (in both packages), so a code that one
    package rounds up and the other down at a float32 midpoint moves that
    row's logits by one code's worth (~3e-3 to 6e-3 in this model). A row
    whose codes equal the JAX package's everywhere is held to 3e-3; a row
    with such a code (at most one step of rounding apart) to 3e-2."""
    hp = jinit.tiny_test_hparams()
    jp = jax.tree_util.tree_map(jnp.asarray, jinit.random_params(hp, 2, "float32"))
    pp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), hp, "float32")
    rng = np.random.default_rng(4)
    enc = rng.standard_normal((3, hp.n_audio_ctx, hp.n_audio_state)).astype(np.float32)
    ck_j, cv_j = jm.cross_attention_kv(jp, hp, jnp.asarray(enc), quant=kv_int8)
    ck_p, cv_p = pm.cross_attention_kv(pp, hp, t(enc), quant=kv_int8)
    B, T = 3, 8
    plen = np.array([3, 8, 5])
    toks = rng.integers(0, hp.n_vocab, size=(B, T)).astype(np.int32)
    kv_j = jm.KVCache.zeros(hp, B, jnp.float32, quant=kv_int8)
    kv_p = pm.KVCache.zeros(hp, B, torch.float32, quant=kv_int8)
    lg_j, kv_j, _ = jm.decoder_forward(jp, hp, jnp.asarray(toks), jnp.zeros(B, jnp.int32), kv_j,
                                       ck_j, cv_j, jnp.float32,
                                       logit_rows=jnp.asarray(plen - 1, jnp.int32))
    lg_p, kv_p, _ = pm.decoder_forward(pp, hp, t(toks).long(), torch.zeros(B, dtype=torch.long),
                                       kv_p, ck_p, cv_p, torch.float32,
                                       logit_rows=t(plen - 1).long())
    def check_logits(lg_p, lg_j):
        err = np.abs(lg_p.numpy() - np.asarray(lg_j)).max(axis=(1, 2))     # per row
        same = np.ones(B, bool)
        if kv_int8:
            for c, jc in ((kv_p.k, kv_j.k), (kv_p.v, kv_j.v)):
                same &= (c.numpy() == np.asarray(jc)).all(axis=(0, 2, 3, 4))
        assert np.all(err[same] <= 3e-3) and np.all(err <= 3e-2), (err, same)
        return same

    strict = [check_logits(lg_p, lg_j)]
    for i, fork in enumerate([None, [2, 0, 0], None, [1, 1, 2]]):
        step = rng.integers(0, hp.n_vocab, size=(B, 1)).astype(np.int32)
        pos = plen + i
        lg_j, kv_j, _ = jm.decoder_forward(
            jp, hp, jnp.asarray(step), jnp.asarray(pos, jnp.int32), kv_j, ck_j, cv_j,
            jnp.float32, fork_src=None if fork is None else jnp.asarray(fork, jnp.int32))
        lg_p, kv_p, _ = pm.decoder_forward(
            pp, hp, t(step).long(), t(pos).long(), kv_p, ck_p, cv_p, torch.float32,
            fork_src=None if fork is None else torch.tensor(fork))
        assert lg_p.shape == (B, 1, hp.n_vocab)
        strict.append(check_logits(lg_p, lg_j))
    assert np.mean(strict) > 0.5            # most rows are held to 3e-3
    n = T + 4                    # every position written: prompt rows and steps
    if not kv_int8:
        for got, want in ((kv_p.k, kv_j.k), (kv_p.v, kv_j.v)):
            np.testing.assert_allclose(got[:, :, :, :n].numpy(), np.asarray(want)[:, :, :, :n],
                                       rtol=1e-4, atol=1e-4)
        return
    for codes, scales, jc, js in ((kv_p.k, kv_p.ks, kv_j.k, kv_j.ks),
                                  (kv_p.v, kv_p.vs, kv_j.v, kv_j.vs)):
        np.testing.assert_allclose(scales[:, :, :, :n].numpy(), np.asarray(js)[:, :, :, :n],
                                   rtol=1e-4, atol=1e-7)
        got = codes[:, :, :, :n].float() * scales[:, :, :, :n, None]
        want = np.asarray(jc)[:, :, :, :n].astype(np.float32) * np.asarray(js)[:, :, :, :n, None]
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1.01 * float(np.asarray(js).max()))
        assert (codes[:, :, :, :n].float() - t(np.asarray(jc)[:, :, :, :n]).float()
                ).abs().max() <= 1


# ------------------------------------------------------- decode_windows_batch

@pytest.fixture(scope="module")
def encoded(contexts, audios):
    """Each utterance's first window encoded by the JAX package, the cross
    K/V stacked along the batch axis (L, U, H, Ta, Dh)."""
    jctx = contexts[0]
    cks, cvs, n_len = [], [], []
    for a in audios:
        st = jctx.create_state()
        st.pcm_to_mel(a)
        st.encode(0)
        cks.append(np.asarray(st.cross_k))
        cvs.append(np.asarray(st.cross_v))
        n_len.append(st.n_len_org)
    return np.concatenate(cks, 1), np.concatenate(cvs, 1), np.array(n_len)


@pytest.mark.parametrize("strategy,n_utt", [(s, u) for s in ("greedy", "beam5")
                                            for u in (1, 2, 3)])
def test_decode_windows_batch_matches(contexts, encoded, strategy, n_utt):
    jctx, pctx = contexts
    hp, vocab = jctx.hparams, jctx.vocab
    beam = 5 if strategy == "beam5" else 0
    jconsts, tids = jf.build_filter_consts(vocab, hp, decisive(wt, beam))
    pconsts, ptids = pf.build_filter_consts(vocab, hp, decisive(pt, beam))
    assert tuple(ptids) == tuple(tids)
    ck, cv, n_len = (a[:, :n_utt] if a.ndim > 1 else a[:n_utt] for a in encoded)
    # prompts of different lengths per utterance, right-padded to 8
    prompts = np.zeros((n_utt, 8), np.int32)
    plens = np.array([2, 4, 3][:n_utt], np.int32)
    for u in range(n_utt):
        prompts[u, : plens[u]] = [vocab.token_sot, vocab.token_not, 300 + u, 400][: plens[u]]
    seek = np.zeros(n_utt, np.int32)
    strat = jdl.BEAM if beam else jdl.GREEDY_BEST
    K = pbl.rows_per_utt(strat, 5)
    assert K == jbl.rows_per_utt(strat, 5)
    kw = dict(n_utt=n_utt, n_per_utt=K if beam else 1, strategy=strat, max_tokens=10,
              no_timestamps=True)
    jr = jbl.decode_windows_batch(
        jctx.params, hp, jconsts, jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(prompts),
        jnp.asarray(plens), jnp.float32(0.0), jnp.asarray(seek), jnp.asarray(n_len, jnp.int32),
        jnp.ones(n_utt, bool), jax.random.PRNGKey(0), tids=tids, dtype=jnp.float32, **kw)
    jr = jax.tree_util.tree_map(np.asarray, jr)
    pr = pbl.decode_windows_batch(
        pctx.params, hp, pconsts, t(ck), t(cv), prompts, plens, 0.0, seek, n_len,
        np.ones(n_utt, bool), tids=ptids, dtype=torch.float32, **kw)
    n = int(jr.n_tokens)
    assert pr.n_tokens == n > 0
    assert pr.tokens.shape == jr.tokens.shape == (n_utt * (K if beam else 1), hp.n_text_ctx // 2 - 4)
    np.testing.assert_array_equal(pr.tokens[:, :n], jr.tokens[:, :n])
    for name in ("result_len", "seek_delta", "completed", "failed"):
        np.testing.assert_array_equal(getattr(pr, name), getattr(jr, name), err_msg=name)
    np.testing.assert_array_equal(pr.tok_tid[:, :n], jr.tok_tid[:, :n])
    np.testing.assert_allclose(pr.sum_logprobs_all, jr.sum_logprobs_all, rtol=0, atol=1e-4)
    np.testing.assert_allclose(pr.no_speech_prob, jr.no_speech_prob, rtol=1e-4, atol=1e-6)


def test_batch_sampling_structure_and_distribution(contexts, encoded):
    """SAMPLE at t = 1 over 64 rows of one utterance, one step: every draw
    is a token the filters allow, and the share of draws in the tokens
    holding the top half of the filtered probability mass matches that
    mass (the JAX package's filtered probabilities of the same prompt)."""
    jctx, pctx = contexts
    hp, vocab = jctx.hparams, jctx.vocab
    p = decisive(pt)
    p.max_tokens = 1
    pconsts, tids = pf.build_filter_consts(vocab, hp, p)
    jconsts, _ = jf.build_filter_consts(vocab, hp, decisive(wt))
    ck, cv = (t(a[:, :1]) for a in encoded[:2])
    prompt = np.array([[vocab.token_sot, vocab.token_not]], np.int32)
    rows, draws = 64, []
    for seed in range(6):
        gen = torch.Generator().manual_seed(seed)
        r = pbl.decode_windows_batch(
            pctx.params, hp, pconsts, ck, cv, prompt, np.array([2]), 1.0, np.zeros(1),
            np.array([encoded[2][0]]), np.ones(1, bool), gen, tids=tids, n_utt=1,
            n_per_utt=rows, strategy=pbl.SAMPLE, max_tokens=1, no_timestamps=True,
            dtype=torch.float32)
        assert r.tokens.shape[0] == rows and r.n_tokens >= 1
        draws.append(r.tokens[:, 0])
    draws = np.concatenate(draws)
    # the JAX package's filtered probabilities for the prompt's last row
    kv = jm.KVCache.zeros(hp, 1, jnp.float32)
    lg, _, _ = jm.decoder_forward(jctx.params, hp, jnp.asarray(prompt), jnp.zeros(1, jnp.int32),
                                  kv, jnp.asarray(encoded[0][:, :1]),
                                  jnp.asarray(encoded[1][:, :1]), jnp.float32,
                                  logit_rows=jnp.ones(1, jnp.int32))
    flags = {k: jnp.asarray(v) for k, v in dict(
        is_initial=np.ones(1, bool), last_was_ts=np.zeros(1, bool),
        penult_was_ts=np.ones(1, bool), has_ts=np.zeros(1, bool),
        seek_delta=np.full(1, 3000, np.int32)).items()}
    _, _, probs = jf.apply_filters(lg[:, 0], jconsts, tids, temperature=jnp.float32(1.0),
                                   **flags)
    probs = np.asarray(probs)[0]
    assert np.all(probs[draws] > 0)                    # never a suppressed token
    order = np.argsort(-probs)
    top = order[: int(np.searchsorted(np.cumsum(probs[order]), 0.5)) + 1]
    mass = probs[top].sum()
    share = np.isin(draws, top).mean()
    sigma = np.sqrt(mass * (1 - mass) / len(draws))
    assert abs(share - mass) < 4.5 * sigma, (share, mass)


# ----------------------------------------------------------- run_full_batch

def _batch_case(case, audios):
    """(params for a package module, batch audios, n_lanes) of each full_batch case."""
    speech = [speech_like(6, 1), np.zeros(2 * 16000, np.float32), speech_like(4, 2)]
    return {
        # 4 utterances through 2 lanes (refill), one too short to decode
        "greedy_refill_short": (lambda m: decisive(m), audios[:2] + [
            np.zeros(800, np.float32), audios[2]], 2),
        "beam5_refill": (lambda m: decisive(m, 5), audios, 2),
        # VAD in every utterance; the silent one is emptied and frees its lane
        "vad_refill_emptied": ("vad", speech, 2),
        "grammar_dfa": ("dfa", audios[:2], None),
        # callbacks and over-budget grammars run each utterance through run_full
        "grammar_over_budget": ("over_budget", audios[:2], None),
    }[case]


GBNF = 'root ::= ("the" | "ask" | [0-9]) (" " ("the"|"ask"|[0-9]))*\n'
RECURSIVE = 'root ::= "(" root ")" | [a-z ]*\n'


@pytest.fixture(scope="module")
def vad_file(tmp_path_factory):
    """A spread VAD model written by the port's writer, and a threshold
    picked from its probabilities on the speech-like audio."""
    path = str(tmp_path_factory.mktemp("vad") / "vad.bin")
    model = spread_vad_model()
    pvad.write_vad_ggml(path, model)
    probs = jvad.detect_speech(jvad.read_vad_ggml(path), speech_like(6, 1))
    thr = safe_threshold(probs, 90)
    assert thr > 0.5        # silence gives exactly 0.5: it is dropped
    return path, thr


def _params(mod, how, vad_file):
    if not isinstance(how, str):
        return how(mod)
    p = decisive(mod)
    if how == "vad":
        p.vad = True
        p.vad_model_path, p.vad_params.threshold = vad_file
    elif how in ("dfa", "over_budget"):
        parse = j_parse_gbnf if mod is wt else p_parse_gbnf
        p.grammar_rules = parse(GBNF if how == "dfa" else RECURSIVE, "root")
        p.grammar_penalty = 10000.0
        p.max_tokens = 4
    return p


@pytest.mark.parametrize("case", ["greedy_refill_short", "beam5_refill",
                                  "vad_refill_emptied", "grammar_dfa",
                                  "grammar_over_budget"])
def test_full_batch_matches(contexts, audios, vad_file, case):
    jctx, pctx = contexts
    how, batch, n_lanes = _batch_case(case, audios)
    js, ps = {}, {}
    want = jctx.full_batch(_params(wt, how, vad_file), batch, n_lanes=n_lanes, stats=js)
    got = pctx.full_batch(_params(pt, how, vad_file), batch, n_lanes=n_lanes, stats=ps)
    assert [seg_key(u) for u in got] == [seg_key(u) for u in want]
    assert len(got) == len(batch)
    assert ps == js
    if case == "greedy_refill_short":
        assert ps["admitted"] == 4 and ps["n_lanes"] == 2 and got[2] == []
        assert all(got[i] for i in (0, 1, 3))
    if case == "vad_refill_emptied":
        assert got[1] == [] and got[0] and got[2]
        assert ps["admitted"] == 3


def test_full_batch_one_lane_equals_full(contexts, audios):
    """n_lanes=1 runs the utterances one after another; each equals its
    own full()."""
    _, pctx = contexts
    stats = {}
    got = pctx.full_batch(decisive(pt), audios, n_lanes=1, stats=stats)
    assert stats["lane_occupancy"] == 1.0 and stats["rounds"] >= len(audios)
    for a, segs in zip(audios, got):
        st = pctx.create_state()
        st.full(decisive(pt), a)
        assert seg_key(segs) == seg_key(st.segments)


@pytest.mark.parametrize("vad", [False, True])
def test_full_parallel_matches(contexts, vad_file, vad):
    jctx, pctx = contexts
    audio = np.concatenate([speech_like(6, 1), np.zeros(16000, np.float32),
                            speech_like(5, 3)])
    jp, pp = decisive(wt), decisive(pt)
    jp.offset_ms = pp.offset_ms = 300
    if vad:
        for p in (jp, pp):
            p.vad = True
            p.vad_model_path, p.vad_params.threshold = vad_file
    seen = []
    pp.new_segment_callback = lambda ctx, st, seg: seen.append((seg.t0, seg.t1))
    js, ps = jctx.create_state(), pctx.create_state()
    assert js.full_parallel(jp, audio, 3) == 0
    assert ps.full_parallel(pp, audio, 3) == 0
    assert seg_key(ps.segments) == seg_key(js.segments)
    assert ps.full_lang_id() == js.full_lang_id()
    assert ps.full_n_segments() >= 2 and len(seen) == ps.full_n_segments()
    for a, b in zip(ps.segments, ps.segments[1:]):
        assert a.t1 <= b.t0 or vad           # the clamp, before the VAD remap
        assert b.t0 >= a.t0


def test_too_many_decoders_and_mesh_raise(contexts, audios):
    _, pctx = contexts
    p = decisive(pt, 5)
    p.beam_search.beam_size = 16
    with pytest.raises(ValueError, match="too many decoders"):
        pctx.full_batch(p, audios[:1])
    # a mesh is a DeviceMesh or a shape, and needs a process group
    # (tests/test_torch_port_parallel.py runs the ranks)
    with pytest.raises(TypeError, match="DeviceMesh"):
        pctx.full_batch(decisive(pt), audios[:1], mesh=object())
    with pytest.raises(ValueError, match="not initialized"):
        pctx.full_batch(decisive(pt), audios[:1], mesh=(1, 1))
    assert pctx.full_batch(decisive(pt), []) == []
