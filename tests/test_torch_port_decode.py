"""The port's decode window and its parts against the JAX package's: the
logit filters, the state machine, the beam cursor, `decode_window` for
greedy and beam search under the decisive config
(tests/test_beam_parity.py:18-32), and the sampler by distribution (the
two PRNGs never draw the same numbers). Float32 on the CPU, same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu as wt
import whisper_tpu_torch.config as pcfg
from whisper_tpu.checkpoint.init import tiny_test_hparams
from whisper_tpu.decoding import device_loop as jdl
from whisper_tpu.decoding import filters as jf
from whisper_tpu.decoding import state_machine as jsm
from whisper_tpu_torch.checkpoint.from_jax import params_from_jax
from whisper_tpu_torch.decoding import device_loop as pdl
from whisper_tpu_torch.decoding import filters as pf
from whisper_tpu_torch.decoding import state_machine as psm


def decisive(mod, strategy, beam=3):
    p = mod.FullParams.default(strategy)
    p.beam_search.beam_size = beam
    p.print_progress = False
    p.no_timestamps = True
    p.max_tokens = 10
    p.suppress_regex = r"<syn\d\d\d+>"
    return p


@pytest.fixture(scope="module")
def setup():
    ctx = wt.WhisperContext.random(
        hp=tiny_test_hparams(), params=wt.ContextParams(dtype="float32"), seed=7)
    rng = np.random.default_rng(42)
    t = np.arange(3 * 16000) / 16000
    audio = (0.3 * np.sin(2 * np.pi * 150 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 2 * t))
             + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)
    st = ctx.create_state()
    st.pcm_to_mel(audio[: 16000 * 2])
    st.encode(0)
    pparams = params_from_jax(jax.tree_util.tree_map(np.asarray, ctx.params),
                              ctx.hparams, "float32")
    return ctx, st, pparams


@pytest.mark.parametrize("strategy,beam", [("GREEDY", 1), ("BEAM_SEARCH", 3),
                                           ("BEAM_SEARCH", 5)])
def test_decode_window_matches(setup, strategy, beam):
    ctx, st, pparams = setup
    hp, vocab = ctx.hparams, ctx.vocab
    jp = decisive(wt, getattr(wt.SamplingStrategy, strategy), beam)
    pp = decisive(pcfg, getattr(pcfg.SamplingStrategy, strategy), beam)
    jconsts, tids = jf.build_filter_consts(vocab, hp, jp)
    pconsts, ptids = pf.build_filter_consts(vocab, hp, pp)
    assert tuple(ptids) == tuple(tids)
    np.testing.assert_array_equal(pconsts.suppress_always.numpy(),
                                  np.asarray(jconsts.suppress_always))
    np.testing.assert_array_equal(pconsts.suppress_initial.numpy(),
                                  np.asarray(jconsts.suppress_initial))
    strat = jdl.GREEDY_BEST if strategy == "GREEDY" else jdl.BEAM
    prompt = np.zeros(8, np.int32)
    prompt[:2] = [vocab.token_sot, vocab.token_not]
    seek, seek_end = 0, st.n_len_org
    jr = jdl.decode_window(
        ctx.params, hp, jconsts, st.cross_k, st.cross_v, jnp.asarray(prompt),
        jnp.int32(2), jnp.float32(0.0), jnp.int32(seek), jnp.int32(seek_end),
        jax.random.PRNGKey(0), tids=tids, n_dec=beam, strategy=strat,
        beam_size=beam, max_tokens=10, no_timestamps=True, dtype=jnp.float32)
    jr = jax.tree_util.tree_map(np.asarray, jr)
    pr = pdl.decode_window(
        pparams, hp, pconsts, torch.from_numpy(np.array(st.cross_k)),
        torch.from_numpy(np.array(st.cross_v)), prompt, 2, 0.0, seek, seek_end,
        tids=ptids, n_dec=beam, strategy=strat, beam_size=beam, max_tokens=10,
        no_timestamps=True, dtype=torch.float32)
    n = int(jr.n_tokens)
    assert pr.n_tokens == n > 0
    np.testing.assert_array_equal(pr.tokens[:, :n], jr.tokens[:, :n])
    for name in ("result_len", "seek_delta", "completed", "failed"):
        np.testing.assert_array_equal(getattr(pr, name), getattr(jr, name), err_msg=name)
    np.testing.assert_allclose(pr.sum_logprobs_all, jr.sum_logprobs_all, rtol=0, atol=1e-4)
    np.testing.assert_allclose(pr.no_speech_prob, jr.no_speech_prob, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(pr.tok_tid[:, :n], jr.tok_tid[:, :n])


def _filter_inputs(B, V, beg, seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    return dict(
        logits=logits,
        is_initial=rng.random(B) < 0.3, last_was_ts=rng.random(B) < 0.5,
        penult_was_ts=rng.random(B) < 0.5, has_ts=rng.random(B) < 0.5,
        seek_delta=rng.integers(0, 3000, B).astype(np.int32))


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_filters_and_timestamp_stats_match(setup, temperature):
    ctx = setup[0]
    hp, vocab = ctx.hparams, ctx.vocab
    p = wt.FullParams.default()
    p.suppress_nst = True
    jconsts, tids = jf.build_filter_consts(vocab, hp, p)
    pconsts, _ = pf.build_filter_consts(vocab, hp, p)
    inp = _filter_inputs(6, tids.n_vocab, tids.beg, seed=int(temperature * 10))
    # make the timestamp rule fire on some rows
    inp["logits"][:2, tids.beg:] += 12.0
    flags = {k: inp[k] for k in ("is_initial", "last_was_ts", "penult_was_ts",
                                 "has_ts", "seek_delta")}
    j = jf.apply_filters(jnp.asarray(inp["logits"]), jconsts, tids,
                         temperature=jnp.float32(temperature),
                         **{k: jnp.asarray(v) for k, v in flags.items()})
    pres = pf.apply_filters(torch.from_numpy(inp["logits"]), pconsts, tids,
                            temperature=temperature,
                            **{k: torch.from_numpy(v) for k, v in flags.items()})
    for got, want in zip(pres, j):
        want = np.asarray(want)
        np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    for default_tid in (0, tids.beg):
        jst = jf.timestamp_stats(j[2], tids, default_tid=default_tid)
        pst = pf.timestamp_stats(pres[2], tids, default_tid=default_tid)
        np.testing.assert_allclose(pst[0].numpy(), np.asarray(jst[0]), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(pst[1].numpy(), np.asarray(jst[1]), rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(pst[2].numpy(), np.asarray(jst[2]))


def test_state_machine_matches():
    tids = jf.TokenIds(eot=50256, beg=50363, nosp=50361, n_vocab=51864)
    rng = np.random.default_rng(3)
    B = 64
    for s in (0, 5, 219):
        tok = np.where(rng.random(B) < 0.5, rng.integers(50363, 51864, B),
                       rng.choice([50256, 17, 300], B)).astype(np.int32)
        args = (tok, s, rng.random(B) < 0.8, rng.random(B) < 0.5,
                rng.integers(0, 3000, B).astype(np.int32),
                rng.integers(0, 6, B).astype(np.int32),
                rng.random(B) < 0.1, rng.random(B) < 0.1, 100, 2900, tids)
        for kw in (dict(max_tokens=0, single_segment=False, no_timestamps=False),
                   dict(max_tokens=4, single_segment=True, no_timestamps=False),
                   dict(max_tokens=0, single_segment=False, no_timestamps=True)):
            want = jsm.advance(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                 for a in args], n_max=220, **kw)
            got = psm.advance(*args, n_max=220, **kw)
            for name in want._fields:
                np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                              np.asarray(getattr(want, name)),
                                              err_msg=f"{name} s={s} {kw}")


@pytest.mark.parametrize("case", range(4))
def test_beam_select_matches(case):
    """Top-k with ties to the lower id, the live-first score sort, the
    duplicate skip and the wrap, on rows full of ties and -inf."""
    rng = np.random.default_rng(case)
    B, k, V = 5, 5, 300
    lp = np.round(rng.standard_normal((B, V)), 1).astype(np.float32) - 8
    lp[:, rng.random(V) < 0.9] = -np.inf               # mostly suppressed rows
    if case == 1:
        lp[1] = lp[0]                                    # duplicate beams
    live = rng.random(B) < 0.8
    live[0] = True
    sum_lp = np.round(rng.standard_normal(B), 1).astype(np.float32)
    prefix_hash = rng.integers(0, 2 ** 32, B, dtype=np.uint64).astype(np.uint32)
    if case == 1:
        prefix_hash[1] = prefix_hash[0]
        sum_lp[1] = sum_lp[0]
    last = rng.integers(0, V, B).astype(np.int32)
    for i in (0, 3):
        j_src, j_tok = jdl.beam_select(jnp.asarray(lp), jnp.asarray(live),
                                       jnp.asarray(sum_lp), jnp.asarray(prefix_hash),
                                       jnp.asarray(last), jnp.int32(i), k)
        top_id = pdl.beam_candidates(torch.from_numpy(lp), k).numpy()
        top_lp = np.take_along_axis(lp, top_id, 1)
        src, tok, cand = pdl.beam_select(top_lp, top_id, live, sum_lp,
                                         prefix_hash, last, i)
        np.testing.assert_array_equal(src, np.asarray(j_src))
        np.testing.assert_array_equal(tok, np.asarray(j_tok))
        assert all(top_id[src[b], cand[b]] == tok[b] for b in range(B) if live[b])


def test_sampler_frequencies_match_probs(setup):
    """Gumbel-max draws at t = 1 from fixed filtered logits: token
    frequencies over many seeded draws match the JAX package's filtered
    probabilities, and suppressed tokens are never drawn."""
    ctx = setup[0]
    hp, vocab = ctx.hparams, ctx.vocab
    p = wt.FullParams.default()
    jconsts, tids = jf.build_filter_consts(vocab, hp, p)
    pconsts, _ = pf.build_filter_consts(vocab, hp, p)
    logits = np.full((1, tids.n_vocab), -30.0, np.float32)
    favoured = [11, 400, 2000, 7000, 30000]
    logits[0, favoured] = [2.0, 1.5, 1.0, 0.2, -0.5]
    logits[0, vocab.token_sot] = 50.0                    # suppressed (rule 3)
    flags = dict(is_initial=np.zeros(1, bool), last_was_ts=np.zeros(1, bool),
                 penult_was_ts=np.ones(1, bool), has_ts=np.zeros(1, bool),
                 seek_delta=np.zeros(1, np.int32))
    _, _, probs_j = jf.apply_filters(jnp.asarray(logits), jconsts, tids,
                                     temperature=jnp.float32(1.0),
                                     **{k: jnp.asarray(v) for k, v in flags.items()})
    probs_j = np.asarray(probs_j)[0]
    _, logprobs, _ = pf.apply_filters(torch.from_numpy(logits), pconsts, tids,
                                      temperature=1.0,
                                      **{k: torch.from_numpy(v) for k, v in flags.items()})
    gen = torch.Generator().manual_seed(1234)
    n_per, rounds = 500, 8
    draws = np.concatenate([
        pdl.sample_gumbel_max(logprobs.expand(n_per, -1),
                              pdl.gumbel((n_per, tids.n_vocab), gen, "cpu")).numpy()
        for _ in range(rounds)])
    n = n_per * rounds
    assert np.all(probs_j[draws] > 0)                    # never a suppressed token
    for tok in favoured:
        want = probs_j[tok]
        sigma = np.sqrt(want * (1 - want) / n)
        assert abs(np.mean(draws == tok) - want) < 4.5 * sigma + 1e-3, tok
