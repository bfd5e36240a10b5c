"""GBNF grammars and the logits callback in the PyTorch port against the JAX
package: the parser, the pushdown machine, the token-DFA tables, and
full() on both routes — the DFA inside the device loop, and the
host-stepped loop (decoding/host_loop.py) for a grammar over the DFA
budget or a logits_filter_callback.

Both packages run the grammar machine's vocab scan and accept in their
host C++ runtimes (the same source) when those are built, else on their
Python engines. The `no_native` tests hold the two Python engines against
each other (`get_lib` returns None in both packages for the test); the
`both_native` tests beside them hold the two runtimes' paths; the DFA
tables of the smaller grammars and the full() runs are compared as the
packages run by default. Either way, rejected sets, DFA tables, token ids
and timestamps must be exactly equal (float32, the decisive config)."""

import numpy as np
import pytest
import torch

import whisper_tpu as wt
import whisper_tpu_torch as pt
from whisper_tpu.checkpoint.init import tiny_test_hparams
from whisper_tpu.decoding import grammar as jg
from whisper_tpu.decoding import grammar_dfa as jdfa
from whisper_tpu.runtime import native
from whisper_tpu.tokenizer import synthetic_vocab as j_synthetic_vocab
from whisper_tpu_torch.decoding import device_loop, filters, host_loop
from whisper_tpu_torch.decoding import grammar as pg
from whisper_tpu_torch.decoding import grammar_dfa as pdfa
from whisper_tpu_torch.runtime import native as pnative
from whisper_tpu_torch.tokenizer import synthetic_vocab as p_synthetic_vocab

from test_torch_port_e2e import port_context

GBNF = """\
root ::= item (ws item)*
ws   ::= " "
item ::= word | num
word ::= "the" | "and" | "ask" | "é"
num  ::= [0-9] [0-9]?
"""
RECURSIVE = 'root ::= "(" root ")" | [a-z ]*\n'

GRAMMARS = [
    GBNF,
    RECURSIVE,
    'root ::= "é"\n',
    'root ::= [^a-z]+ | ("x" | "yz")? [\\x41-\\x43] "\\n"\n',
    '# a comment\nroot ::= a b*\na ::= "\\u00e9" | [0-9a-fA-F]\nb ::= ( "q" a )+\n',
    'root ::= "the" ( " " word )* \nword ::= [a-z]+ | "日本"\n',
]


@pytest.fixture
def no_native(monkeypatch):
    """Both packages on their Python grammar engines."""
    monkeypatch.setattr(native, "get_lib", lambda: None)
    monkeypatch.setattr(pnative, "get_lib", lambda: None)


@pytest.fixture
def both_native():
    """Both packages on their host runtimes (skips where one did not build)."""
    if not (native.available() and pnative.available()):
        pytest.skip("a host C++ runtime did not build (no g++?)")


@pytest.fixture(scope="module")
def vocabs():
    return j_synthetic_vocab(51864), p_synthetic_vocab(51864)


@pytest.mark.parametrize("text", GRAMMARS)
def test_parse_gbnf_matches(text):
    j, p = jg.parse_gbnf(text), pg.parse_gbnf(text)
    assert p.rules == j.rules and p.start_rule == j.start_rule
    assert p.instance().stacks == j.instance().stacks


@pytest.mark.parametrize("text,err", [("root ::= foo\n", "undefined"),
                                      ("root = \"a\"\n", "::="),
                                      ('other ::= "a"\n', "start rule"),
                                      ("root ::= * \"a\"\n", "preceding")])
def test_parse_errors_match(text, err):
    for mod in (jg, pg):
        with pytest.raises(mod.GbnfError, match=err):
            mod.parse_gbnf(text)


def test_decode_utf8_matches():
    samples = [b"abc", "é日本".encode(), b"\xc3", b"\xa9x", b"\xe6\x97", b"\xff", b"",
               "😀".encode()[:3], b"\x80\x80"]
    partials = [(0, 0), (0x3, 1), (0x6, 2), (0x1, 1), (0, -1)]
    for data in samples:
        for value, n_remain in partials:
            cj, rj = jg.decode_utf8(data, jg.PartialUtf8(value, n_remain))
            cp, rp = pg.decode_utf8(data, pg.PartialUtf8(value, n_remain))
            assert cp == cj and (rp.value, rp.n_remain) == (rj.value, rj.n_remain)


def _random_walks(vocabs):
    """Along seeded random walks (mostly allowed tokens, sometimes any
    token, as a soft penalty allows), the rejected sets and the accepted
    states of the two machines stay equal."""
    jv, pv = vocabs
    rng = np.random.default_rng(5)
    for text in (GBNF, RECURSIVE):
        for _walk in range(2):
            gj, gp = jg.parse_gbnf(text).instance(), pg.parse_gbnf(text).instance()
            for _step in range(4):
                rej = gp.rejected_tokens(pv)
                assert sorted(rej) == sorted(gj.rejected_tokens(jv))
                allowed = np.setdiff1d(np.arange(pv.token_eot), rej)
                pool = allowed if len(allowed) and rng.random() < 0.7 else np.arange(pv.token_eot)
                tok = int(rng.choice(pool))
                gj.accept_token(jv, tok)
                gp.accept_token(pv, tok)
                assert gp.stacks == gj.stacks
                assert (gp.partial_utf8.value, gp.partial_utf8.n_remain) == \
                    (gj.partial_utf8.value, gj.partial_utf8.n_remain)
            copy = gp.copy()
            copy.accept_token(pv, ord("("))
            assert gp.stacks == gj.stacks        # a copy never touches its source


def test_random_walk_rejects_and_accepts(no_native, vocabs):
    _random_walks(vocabs)


def test_random_walk_rejects_and_accepts_native(both_native, vocabs):
    _random_walks(vocabs)


def _dfa_tables_bit_equal(vocabs):
    jv, pv = vocabs
    dj = jdfa.compile_token_dfa(jg.parse_gbnf(GBNF), jv)
    dp = pdfa.compile_token_dfa(pg.parse_gbnf(GBNF), pv)
    assert dp.n_states == dj.n_states and dp.start == dj.start == 0
    assert dp.reject.dtype == dj.reject.dtype and dp.trans.dtype == dj.trans.dtype
    np.testing.assert_array_equal(dp.reject, dj.reject)
    np.testing.assert_array_equal(dp.trans, dj.trans)


def test_dfa_tables_bit_equal_python_engine(no_native, vocabs):
    _dfa_tables_bit_equal(vocabs)


def test_dfa_tables_bit_equal_native(both_native, vocabs):
    _dfa_tables_bit_equal(vocabs)


@pytest.mark.parametrize("text", [GRAMMARS[2], GRAMMARS[3], GRAMMARS[5]])
def test_dfa_tables_bit_equal(vocabs, text):
    jv, pv = vocabs
    dj = jdfa.compile_token_dfa(jg.parse_gbnf(text), jv, max_states=256)
    dp = pdfa.compile_token_dfa(pg.parse_gbnf(text), pv, max_states=256)
    assert (dp is None) == (dj is None)
    if dp is not None:
        assert dp.n_states == dj.n_states
        np.testing.assert_array_equal(dp.reject, dj.reject)
        np.testing.assert_array_equal(dp.trans, dj.trans)


def test_over_budget_grammar_returns_none(vocabs):
    jv, pv = vocabs
    assert jdfa.compile_token_dfa(jg.parse_gbnf(RECURSIVE), jv, max_states=64) is None
    assert pdfa.compile_token_dfa(pg.parse_gbnf(RECURSIVE), pv, max_states=64) is None
    parsed = pg.parse_gbnf(RECURSIVE)
    assert pdfa.cached_dfa(parsed, pv) is None          # the default budget too
    parsed = pg.parse_gbnf(GRAMMARS[2])
    d1 = pdfa.cached_dfa(parsed, pv)
    assert d1 is not None and pdfa.cached_dfa(parsed, pv) is d1
    rej, trans = d1.device_tables("cpu")
    assert rej.dtype == torch.bool and trans.dtype == torch.long
    assert d1.device_tables("cpu")[0] is rej              # uploaded once


# ---------------------------------------------------------------- full()

@pytest.fixture(scope="module")
def contexts():
    jctx = wt.WhisperContext.random(
        hp=tiny_test_hparams(), params=wt.ContextParams(dtype="float32"), seed=0)
    return jctx, port_context(jctx)


@pytest.fixture(scope="module")
def parsed():
    """Parsed once per module, so each package compiles its DFA once."""
    return ({t: jg.parse_gbnf(t) for t in (GBNF, RECURSIVE)},
            {t: pg.parse_gbnf(t) for t in (GBNF, RECURSIVE)})


def audio(seconds=2.0, seed=42):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.7 * t)
    sig = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in range(1, 6))
    sig = sig * 0.5 * (1 + np.sin(2 * np.pi * 2.3 * t)) + 0.01 * rng.standard_normal(t.shape)
    return (0.3 * sig / np.abs(sig).max()).astype(np.float32)


def grammar_params(mod, strategy, rules, penalty, timestamps=False):
    p = mod.FullParams.default(getattr(mod.SamplingStrategy, strategy))
    p.no_timestamps = not timestamps
    p.max_tokens = 10
    p.temperature_inc = 0.0
    p.entropy_thold = -1e9
    p.logprob_thold = -1e9
    p.no_speech_thold = 1e9
    p.print_progress = False
    p.grammar_rules = rules
    p.grammar_penalty = penalty
    p.beam_search.beam_size = 3
    p.greedy.best_of = 3
    return p


def segs(st):
    return [(s.text, s.t0, s.t1, [t.id for t in s.tokens]) for s in st.segments]


@pytest.mark.parametrize("strategy,penalty,timestamps", [
    ("GREEDY", 10000.0, False), ("BEAM_SEARCH", 10000.0, False),
    ("GREEDY", 0.5, False), ("GREEDY", 100.0, True)],
    ids=["greedy", "beam", "soft-penalty", "timestamps"])
def test_full_grammar_dfa_route_matches(contexts, parsed, strategy, penalty, timestamps):
    jctx, pctx = contexts
    jr, pr = parsed[0][GBNF], parsed[1][GBNF]
    assert pdfa.cached_dfa(pr, pctx.vocab) is not None      # the DFA route
    js, ps = jctx.create_state(), pctx.create_state()
    js.full(grammar_params(wt, strategy, jr, penalty, timestamps), audio())
    ps.full(grammar_params(pt, strategy, pr, penalty, timestamps), audio())
    assert segs(ps) == segs(js) and segs(ps)


@pytest.mark.parametrize("strategy", ["GREEDY", "BEAM_SEARCH"])
def test_full_grammar_host_route_matches(contexts, parsed, strategy):
    """A grammar over the DFA budget runs the host loop in both packages."""
    jctx, pctx = contexts
    jr, pr = parsed[0][RECURSIVE], parsed[1][RECURSIVE]
    assert pdfa.cached_dfa(pr, pctx.vocab) is None          # the host route
    js, ps = jctx.create_state(), pctx.create_state()
    js.full(grammar_params(wt, strategy, jr, 100.0), audio())
    ps.full(grammar_params(pt, strategy, pr, 100.0), audio())
    assert segs(ps) == segs(js) and segs(ps)
    for s in ps.segments:                  # the penalty kept the text in the grammar
        for td in s.tokens:
            if td.id < pctx.token_eot():
                assert all(c.islower() or c in " ()" for c in pctx.token_to_str(td.id))


@pytest.mark.parametrize("strategy", ["GREEDY", "BEAM_SEARCH"])
def test_logits_filter_callback_matches(contexts, strategy):
    """The callback sees the same calls with the same argument types in
    both packages (context, state, the decoder's tokens so far, its raw
    float32 logits), and the host loop decodes the same segments."""
    jctx, pctx = contexts
    seen = {"jax": [], "port": []}

    def recorder(name, ctx_want):
        def cb(ctx, state, tokens, logits):
            assert ctx is ctx_want and isinstance(tokens, list)
            assert isinstance(logits, np.ndarray) and logits.dtype == np.float32
            assert logits.shape == (ctx.n_vocab(),)
            seen[name].append((tuple(tokens), int(np.argmax(logits))))
        return cb

    js, ps = jctx.create_state(), pctx.create_state()
    pj = grammar_params(wt, strategy, None, 100.0, timestamps=True)
    pp = grammar_params(pt, strategy, None, 100.0, timestamps=True)
    pj.logits_filter_callback = recorder("jax", jctx)
    pp.logits_filter_callback = recorder("port", pctx)
    js.full(pj, audio(3.0, 7))
    ps.full(pp, audio(3.0, 7))
    assert segs(ps) == segs(js) and segs(ps)
    assert seen["port"] == seen["jax"] and seen["port"]


def test_logits_filter_callback_edits_logits(contexts):
    """The port's callback gets a writable copy of the raw logits and the
    edit takes effect, as in the reference (:6224-6226): forcing one text
    token makes greedy emit it at every step."""
    _, pctx = contexts
    forced = 300

    def force(ctx, state, tokens, logits):
        logits[forced] = 1e4

    p = grammar_params(pt, "GREEDY", None, 100.0)
    p.logits_filter_callback = force
    st = pctx.create_state()
    st.full(p, audio())
    ids = [t.id for s in st.segments for t in s.tokens]
    assert ids and all(i == forced for i in ids)


def test_host_loop_matches_device_loop_greedy(contexts):
    """The port's host-stepped loop against its device loop on one window,
    greedy, exactly equal (sharpened embeddings: decisive argmaxes)."""
    ctx = port_context(contexts[0])          # its own copy: the embedding changes
    dec = dict(ctx.params["decoder"])
    dec["token_embed"] = dec["token_embed"] * 8.0
    ctx.params = {**ctx.params, "decoder": dec}
    hp, vocab = ctx.hparams, ctx.vocab
    params = pt.FullParams.default()
    consts, tids = filters.build_filter_consts(vocab, hp, params)
    st = ctx.create_state()
    st.pcm_to_mel(audio(3.0, 1))
    st.encode(0)
    prompt = [vocab.token_sot]
    host = host_loop.decode_window_host(st, params, consts, tids, prompt, 0.0, 0,
                                        st.n_len_org, 1, device_loop.GREEDY_BEST)
    pp = np.zeros(8, np.int32)
    pp[:1] = prompt
    dev = device_loop.decode_window(ctx.params, hp, consts, st.cross_k, st.cross_v, pp, 1,
                                    0.0, 0, st.n_len_org, tids=tids, n_dec=1,
                                    strategy=device_loop.GREEDY_BEST, dtype=ctx.dtype)
    n = host.n_tokens
    assert dev.n_tokens == n > 1
    np.testing.assert_array_equal(dev.tokens[0, :n], host.tokens[0, :n])
    for name in ("result_len", "seek_delta", "completed", "failed"):
        np.testing.assert_array_equal(getattr(dev, name), getattr(host, name))
    np.testing.assert_array_equal(dev.tok_tid[0, :n], host.tok_tid[0, :n])
    np.testing.assert_allclose(dev.tok_plog[0, :n], host.tok_plog[0, :n], rtol=0, atol=1e-5)
    assert abs(dev.no_speech_prob - host.no_speech_prob) < 1e-6
