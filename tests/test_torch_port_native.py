"""The port's host C++ runtime (csrc/runtime.cpp through runtime/native.py).

It builds with g++ through ops/build.py into _build/; each of its paths
must give what the port's Python path gives, bit for bit (block
dequantization in every format, the DTW path, the grammar engine's
rejected sets and accepted stacks along random walks), and what the JAX
package's runtime gives for the same inputs (the same source). The
signal energy is the one exception: the runtime sums |x| in float64
prefix sums and numpy convolves in float32, so the two differ in the
last bits (measured <= 2.4e-7 on values below 1); the runtime's energy
equals the JAX package's runtime's bit for bit. When a build fails, the
failure is logged once and the consumers take their Python paths.

Every test here skips when the port's runtime does not build (no g++),
as tests/test_native_runtime.py skips the JAX package's."""

import logging

import numpy as np
import pytest

from whisper_tpu.checkpoint import quant as jquant
from whisper_tpu.decoding import grammar as jg
from whisper_tpu.runtime import native as jnative
from whisper_tpu.tokenizer import synthetic_vocab as j_synthetic_vocab
from whisper_tpu_torch.checkpoint import quant as pquant
from whisper_tpu_torch.decoding import dtw as pdtw
from whisper_tpu_torch.decoding import grammar as pg
from whisper_tpu_torch.decoding import timestamps as pts
from whisper_tpu_torch.ops import build
from whisper_tpu_torch.runtime import native
from whisper_tpu_torch.tokenizer import synthetic_vocab as p_synthetic_vocab

FORMATS = [jquant.GGML_TYPE_F16, jquant.GGML_TYPE_Q4_0, jquant.GGML_TYPE_Q4_1,
           jquant.GGML_TYPE_Q5_0, jquant.GGML_TYPE_Q5_1, jquant.GGML_TYPE_Q8_0,
           *jquant.K_QUANT_TYPES]
GBNF = """\
root ::= item (ws item)*
ws   ::= " "
item ::= word | num | uni
word ::= "the" | "and" | "ask"
num  ::= [0-9] [0-9]?
uni  ::= "é" [a-z]*
"""


@pytest.fixture(scope="module", autouse=True)
def runtime():
    if not native.available():
        pytest.skip("the port's host runtime did not build (no g++?)")


def python_path(monkeypatch, fn, *args):
    """fn(*args) with the port's runtime switched off."""
    with monkeypatch.context() as m:
        m.setattr(native, "get_lib", lambda: None)
        return fn(*args)


def test_library_built_into_build_dir():
    path = build.library_path("runtime")
    assert path.exists() and path.parent == build.BUILD_DIR
    assert native.get_lib().wtpu_version() == 1


def test_failed_build_logs_once_and_falls_back(monkeypatch, caplog):
    def fail(name):
        raise RuntimeError("g++ failed for csrc/runtime.cpp:\nerror: simulated")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(build, "load", fail)
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert not native.available()
        assert native.dtw(np.ones((2, 3), np.float32)) is None
    assert len(caplog.records) == 1 and "simulated" in caplog.text
    x = np.random.default_rng(0).standard_normal((6, 9))
    path = pdtw.dtw_path(x)                      # the Python path serves
    assert path[0][-1] == 5 and path[1][-1] == 8


@pytest.mark.parametrize("ttype", FORMATS)
def test_dequantize_bit_equal(monkeypatch, ttype):
    """2**16 elements: the size from which quant.dequantize takes the
    runtime; against the port's numpy path and the JAX package's runtime."""
    x = (np.random.default_rng(ttype).standard_normal(1 << 16) * 0.3).astype(np.float32)
    raw = (x.astype(np.float16).tobytes() if ttype == jquant.GGML_TYPE_F16
           else pquant.quantize(x, ttype))
    got = pquant.dequantize(raw, ttype, x.size)
    want = python_path(monkeypatch, pquant.dequantize, raw, ttype, x.size)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    if jnative.available():
        assert got.tobytes() == jnative.dequantize(ttype, raw, x.size).tobytes()
    assert native.dequantize(ttype, raw[:-1], x.size) is None    # a short buffer


@pytest.mark.parametrize("n,m", [(1, 1), (5, 5), (7, 40), (30, 12), (40, 85), (200, 750)])
def test_dtw_bit_equal(monkeypatch, n, m):
    x = np.random.default_rng(n * m).standard_normal((n, m)).astype(np.float32)
    got = pdtw.dtw_path(x)
    want = python_path(monkeypatch, pdtw.dtw_path, x.astype(np.float64))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if jnative.available():
        for a, b in zip(got, jnative.dtw(x)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hw", [1, 32, 2000])
def test_signal_energy(monkeypatch, hw):
    x = np.random.default_rng(hw).standard_normal(16000 * 2 + 17).astype(np.float32)
    got = pts.get_signal_energy(x, hw)
    want = python_path(monkeypatch, pts.get_signal_energy, x, hw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if jnative.available():
        assert got.tobytes() == jnative.signal_energy(x, hw).tobytes()


def test_grammar_random_walk(monkeypatch):
    """Along seeded random walks the runtime's rejected sets and accepted
    states equal the port's Python machine's (stacks compared as sets: the
    two order them differently) and the JAX package's runtime's (in
    order)."""
    pv, jv = p_synthetic_vocab(51864), j_synthetic_vocab(51864)
    rng = np.random.default_rng(5)
    for _walk in range(2):
        g_nat, g_py = pg.parse_gbnf(GBNF).instance(), pg.parse_gbnf(GBNF).instance()
        g_jax = jg.parse_gbnf(GBNF).instance()
        for _step in range(5):
            rej = g_nat.rejected_tokens(pv)
            assert rej == sorted(python_path(monkeypatch, g_py.rejected_tokens, pv))
            if jnative.available():
                assert rej == sorted(g_jax.rejected_tokens(jv))
            allowed = np.setdiff1d(np.arange(pv.token_eot), rej)
            pool = allowed if len(allowed) and rng.random() < 0.7 else np.arange(pv.token_eot)
            tok = int(rng.choice(pool))
            g_nat.accept_token(pv, tok)
            python_path(monkeypatch, g_py.accept_token, pv, tok)
            assert set(g_nat.stacks) == set(g_py.stacks)
            assert (g_nat.partial_utf8.value, g_nat.partial_utf8.n_remain) == \
                (g_py.partial_utf8.value, g_py.partial_utf8.n_remain)
            if jnative.available():
                g_jax.accept_token(jv, tok)
                assert g_nat.stacks == g_jax.stacks
