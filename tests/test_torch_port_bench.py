"""The port's benchmark harness (tools/bench.py) and its table
(tools/bench_all.py) on the CPU, against the root bench.py and the JAX
package's bench_all: the tables and the analytic model at every preset,
the chains the harness times against the same chains in JAX (float32, the
weights carried across with params_from_jax), the capacity search over a
fake cell, the table's parse, and the command line at the tests' micro
model."""

import importlib.util
import json
import math
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.checkpoint import init as jinit
from whisper_tpu.models import whisper as jm
from whisper_tpu.tools import bench_all as jbench_all
from whisper_tpu_torch.audio import mel as pmel
from whisper_tpu_torch.checkpoint.from_jax import params_from_jax
from whisper_tpu_torch.checkpoint.init import tiny_test_hparams
from whisper_tpu_torch.config import PRESET_HPARAMS
from whisper_tpu_torch.errors import InitError
from whisper_tpu_torch.models import whisper as pm
from whisper_tpu_torch.ops.flash_attention import flash_attention
from whisper_tpu_torch.tools import bench, bench_all

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL_ENC = 2e-3      # tests/test_torch_parity.py: the encoder against HF, f32
TOL_LOGITS = 3e-3   # and the logits


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _root_bench():
    spec = importlib.util.spec_from_file_location("bench_for_port_bench_tests",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def root_bench():
    return _root_bench()


# ------------------------------------------------------- tables and the model


def test_tables_are_bench_py_s(root_bench):
    assert bench.PRESET_DIMS == root_bench.PRESET_DIMS
    assert bench.V100_MS == root_bench.V100_MS
    assert bench.BASELINE_RTF == root_bench.BASELINE_RTF
    assert bench.N_TOK == root_bench.N_TOK == 220


def test_analytic_roofline_matches_bench_py(root_bench):
    """enc_gflops, dec_gb_per_tok, bch5_step_gb and the prompt pass's FLOPs
    are bench.py's at every preset (to its rounding; bench.py's pp FLOPs
    read back through its sol_ms at the v5e rate); the sol_ms are those
    FLOPs and bytes on the H100 SXM constants, computed here by hand."""
    want = root_bench.analytic_roofline()
    got = bench.analytic_roofline()
    assert set(got) == set(want) == set(bench.PRESET_DIMS)
    for preset, (d, le, ld) in bench.PRESET_DIMS.items():
        g, w = got[preset], want[preset]
        assert round(g["enc_gflops"], 1) == w["enc_gflops"], preset
        assert round(g["dec_gb_per_tok"], 3) == w["dec_gb_per_tok"], preset
        assert round(g["bch5_step_gb"], 3) == w["bch5_step_gb"], preset
        v5e_pp_ms = g["pp_gflops"] * 1e9 / (root_bench.V5E_PEAK_TFLOPS * 1e12) * 1e3
        assert round(v5e_pp_ms, 4) == w["sol_ms"]["pp"], preset
        hp = PRESET_HPARAMS[preset]
        T, V = 1500, hp.n_vocab
        enc_flops = le * (24 * T * d * d + 4 * T * T * d)
        w_b = (14 * ld * d * d + V * d) * 2
        ck_b, sk_b = 2 * ld * T * d * 2, 2 * ld * 512 * d * 2
        pp_flops = 2 * (14 * ld * d * d + 2 * ld * T * d)
        sol = g["sol_ms"]
        assert sol["enc"] == pytest.approx(enc_flops / 989e12 * 1e3, rel=1e-12)
        assert sol["dec"] == pytest.approx((w_b + ck_b + sk_b) / 3.35e12 * 1e3, rel=1e-12)
        assert sol["bch5"] == pytest.approx((w_b + ck_b + 5 * sk_b) / 5 / 3.35e12 * 1e3,
                                            rel=1e-12)
        assert sol["pp"] == pytest.approx(pp_flops / 989e12 * 1e3, rel=1e-12)
        assert g["expected_ms"]["enc"] == pytest.approx(sol["enc"] / 0.5)
        assert g["expected_ms"]["dec"] == pytest.approx(sol["dec"] / 0.7)
        assert g["rtf_sol"] == pytest.approx(30e3 / (sol["enc"] + 220 * sol["dec"]))
        wd_b = (14 * 2 * d * d + V * d) * 2
        spec = ((w_b + ck_b + sk_b) + 8 * (wd_b + ck_b * 2 / ld)) / 4.0 / 3.35e12 * 1e3
        assert g["spec_dec_sol_ms"] == pytest.approx(spec, rel=1e-12)
        e, dec, b5 = bench.V100_MS[preset]
        assert g["vs_v100_sol"]["enc"] == pytest.approx(e / sol["enc"])
        assert g["vs_v100_expected"]["dec"] == pytest.approx(dec / (sol["dec"] / 0.7))
        assert ("bch5" in g["vs_v100_sol"]) == (b5 is not None)


# ------------------------------------------------- the timed chains against JAX


@pytest.fixture(scope="module")
def tiny():
    hp = jinit.tiny_test_hparams()
    jp = jax.tree_util.tree_map(jnp.asarray, jinit.random_params(hp, 3, "float32"))
    pp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), hp, "float32")
    mel = np.random.default_rng(0).standard_normal(
        (1, hp.n_mels, 2 * hp.n_audio_ctx)).astype(np.float32)
    enc_j = jm.encoder_forward(jp, hp, jnp.asarray(mel), jnp.float32)
    ck_j, cv_j = jm.cross_attention_kv(jp, hp, enc_j)
    return hp, jp, pp, mel, enc_j, ck_j, cv_j


def _t(a):
    return torch.from_numpy(np.array(a))


def test_encode_and_cross_chains_match_jax(tiny):
    """The encode chain (the kernel's wrapper as attn_fn: its plain
    version on CPU tensors) and the cross-KV chain give the JAX package's
    encoder output and cross K/V within the f32 tolerance."""
    hp, jp, pp, mel, enc_j, ck_j, cv_j = tiny
    _, enc_p = bench.encode_chain(pp, hp, _t(mel), 1, torch.float32, flash_attention)
    np.testing.assert_allclose(enc_p.numpy(), np.asarray(enc_j), rtol=TOL_ENC, atol=TOL_ENC)
    _, (ck_p, cv_p) = bench.cross_chain(pp, hp, enc_p, 1)
    np.testing.assert_allclose(ck_p.numpy(), np.asarray(ck_j), rtol=TOL_ENC, atol=TOL_ENC)
    np.testing.assert_allclose(cv_p.numpy(), np.asarray(cv_j), rtol=TOL_ENC, atol=TOL_ENC)


@pytest.mark.parametrize("batch", [1, 5])
def test_decode_chain_matches_jax(tiny, batch):
    """Four steps of the decode chain (decode at 1 row, bch5 at 5) give
    the token stream of the same chain in JAX: decoder_forward in a loop,
    each step's argmax fed to the next, as bench.py times it."""
    hp, jp, pp, _, _, ck_j, cv_j = tiny
    n = 4
    kv = jm.KVCache.zeros(hp, batch, jnp.float32)
    tok = jnp.zeros((batch, 1), jnp.int32)
    want = []
    for i in range(n):
        logits, kv, _ = jm.decoder_forward(jp, hp, tok, jnp.int32(i), kv, ck_j, cv_j,
                                           jnp.float32)
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        want.append(np.asarray(tok))
    got = bench.decode_chain(pp, hp, pm.KVCache.zeros(hp, batch, torch.float32),
                             torch.zeros((batch, 1), dtype=torch.long), _t(ck_j), _t(cv_j),
                             n, torch.float32)
    assert len(got) == n
    np.testing.assert_array_equal(np.concatenate([g.numpy() for g in got], 1),
                                  np.concatenate(want, 1))


def test_pp_chain_matches_jax(tiny):
    """The prompt-pass chain's logits (a 64-token chunk, last row only)
    are the JAX package's within the f32 logits tolerance."""
    hp, jp, pp, _, _, ck_j, cv_j = tiny
    toks = np.zeros((1, 64), np.int32)
    want, _, _ = jm.decoder_forward(jp, hp, jnp.asarray(toks), jnp.int32(0),
                                    jm.KVCache.zeros(hp, 1, jnp.float32), ck_j, cv_j,
                                    jnp.float32, logit_rows=jnp.int32(63))
    toks_p, got = bench.pp_chain(pp, hp, pm.KVCache.zeros(hp, 1, torch.float32),
                                 _t(toks).long(), _t(ck_j), _t(cv_j), 2, torch.float32)
    assert got.shape == (1, 1, hp.n_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_LOGITS,
                               atol=TOL_LOGITS)
    assert torch.equal(toks_p, _t(toks).long())


def test_mel_chain_is_log_mel_spectrogram():
    """The mel chain's device body on 30 s of silence is the port's
    log_mel_spectrogram of it, bit for bit."""
    audio = np.zeros(30 * 16000, np.float32)
    fb = pmel.mel_filterbank(80)
    want, n_len, _ = pmel.log_mel_spectrogram(audio, fb)
    padded, n_len2, _ = pmel.padded_frames_input(audio)
    _, got = bench.mel_chain(torch.from_numpy(padded), torch.from_numpy(fb),
                             torch.from_numpy(pmel.hann_window()), n_len, 2)
    assert n_len == n_len2 and torch.equal(got, want)


# ------------------------------------------------------------ the capacity search


def _cell(peak, oom_above=None, seen=None):
    def cell(u):
        if seen is not None:
            seen.append(u)
        if oom_above is not None and u > oom_above:
            return None
        return {"hbm_peak_gb": peak(u)}
    return cell


def test_capacity_search_exact_boundary_and_predicted_skip():
    """Peaks 2 + 0.4 U in 79.18 GiB: the doubling runs 4..128, skips 256
    (predicted 104.4 > 1.25 x 79.18), and the bisection stops at 192, the
    cell above it measured over the card."""
    seen = []
    got = bench.capacity_search(_cell(lambda u: 2 + 0.4 * u, seen=seen), 79.18)
    assert got["max_utt"] == 192 and got["exact"] and not got["stopped_at_ceiling"]
    assert got["cells"][256] == {"skipped_predicted_oom": True,
                                 "hbm_predicted_gb": pytest.approx(104.4), "fits": False}
    assert 256 not in seen and seen[:6] == [4, 8, 16, 32, 64, 128]
    assert got["cells"][193]["hbm_peak_gb"] > 79.18 and not got["cells"][193]["fits"]
    assert got["cells"][192]["fits"] and len(seen) == len(set(seen))


def test_capacity_search_out_of_memory_and_small_card():
    """A cell that runs out of memory does not fit; a card too small for
    the first cell bisects below it."""
    got = bench.capacity_search(_cell(lambda u: 0.1 * u, oom_above=99), 79.18)
    assert got["max_utt"] == 99 and got["exact"]
    assert got["cells"][100]["out_of_memory"] and not got["cells"][100]["fits"]
    got = bench.capacity_search(_cell(lambda u: 2 + 0.4 * u), 2.5)
    assert got["max_utt"] == 1 and got["exact"] and set(got["cells"]) == {1, 2, 4}


def test_capacity_search_stops_at_ceiling():
    seen = []
    got = bench.capacity_search(_cell(lambda u: 1.0, seen=seen), 79.18, ceiling=64)
    assert got["max_utt"] == 64 and not got["exact"] and got["stopped_at_ceiling"]
    assert seen == [4, 8, 16, 32, 64]


def test_capacity_check_needs_a_card():
    with pytest.raises(InitError, match="needs a card"):
        bench.batch_capacity_check(torch.device("cpu"))


def test_largev3_beam5_check_on_the_cpu():
    """The beam-5 check composes memory_summary and the audit: at the
    micro model's width on the CPU every program runs and the tallied step
    stands beside its analytic bytes (no peak: the CPU measures none)."""
    got = bench.largev3_beam5_check(torch.device("cpu"), hp=tiny_test_hparams())
    for key in ("decode_window_beam5", "decode_window_beam5_q5", "encoder",
                "decode_window_speculative_k8"):
        assert got[key]["args_gb"] > 0 and got[key]["hbm_peak_gb"] is None, key
    hs = got["hbm_step_gb"]
    assert hs["tally"] > 0 and hs["model"] > 0
    assert hs["ratio"] == pytest.approx(hs["tally"] / hs["model"])
    assert got["decode_window_beam5"]["hbm_audit"]["per_token_gb"] == hs["tally"]


# ------------------------------------------------------------------ bench_all


def _proc(returncode=0, stderr="", stdout=""):
    return subprocess.CompletedProcess([], returncode, stdout=stdout, stderr=stderr)


FAKE_STDERR = ("bench: device=x, preset=tiny\nprobe: 1.0 ms/matmul\nmel: 12.34 ms\n"
               "encode: 45.67 ms\ncross-kv: 1.23 ms\ndecode: 1.234 ms/token\n"
               "bch5: 2.345 ms/step\npp: 0.0123 ms/token\nRTF (audio-s/s/chip): 3.2\n")
FAKE_STDOUT = '3\n{"metric": "m", "value": 3.25, "unit": "u"}\nnot json\n'


@pytest.mark.parametrize("proc", [_proc(0, FAKE_STDERR, FAKE_STDOUT),
                                  _proc(1, FAKE_STDERR + "RuntimeError: boom\n", ""),
                                  _proc(2, "", "")])
def test_run_one_parses_as_the_jax_tool(monkeypatch, proc):
    calls = []

    def fake_run(cmd, **kw):
        calls.append((cmd, kw))
        return proc

    monkeypatch.setattr(subprocess, "run", fake_run)
    got = bench_all.run_one("tiny", flags=["--no-lv3", "--cpu"])
    want = jbench_all.run_one("tiny")
    assert got == want
    cmd, kw = calls[0]
    assert cmd == [sys.executable, "-m", "whisper_tpu_torch.tools.bench", "--preset", "tiny",
                   "--no-lv3", "--cpu"]
    assert kw["cwd"] == ROOT and kw["capture_output"] and "env" not in kw


def test_main_prints_the_jax_tools_table(monkeypatch, capsys):
    rows = {"tiny": {"preset": "tiny", "mel": 12.34, "encode": 45.67, "decode": 1.234,
                     "bch5": 2.345, "pp": 0.0123, "value": 3.25},
            "base": {"preset": "base", "error": "exit 1: boom"},
            "small": {"preset": "small", "encode": 1.0}}
    seen = []

    def port_run_one(p, flags=()):
        seen.append(list(flags))
        return rows[p]

    monkeypatch.setattr(jbench_all, "run_one", lambda p: rows[p])
    monkeypatch.setattr(bench_all, "run_one", port_run_one)
    assert jbench_all.main([]) == 0
    want = capsys.readouterr().out
    assert bench_all.main(["--no-batch", "--no-lv3"]) == 0
    assert capsys.readouterr().out == want
    assert seen == [["--no-lv3", "--no-batch"]] * 3
    assert bench_all.DEFAULT_PRESETS == jbench_all.DEFAULT_PRESETS


# --------------------------------------------------------------- the command line


def test_command_line_on_the_cpu(tmp_path):
    """One JSON line on stdout, under 1 KB, every phase finite and
    positive; the phase lines on stderr parse as bench_all reads them; the
    detail goes to --detail and nowhere else."""
    default = ROOT / "chiprun_out" / "bench_detail_tiny-test.json"
    before = default.stat().st_mtime_ns if default.exists() else None
    detail = tmp_path / "d.json"
    # one thread, as the test processes run side by side
    out = subprocess.run([sys.executable, "-m", "whisper_tpu_torch.tools.bench", "--cpu",
                          "--preset", "tiny-test", "--no-lv3", "--no-batch", "--detail",
                          str(detail)], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == 1 and len(lines[0]) < 1024
    line = json.loads(lines[0])
    assert line["metric"] == "audio_s_per_s_chip_tiny-test_greedy"
    assert line["device"] == "cpu" and line["card"] is None
    assert set(line["ms"]) == {"mel", "encode", "cross-kv", "decode", "bch5", "pp"}
    assert all(math.isfinite(v) and v > 0 for v in line["ms"].values())
    assert line["value"] > 0 and line["detail_file"] == str(detail)
    parsed = dict(re.findall(r"^(mel|encode|cross-kv|decode|bch5|pp): ([0-9.]+) ms",
                             out.stderr, flags=re.M))
    assert set(parsed) == set(line["ms"])
    doc = json.loads(detail.read_text())
    assert doc["primary"]["metric"] == line["metric"]
    assert doc["phases"]["calls"] == {"mel": 7, "encode": 43, "cross-kv": 43, "decode": 289,
                                      "bch5": 289, "pp": 41}
    assert "largev3_beam5" not in doc and "batch_capacity" not in doc
    assert (default.stat().st_mtime_ns if default.exists() else None) == before


def test_command_line_without_a_card_refuses():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is cuda:0")
    with pytest.raises(InitError, match="no CUDA device"):
        bench.main(["--preset", "tiny-test", "--no-lv3", "--no-batch"])
