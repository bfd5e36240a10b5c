"""The port's evidence tools (tools/programs.py, tools/hbm_audit.py,
tools/tp_evidence.py) and its kernel self-check (utils/selfcheck.py), on
the CPU, against the JAX package where both give the same quantity: the
parameter layout at large-v3 and the analytic per-step model of bench.py.
The tally and the tensor-parallel reports run at tiny_test_hparams; the
ranks are processes over gloo (tools/tp_evidence.py starts them)."""

import dataclasses
import importlib.util
import io
import math
import pathlib

import jax
import numpy as np
import pytest
import torch

import whisper_tpu_torch as pt
from whisper_tpu.checkpoint import ggml_io as jggml
from whisper_tpu.checkpoint import init as jinit
from whisper_tpu.checkpoint import quant as jquant
from whisper_tpu.tools import programs as jprograms
from whisper_tpu_torch.checkpoint import ggml_io as pggml
from whisper_tpu_torch.checkpoint import loader as ploader
from whisper_tpu_torch.checkpoint.init import random_params, tiny_test_hparams
from whisper_tpu_torch.config import PRESET_HPARAMS
from whisper_tpu_torch.decoding import batch_loop, device_loop
from whisper_tpu_torch.decoding.speculative import decode_window_speculative
from whisper_tpu_torch.errors import InitError
from whisper_tpu_torch.tools import hbm_audit, programs, tp_evidence
from whisper_tpu_torch.utils import selfcheck

from test_ggml_io import _make_test_tensors
from test_torch_port_host import _checkpoint_bytes

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}.{i}")
    else:
        yield path, tuple(tree.shape), tree.dtype


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int8": torch.int8}


def _jax_as_port(jtree, n_layers):
    """The JAX package's shape tree (stacked layers, linear w [in, out],
    conv w (k, in, out)) as the port's leaves: {path: (shape, dtype)}."""
    out = {}
    for part in ("encoder", "decoder"):
        for key, node in jtree[part].items():
            if key == "blocks":
                for name, leaves in node.items():
                    for leaf, s in leaves.items():
                        shape = s.shape[1:]
                        if leaf == "w":
                            shape = shape[::-1]
                        for li in range(n_layers[part]):
                            out[f"{part}.blocks.{li}.{name}.{leaf}"] = (
                                tuple(shape), _DTYPES[str(s.dtype)])
            elif isinstance(node, dict):
                for leaf, s in node.items():
                    shape = (s.shape[2], s.shape[1], s.shape[0]) if key.startswith("conv") \
                        and leaf == "w" else s.shape
                    out[f"{part}.{key}.{leaf}"] = (tuple(shape), _DTYPES[str(s.dtype)])
            else:
                out[f"{part}.{key}"] = (tuple(node.shape), _DTYPES[str(node.dtype)])
    return out


def test_lv3_abstract_layout_matches_jax(monkeypatch):
    """lv3_abstract's bf16 and int8-block trees equal the JAX package's
    lv3_abstract / abstract_int8_block_shapes at large-v3, leaf for leaf
    under the port's names and layout, and their bytes are equal. The JAX
    draws are replaced by empty arrays of the same shape and dtype: only
    shapes enter the comparison."""
    monkeypatch.setattr(jinit, "_rng_normal",
                        lambda rng, shape, scale, dtype: np.empty(shape, dtype))
    ja = jprograms.lv3_abstract("large-v3")
    pa = programs.lv3_abstract("large-v3")
    hp = pa.hp
    n_layers = {"encoder": hp.n_audio_layer, "decoder": hp.n_text_layer}
    for jt, ptree in ((ja.abs_params, pa.abs_params), (ja.q_params, pa.q_params)):
        want = _jax_as_port(jt, n_layers)
        got = {p: (s, d) for p, s, d in _leaves(ptree)}
        assert got == want
        jbytes = sum(math.prod(s.shape) * np.dtype(s.dtype).itemsize
                     for s in jax.tree_util.tree_leaves(jt))
        assert programs.tree_bytes(ptree) == jbytes
    assert pa.prompt_max == ja.prompt_max
    blk = pa.q_params["decoder"]["blocks"][0]
    assert blk["mlp_0"]["q"].shape == (1280, 5120) and blk["mlp_0"]["d"].shape == (40, 5120)
    assert "w" in pa.q_params["encoder"]["conv1"]


def test_param_shapes_match_random_params():
    """The shape tree is random_params' (the weights the serving tests use)."""
    hp = tiny_test_hparams()
    assert list(_leaves(programs.param_shapes(hp))) == list(_leaves(random_params(hp)))


def test_int8_block_rule_is_keep_quantized_loading():
    """abstract_int8_block_shapes gives the layout keep_quantized loading
    of a Q5_0 checkpoint produces (token embedding and convs dense)."""
    hp = dataclasses.replace(tiny_test_hparams(), n_audio_state=256, n_text_state=256,
                             n_audio_head=4, n_text_head=4)
    data = _checkpoint_bytes(jggml, hp, _make_test_tensors(
        hp, ttype=jquant.GGML_TYPE_Q5_0, seed=2))
    loaded = ploader.params_from_checkpoint(pggml.read_ggml(io.BytesIO(data)), "bfloat16",
                                            keep_quantized=True)
    got = list(_leaves(loaded.params))
    want = list(_leaves(programs.lv3_abstract(hp=hp).q_params))
    assert sorted(got) == sorted(want)


def _bench():
    spec = importlib.util.spec_from_file_location("bench_for_port_tests", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_analytic_matches_bench():
    """hbm_audit.analytic gives bench.py analytic_roofline's enc_gflops,
    dec_gb_per_tok (1 row) and bch5_step_gb (5 rows sharing the weights
    and cross-KV) for every preset there, to its rounding."""
    bench = _bench()
    rows = bench.analytic_roofline()
    assert set(bench.PRESET_DIMS) <= set(PRESET_HPARAMS)
    for preset in bench.PRESET_DIMS:
        hp = PRESET_HPARAMS[preset]
        one, five = hbm_audit.analytic(hp), hbm_audit.analytic(hp, rows=5)
        assert round(one["enc_gflops"], 1) == rows[preset]["enc_gflops"], preset
        assert round(one["step_gb"], 3) == rows[preset]["dec_gb_per_tok"], preset
        assert round(five["step_gb"], 3) == rows[preset]["bch5_step_gb"], preset
    lv3 = PRESET_HPARAMS["large-v3"]
    q = hbm_audit.analytic(lv3, "q5", "int8")
    assert q["weights_gb"] == pytest.approx((14 * 32 * 1280 ** 2 * 1.125 + 51866 * 1280 * 2)
                                            / 1e9)
    assert q["cross_kv_gb"] == pytest.approx(2 * 32 * 1500 * 1280 * (1 + 4 / 64) / 1e9)


# ---------------------------------------------------------------- the tally


@pytest.mark.parametrize("case", ["mm", "add", "view", "cast", "gather", "index_put",
                                  "broadcast"])
def test_tally_single_ops_exact(case):
    """Exact bytes of single aten ops: inputs and outputs at their viewed
    size, a view free, a gather reading what it returns, an indexed write
    writing its values, a broadcast dim once."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(100, 64, generator=g)
    b = torch.randn(64, 32, generator=g)
    x = torch.randn(1000, generator=g)
    idx = torch.tensor([3, 1, 4, 1, 5])
    cache = torch.zeros(10, 8)
    vals = torch.ones(3, 8)
    rows = torch.tensor([0, 2, 7])
    fn, want, cls = {
        "mm": (lambda: a @ b, (100 * 64 + 64 * 32 + 100 * 32) * 4, "matmul"),
        "add": (lambda: x + x * 0, 3 * 4000 + 2 * 4000, "elementwise"),
        "view": (lambda: a.t().reshape(64, 100)[:3], 0, None),
        "cast": (lambda: x.to(torch.bfloat16), 4000 + 2000, "copy"),
        "gather": (lambda: a[idx], 5 * 64 * 4 + 5 * 8 + 5 * 64 * 4, "copy"),
        "index_put": (lambda: cache.index_put_((rows,), vals), 3 * 8 * 4 + 3 * 8 + 3 * 8 * 4,
                      "copy"),
        "broadcast": (lambda: x[:8][None].expand(4, 8).contiguous(), 8 * 4 + 32 * 4, "copy"),
    }[case]
    r = hbm_audit.audit_step(fn)
    assert round(r["gb"] * 1e9) == want
    if cls:
        assert r["by_class_gb"] == {cls: want / 1e9}


@pytest.mark.parametrize("kw", [dict(beam=1), dict(beam=5),
                                dict(weights="q5", kv="int8", beam=1, n_utt=2)],
                         ids=["greedy_bf16", "beam5_bf16", "batch2_q5_kv8"])
def test_decode_step_tally_sums(kw):
    """One step of a tiny capped decode: every layer's body equal, and
    token_body + n_layers x layer_body the step's whole tally within 1 %."""
    r = hbm_audit.audit_decode_step(hp=tiny_test_hparams(), device="cpu", **kw)
    assert r["device"] == "cpu" and "not the card's" in r["note"]
    assert r["decoder_calls"] == 5            # the prompt pass and 4 capped steps
    assert r["n_layers"] == 3 and len(set(r["layers_gb"])) == 1
    assert r["per_token_gb"] == pytest.approx(r["token_body"]["gb"] + 3 * r["layer_body"]["gb"])
    assert r["per_token_gb"] == pytest.approx(r["step_total_gb"], rel=0.01)
    assert sum(r["by_class_gb"].values()) == pytest.approx(r["step_total_gb"])
    assert r["ratio_to_analytic"] > 0 and r["step_ms"] is None
    assert r["launches_tallied_run"] == {"B1": 0, "B2": 0, "B3": 0}   # plain on the CPU


# ---------------------------------------------------------------- programs


@pytest.fixture(scope="module")
def tiny():
    hp = tiny_test_hparams()
    a = programs.lv3_abstract(hp=hp)
    return hp, a


def test_encoder_program_is_the_serving_encode(tiny):
    """The encoder program's output equals WhisperState.encode on the same
    weights and mel (the same code: exactly)."""
    hp, a = tiny
    prog = programs.encoder(a, 1)
    args = prog.args("cpu", seed=5)
    embed, ck, cv = prog.run(args)
    model = ploader.LoadedModel(hp, args["params"], np.zeros((hp.n_mels, 201), np.float32),
                                a.vocab, -1)
    ctx = pt.WhisperContext(model, pt.ContextParams(use_gpu=False))
    st = ctx.create_state()
    st.set_mel(args["mel"][0].numpy())
    got = st.encode(0)
    assert torch.equal(got, embed)
    assert torch.equal(st.cross_k, ck) and torch.equal(st.cross_v, cv)


def _same(r1, r2):
    for name in ("tokens", "tok_p", "tok_plog", "result_len", "completed", "failed"):
        np.testing.assert_array_equal(getattr(r1, name), getattr(r2, name), err_msg=name)
    assert r1.n_tokens == r2.n_tokens


def test_decode_programs_are_the_serving_loops(tiny):
    """Each decode program equals its loop called directly on the same
    arguments (exactly), and the cap holds: n_steps + 1 tokens."""
    hp, a = tiny
    n = 3
    prog = programs.decode_window(a, beam_size=5, n_steps=n)
    args = prog.args("cpu", seed=1)
    got = prog.run(args)
    want = device_loop.decode_window(
        args["params"], hp, args["consts"], args["cross_k"], args["cross_v"], args["prompt"],
        3, 0.0, 0, 2 * hp.n_audio_ctx, tids=args["tids"], n_dec=5, strategy=device_loop.BEAM,
        beam_size=5, max_tokens=n, no_timestamps=True)
    _same(got, want)
    assert got.n_tokens == n + 1

    prog = programs.batch_decode(a, 2, "q5", kv_quant=True, n_per_utt=1, n_steps=n)
    args = prog.args("cpu", seed=2)
    got = prog.run(args)
    want = batch_loop.decode_windows_batch(
        args["params"], hp, args["consts"], args["cross_k"], args["cross_v"], args["prompts"],
        np.full(2, 3), 0.0, np.zeros(2, np.int32), np.full(2, 2 * hp.n_audio_ctx), np.ones(2, bool),
        tids=args["tids"], n_utt=2, n_per_utt=1, strategy=device_loop.GREEDY_BEST,
        max_tokens=n, no_timestamps=True, kv_quant=True)
    _same(got, want)
    assert got.n_tokens == n + 1
    assert "q" in args["params"]["decoder"]["blocks"][0]["mlp_0"]

    prog = programs.speculative(a, k_spec=4, n_steps=n)
    args = prog.args("cpu", seed=3)
    got = prog.run(args)
    want = decode_window_speculative(
        args["params"], args["params_draft"], hp, programs.draft_hparams(hp), args["consts"],
        args["cross_k"], args["cross_v"], args["draft_ck"], args["draft_cv"], args["prompt"], 3,
        0, 2 * hp.n_audio_ctx, tids=args["tids"], k_spec=4, max_tokens=n, no_timestamps=True)
    _same(got, want)
    assert got.n_tokens == n + 1 and "encoder" not in args["params_draft"]


def test_memory_summary_on_cpu(tiny):
    """The JAX keys; on the CPU the arguments and outputs only."""
    hp, a = tiny
    r = programs.memory_summary(programs.batch_decode(a, 2, "q5", kv_quant=True, n_steps=1),
                                "cpu")
    assert set(r) >= {"args_gb", "temp_gb", "out_mb", "hbm_peak_gb"}
    assert r["temp_gb"] is None and r["hbm_peak_gb"] is None
    params = programs.tree_bytes(a.q_params)
    H, dh = hp.n_text_head, hp.n_text_state // hp.n_text_head
    ck = 2 * hp.n_text_layer * 2 * H * hp.n_audio_ctx * (dh + 4)     # codes + f32 scales
    assert r["args_gb"] * 2 ** 30 > params + ck
    assert r["out_mb"] > 0


# ---------------------------------------------------------------- tensor parallelism


@pytest.fixture(scope="module")
def tp_reports():
    """TP = 1 and 2, speculation at TP = 2 and the 2 x 2 capacity report,
    all on the CPU over gloo at tiny width (2 heads), run side by side."""
    hp = tp_evidence._hp_kw(tiny_test_hparams())
    kw = dict(preset="tiny", seed=0, hp=hp)
    return tp_evidence.run_reports(
        [("tp", 1, dict(kw, tp=1, beam=2)), ("tp", 2, dict(kw, tp=2, beam=2)),
         ("spec", 2, dict(kw, tp=2, k_spec=4, dtype="bfloat16")),
         ("capacity", 4, dict(kw, dp=2, tp=2, n_utt=4))], "cpu")


def test_tp_evidence_halves_bytes_and_adds_collectives(tp_reports):
    """tests/test_mesh.py's assertions on the JAX tool: TP = 2 args below
    0.7 x TP = 1, no collectives at TP = 1, all-reduces at TP = 2 (3 a
    layer and the vocab-sharded lookup per decoder call)."""
    r1, r2 = tp_reports[0], tp_reports[1]
    assert r2["backend"] == "gloo" and len(r2["ranks"]) == 2
    for phase in ("encoder", "decode_beam2"):
        assert r2[phase]["args_gb"] < 0.7 * r1[phase]["args_gb"], phase
        assert not r1[phase]["collectives"], r1[phase]
        assert r2[phase]["collectives"].get("all-reduce", 0) > 0, r2[phase]
    assert r2["encoder"]["collectives"] == {"all-reduce": 2 * 2}
    per_call = r2["decode_beam2"]["collectives_per_decoder_call"]
    assert per_call == {"all-reduce": 3 * 3 + 1, "all-gather": 1}
    assert r2["decode_beam2"]["decoder_calls"] == 2
    for rank in r2["ranks"]:
        assert rank["decode_beam2"]["collectives"] == r2["decode_beam2"]["collectives"]


def test_spec_tp_evidence_shards_main_only(tp_reports):
    """Speculation over the mesh: the main model's bytes halve, the draft
    stays whole on each rank, and every rank's stream is the un-meshed
    one."""
    r = tp_reports[2]
    assert r["stream_equal"] and len(r["unmeshed_stream"]) == 4
    assert r["main_params_gb"] < 0.7 * r["main_params_gb_unsharded"]
    hp = programs.draft_hparams(tiny_test_hparams())
    draft = programs.tree_bytes({"decoder": programs.param_shapes(hp)["decoder"]}) / 2 ** 30
    assert all(rk["draft_params_gb"] == draft for rk in r["ranks"])
    assert r["decode_speculative"]["collectives"].get("all-reduce", 0) > 0


def test_capacity_tp_evidence_splits_cross_kv(tp_reports):
    """DP x TP: each rank holds 1/dp of the utterances' int8 cross-KV (and
    1/tp of their heads), and its shard of the int8-block weights."""
    r = tp_reports[3]
    assert r["dp"] == 2 and r["tp"] == 2 and len(r["ranks"]) == 4
    for rk in r["ranks"]:
        assert rk["n_local"] == 2
        assert rk["cross_kv_gb"] * 2 * 2 == pytest.approx(rk["cross_kv_gb_unsharded"], rel=1e-12)
        assert rk["decode_beam5_capacity"]["collectives"].get("all-reduce", 0) > 0
    q_full = programs.tree_bytes(programs.lv3_abstract(hp=tiny_test_hparams()).q_params)
    assert r["params_gb"] * 2 ** 30 < 0.7 * q_full


# ---------------------------------------------------------------- selfcheck


def test_selfcheck_without_card():
    ok, err = selfcheck.flash_attention_ab_check(device="cpu")
    assert ok is None and math.isnan(err)


def test_warmup_raises_on_kernel_mismatch(monkeypatch):
    """On a CUDA context, a kernel that disagrees with its plain version
    stops warmup with InitError; nothing switches the kernel off."""
    ctx = pt.WhisperContext.random(hp=tiny_test_hparams(),
                                   params=pt.ContextParams(use_gpu=False))
    calls = []

    def mismatch(tol=2e-2, device=None):
        calls.append(device)
        return False, 0.5

    monkeypatch.setattr(selfcheck, "flash_attention_ab_check", mismatch)
    ctx.device = torch.device("cuda", 0)           # flagged as on the card
    with pytest.raises(InitError, match="flash-attention kernel disagrees"):
        ctx.warmup(all_prompt_buckets=False)
    assert calls == [torch.device("cuda", 0)]
    assert ctx.cparams.flash_attn and ctx.use_flash
