"""The quantized main path of the PyTorch port against the JAX package:
kernels B2/B3 (quant_matmul, plain version against the Pallas kernel in
interpret mode), the keep_quantized loader and the leaf carriers, the
quantizer tool, the int8 KV cache (quantize_kv_rows, attention_quant, the
split decoder path), and `WhisperState.full` end to end on quantized
checkpoints and with kv_dtype="int8". Both packages run on the CPU, in
float32 where a compute dtype applies; each test states its tolerance."""

import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu as wt
import whisper_tpu_torch as pt
from whisper_tpu.checkpoint import ggml_io as jggml
from whisper_tpu.checkpoint import init as jinit
from whisper_tpu.checkpoint import loader as jloader
from whisper_tpu.checkpoint import quant as jquant
from whisper_tpu.models import whisper as jm
from whisper_tpu.ops import quant_matmul as jqmm
from whisper_tpu.tools import quantize as jtool
from whisper_tpu_torch.checkpoint import ggml_io as pggml
from whisper_tpu_torch.checkpoint import loader as ploader
from whisper_tpu_torch.checkpoint import quant as pquant
from whisper_tpu_torch.checkpoint.from_jax import params_from_jax
from whisper_tpu_torch.models import whisper as pm
from whisper_tpu_torch.ops import quant_matmul as pqmm
from whisper_tpu_torch.ops.flash_attention import SMS
from whisper_tpu_torch.tools import quantize as ptool

from test_ggml_io import _make_test_tensors
from test_torch_port_host import _checkpoint_bytes, assert_trees_equal

KEEPQ = [jquant.GGML_TYPE_Q4_0, jquant.GGML_TYPE_Q4_1, jquant.GGML_TYPE_Q5_0,
         jquant.GGML_TYPE_Q5_1, jquant.GGML_TYPE_Q8_0] + list(jquant.K_QUANT_TYPES)
OFFSET = (jquant.GGML_TYPE_Q4_1, jquant.GGML_TYPE_Q5_1, jquant.GGML_TYPE_Q2_K,
          jquant.GGML_TYPE_Q4_K, jquant.GGML_TYPE_Q5_K)


def t(a):
    return torch.from_numpy(np.array(a))


def _qweight(rng, n_in, n_out, ttype):
    """A seeded weight in `ttype`, as int8 blocks in quant_matmul's layout:
    (q, d, m or None, qblock) as numpy, from the JAX package's repack."""
    w = rng.standard_normal((n_out, n_in)).astype(np.float32) * 0.05
    raw = jquant.quantize(w, ttype)
    q, d, m = jquant.dequantize_to_int8_blocks(raw, ttype, w.size)
    bs = jquant.int8_block_size(ttype)
    if ttype in OFFSET:
        qT, dT, mT = jqmm.repack_for_tpu(q, d, n_out, n_in, m, qblock=bs)
    else:
        (qT, dT), mT = jqmm.repack_for_tpu(q, d, n_out, n_in, qblock=bs), None
    return qT, dT, mT, bs


def _both(x, qT, dT, mT, bs):
    want = np.asarray(jqmm.quant_matmul(
        jnp.asarray(x), jnp.asarray(qT), jnp.asarray(dT),
        None if mT is None else jnp.asarray(mT), out_tile=128, qblock=bs))
    got = pqmm.quant_matmul_plain(t(x), t(qT), t(dT), None if mT is None else t(mT), bs)
    return got, want


# The Pallas kernel in interpret mode and the plain version round the same
# bf16 operands (x, q*d, +m) the same way; only the order of the float32
# sums differs. Measured gap: <= 6e-8 at outputs of size ~0.3 (all ten
# formats), so XLA kept no excess precision in the bf16 products here.
QMM_TOL = 1e-6


@pytest.mark.parametrize("lead", [(3,), (2, 3)], ids=["x2d", "x3d"])
@pytest.mark.parametrize("ttype", KEEPQ, ids=[jquant.TYPE_NAMES[k] for k in KEEPQ])
def test_plain_matches_pallas_interpret_all_formats(ttype, lead):
    """All ten keep_quantized formats (qblock 32 and 16, with and without
    the offset operand), 2-D and 3-D x, at tests/test_quant_matmul.py's
    K-quant shape (IN 256, OUT 128)."""
    rng = np.random.default_rng(ttype)
    qT, dT, mT, bs = _qweight(rng, 256, 128, ttype)
    assert bs == (16 if ttype in (jquant.GGML_TYPE_Q2_K, jquant.GGML_TYPE_Q3_K,
                                  jquant.GGML_TYPE_Q6_K) else 32)
    x = rng.standard_normal(lead + (256,)).astype(np.float32) * 0.1
    got, want = _both(x, qT, dT, mT, bs)
    assert got.shape == want.shape == lead + (128,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=QMM_TOL)


@pytest.mark.parametrize("shape", [(2, 64, 128), (1, 128, 256), (5, 256, 64)])
def test_plain_matches_pallas_interpret_shapes(shape):
    """tests/test_quant_matmul.py's Q8_0 shapes (B, IN, OUT)."""
    B, n_in, n_out = shape
    rng = np.random.default_rng(1)
    qT, dT, mT, bs = _qweight(rng, n_in, n_out, jquant.GGML_TYPE_Q8_0)
    x = rng.standard_normal((B, n_in)).astype(np.float32) * 0.1
    got, want = _both(x, qT, dT, mT, bs)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=QMM_TOL)


@pytest.mark.parametrize("m_rows", [1, 5, 8, 16])
@pytest.mark.parametrize("ttype", [jquant.GGML_TYPE_Q5_0, jquant.GGML_TYPE_Q5_1],
                         ids=["q5_0", "q5_1"])
def test_plain_matches_pallas_interpret_skinny_rows(ttype, m_rows):
    """The skinny path's shapes (M = 1 greedy, 5 beam-5, 8 and 16 prompt
    buckets) for B2 (Q5_0) and B3 (Q5_1), at a narrow width (IN 256, OUT
    384)."""
    rng = np.random.default_rng(m_rows)
    qT, dT, mT, bs = _qweight(rng, 256, 384, ttype)
    x = rng.standard_normal((m_rows, 256)).astype(np.float32) * 0.1
    got, want = _both(x, qT, dT, mT, bs)
    assert got.shape == want.shape == (m_rows, 384)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=QMM_TOL)


# decoder widths of tiny, base, small, medium and large-v3
SKINNY_WIDTHS = [384, 512, 768, 1024, 1280]


def skinny_rank_blocks(n_blocks, cluster):
    """The qblock-row blocks [lo, hi) of each rank of a skinny cluster, as
    the kernel cuts them (csrc/quant_matmul.cu qmm_skinny_cluster:
    [r*n/C, (r+1)*n/C))."""
    return [(r * n_blocks // cluster, (r + 1) * n_blocks // cluster) for r in range(cluster)]


@pytest.mark.parametrize("qblock", [16, 32])
@pytest.mark.parametrize("width", SKINNY_WIDTHS)
def test_plan_skinny_covers_every_block_and_column(width, qblock):
    """At the decode shapes (d -> d, d -> 4d, 4d -> d) and M = 1..16: every
    qblock-row block falls in exactly one CTA of the cluster, every CTA
    holds at least one, the cluster is within the kernel's limit, the
    column tiles cover OUT, and the grid stays near its target size."""
    for n_in, n_out in ((width, width), (width, 4 * width), (4 * width, width)):
        n_blocks = n_in // qblock
        col_tiles = -(-n_out // pqmm.SKINNY_COLS)
        assert (col_tiles - 1) * pqmm.SKINNY_COLS < n_out <= col_tiles * pqmm.SKINNY_COLS
        for m_rows in range(1, pqmm.SKINNY_ROWS + 1):
            cluster = pqmm.plan_skinny(m_rows, n_in, n_out, qblock)
            assert 1 <= cluster <= min(pqmm.SKINNY_MAX_CLUSTER, n_blocks)
            assert col_tiles * cluster <= max(pqmm.SKINNY_CTAS, col_tiles)
            ranks = skinny_rank_blocks(n_blocks, cluster)
            owners = [r for b in range(n_blocks) for r, (lo, hi) in enumerate(ranks)
                      if lo <= b < hi]
            assert owners == sorted(owners) and len(owners) == n_blocks
            assert set(owners) == set(range(cluster))       # each rank a real block


def test_plan_skinny_fills_the_card_at_large_v3():
    """large-v3's decode shapes put at least one CTA on each of the 132 SMs."""
    for n_in, n_out in ((1280, 1280), (1280, 5120), (5120, 1280)):
        cluster = pqmm.plan_skinny(1, n_in, n_out, 32)
        assert SMS <= -(-n_out // pqmm.SKINNY_COLS) * cluster <= pqmm.SKINNY_CTAS


def test_plan_skinny_refuses_wide_rows():
    for m_rows in (0, pqmm.SKINNY_ROWS + 1, 1500):
        with pytest.raises(ValueError, match="skinny path"):
            pqmm.plan_skinny(m_rows, 1280, 1280, 32)


def test_leaf_checks_refuse_what_the_kernel_cannot_take():
    """The checks the wrapper makes once per set of leaves (on the card,
    at their first call), here on CPU tensors: each refusal by its
    message."""
    rng = np.random.default_rng(3)
    qT, dT, mT, bs = (t(a) if a is not None and not isinstance(a, int) else a
                      for a in _qweight(rng, 256, 128, jquant.GGML_TYPE_Q5_1))
    x = torch.zeros(2, 256)
    pqmm._check(x, qT, dT, mT, bs)                      # the good leaves pass
    for args, match in (((qT.float(), dT, mT, bs), "int8 q"),
                        ((qT, dT.double(), mT, bs), "float32 d"),
                        ((qT, dT, mT[:4], bs), "float32 m"),
                        ((qT, dT, mT, 64), "qblock"),
                        ((qT[:, :120], dT[:, :120], mT[:, :120], bs), "multiple of 16"),
                        ((qT.t().contiguous().t(), dT, mT, bs), "contiguous"),
                        ((qT[:128], dT, mT, bs), "shapes")):
        with pytest.raises(ValueError, match=match):
            pqmm._check(x, *args)
    misaligned = torch.cat([dT.flatten(), dT.flatten()[:1]])[1:].view_as(dT)
    with pytest.raises(ValueError, match="16-byte"):
        pqmm._check(x, qT, misaligned, mT, bs)


def test_repack_and_dequant_match_jax():
    """repack_blocks is repack_for_tpu; dequant_reference equals the JAX
    one exactly; dequant_bf16 is the kernel's weight, within its four bf16
    roundings (d, q*d, m, the sum: 2^-9 each of at most max|w|) of the
    float32 dequantization."""
    rng = np.random.default_rng(0)
    for ttype in (jquant.GGML_TYPE_Q5_0, jquant.GGML_TYPE_Q5_K):
        w = rng.standard_normal((128, 256)).astype(np.float32)
        raw = pquant.quantize(w, ttype)
        q, d, m = pquant.dequantize_to_int8_blocks(raw, ttype, w.size)
        bs = pquant.int8_block_size(ttype)
        got = pqmm.repack_blocks(q, d, 128, 256, m, qblock=bs)
        want = jqmm.repack_for_tpu(q, d, 128, 256, m, qblock=bs)
        for g, w_ in zip(got, want):
            assert g.dtype == w_.dtype and g.shape == w_.shape
            np.testing.assert_array_equal(g, w_)
        qT, dT, mT = (t(a) for a in got)
        ref = pqmm.dequant_reference(qT, dT, mT, bs)
        np.testing.assert_array_equal(ref.numpy(), np.asarray(jqmm.dequant_reference(
            jnp.asarray(got[0]), jnp.asarray(got[1]), jnp.asarray(got[2]), bs)))
        np.testing.assert_array_equal(
            ref.numpy(), pquant.dequantize(raw, ttype, w.size).reshape(128, 256).T)
        wb = pqmm.dequant_bf16(qT, dT, mT, bs).float()
        assert (wb - ref).abs().max() <= 2 ** -6 * ref.abs().max()


def test_wrapper_on_cpu_takes_plain_version_and_counts_nothing():
    rng = np.random.default_rng(5)
    qT, dT, mT, bs = _qweight(rng, 64, 48, jquant.GGML_TYPE_Q5_1)   # OUT 48 is fine on CPU
    x = t(rng.standard_normal((2, 3, 64)).astype(np.float32))
    before = (pqmm.quant_matmul.launches, pqmm.quant_matmul.launches_offset)
    out = pqmm.quant_matmul(x, t(qT), t(dT), t(mT), bs)
    assert (pqmm.quant_matmul.launches, pqmm.quant_matmul.launches_offset) == before
    torch.testing.assert_close(out, pqmm.quant_matmul_plain(x, t(qT), t(dT), t(mT), bs),
                               rtol=0, atol=0)


def test_linear_takes_quantized_leaves():
    """models.linear with q/d/m leaves: quant_matmul, then the float32
    bias, then one cast — equal to the JAX package's linear (same
    operands; float32 sums of 256 terms: 1e-6)."""
    rng = np.random.default_rng(6)
    qT, dT, mT, bs = _qweight(rng, 256, 96, jquant.GGML_TYPE_Q4_K)
    b = rng.standard_normal(96).astype(np.float32)
    x = rng.standard_normal((2, 5, 256)).astype(np.float32)
    want = jm.linear(jnp.asarray(x), {"q": jnp.asarray(qT), "d": jnp.asarray(dT),
                                      "m": jnp.asarray(mT), "b": jnp.asarray(b)})
    got = pm.linear(t(x), {"q": t(qT), "d": t(dT), "m": t(mT), "b": t(b)})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


# ------------------------------------------------------------------ loader

def _hp_256():
    """Width 256 with 4 heads of 64: rows divide the K-quants' 256 block."""
    return dataclasses.replace(jinit.tiny_test_hparams(), n_audio_state=256,
                               n_text_state=256, n_audio_head=4, n_text_head=4)


@pytest.mark.parametrize("ttype", [jquant.GGML_TYPE_Q5_0, jquant.GGML_TYPE_Q5_1,
                                   jquant.GGML_TYPE_Q6_K, jquant.GGML_TYPE_Q5_K],
                         ids=["q5_0", "q5_1", "q6_K", "q5_K"])
def test_loader_quantized_leaves_match_jax(ttype):
    """keep_quantized leaves exactly equal to the JAX loader's, present or
    absent alike ("m" only for the offset formats), carried through
    params_from_jax as they are (q int8, no transpose)."""
    hp = _hp_256()
    data = _checkpoint_bytes(jggml, hp, _make_test_tensors(hp, ttype=ttype, seed=2))
    pmod = ploader.params_from_checkpoint(pggml.read_ggml(io.BytesIO(data)), "float32",
                                          keep_quantized=True)
    jmod = jloader.params_from_checkpoint(jggml.read_ggml(io.BytesIO(data)), "float32",
                                          keep_quantized=True)
    assert_trees_equal(pmod.params, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jmod.params), hp, "float32"))
    for part in ("encoder", "decoder"):
        for blk in pmod.params[part]["blocks"]:
            for name, leaf in blk.items():
                if name.endswith("_ln"):
                    continue
                assert "w" not in leaf and leaf["q"].dtype == torch.int8
                assert ("m" in leaf) == (ttype in OFFSET), name
    lin = pmod.params["decoder"]["blocks"][0]["mlp_0"]            # 256 -> 1024
    bs = jquant.int8_block_size(ttype)
    assert lin["q"].shape == (256, 1024) and lin["d"].shape == (256 // bs, 1024)
    assert pmod.params["decoder"]["token_embed"].dtype == torch.float32   # stays dense
    assert pmod.params["encoder"]["conv1"]["w"].dtype == torch.float32


def test_place_params_keeps_int8_leaves():
    tree = {"a": {"q": np.arange(-4, 4, dtype=np.int8).reshape(2, 4),
                  "d": np.ones((1, 4), np.float32), "w": np.ones((4, 2), np.float32)},
            "b": [{"q": torch.ones(3, 2, dtype=torch.int8), "token_embed": torch.ones(2)}]}
    out = ploader.place_params(tree, "bfloat16", "cpu")
    assert out["a"]["q"].dtype == torch.int8 and out["b"][0]["q"].dtype == torch.int8
    assert out["a"]["q"].tolist() == [[-4, -3, -2, -1], [0, 1, 2, 3]]
    assert out["a"]["d"].dtype == torch.float32
    assert out["a"]["w"].dtype == out["b"][0]["token_embed"].dtype == torch.bfloat16


def test_params_from_jax_carries_quantized_leaves():
    """q stays int8 and d / m keep the [in//bs, out] layout per layer,
    while dense "w" turns to [out, in]."""
    hp = jinit.tiny_test_hparams()
    jp = jax.tree_util.tree_map(np.asarray, jinit.random_params(hp, 1, "float32"))
    L, d = hp.n_text_layer, hp.n_text_state
    rng = np.random.default_rng(0)
    q = rng.integers(-16, 16, size=(L, d, 4 * d)).astype(np.int8)
    s = rng.random((L, d // 32, 4 * d)).astype(np.float32)
    jp["decoder"]["blocks"]["mlp_0"] = {"q": q, "d": s, "m": -s,
                                        "b": np.zeros((L, 4 * d), np.float32)}
    pp = params_from_jax(jp, hp, "bfloat16")
    for i, blk in enumerate(pp["decoder"]["blocks"]):
        lin = blk["mlp_0"]
        assert lin["q"].dtype == torch.int8 and torch.equal(lin["q"], t(q[i]))
        assert lin["d"].dtype == torch.float32 and torch.equal(lin["d"], t(s[i]))
        assert torch.equal(lin["m"], t(-s[i]))
        assert blk["attn_q"]["w"].shape == (d, d)


# ------------------------------------------------------------------- tools

def test_quantize_tool_matches_jax(tmp_path):
    """quantize_model writes the JAX tool's bytes and types; the in-memory
    quantize_tensors, which encodes in threads, gives the JAX file's
    tensors, bytes and order."""
    hp = _hp_256()
    tensors = _make_test_tensors(hp, ttype=jquant.GGML_TYPE_F16, seed=3)
    src = tmp_path / "f16.bin"
    src.write_bytes(_checkpoint_bytes(jggml, hp, tensors))
    jlog = jtool.quantize_model(str(src), str(tmp_path / "j.bin"), "q5_k")
    plog = ptool.quantize_model(str(src), str(tmp_path / "p.bin"), "q5_k")
    assert plog == jlog
    assert (tmp_path / "p.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    assert plog["decoder.token_embedding.weight"] == jquant.GGML_TYPE_Q5_K
    assert plog["encoder.positional_embedding"] == jquant.GGML_TYPE_F32   # skip list
    assert plog["encoder.conv1.weight"] == jquant.GGML_TYPE_F16           # 3-D
    jfile = jggml.read_ggml(str(tmp_path / "j.bin")).tensors
    src_tensors = jggml.read_ggml(str(src)).tensors
    mem = ptool.quantize_tensors({n: (rt.to_float32(), rt.ttype)
                                  for n, rt in src_tensors.items()}, "q5_k")
    assert list(mem) == list(jfile)
    for n, rt in mem.items():
        assert (rt.ne, rt.ttype, bytes(rt.data)) == (jfile[n].ne, jfile[n].ttype,
                                                     bytes(jfile[n].data)), n
    assert ptool.main(["a", "b"]) == 3 and ptool.main(["a", "b", "q9_9"]) == 3


# --------------------------------------------------------------- int8 KV

def test_quantize_kv_rows_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5, 64)).astype(np.float32)
    x[0, 0, 0] = 0.0                               # an all-zero row: the 1e-10 floor
    qj, sj = jm.quantize_kv_rows(jnp.asarray(x))
    qp, sp = pm.quantize_kv_rows(t(x))
    assert qp.dtype == torch.int8 and sp.dtype == torch.float32
    np.testing.assert_array_equal(qp.numpy(), np.asarray(qj))
    np.testing.assert_allclose(sp.numpy(), np.asarray(sj), rtol=1e-6, atol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_attention_quant_matches_jax(masked):
    """float32, 1e-5: the same products, summation order only."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 3, 4, 64)).astype(np.float32)
    k = rng.standard_normal((2, 3, 9, 64)).astype(np.float32)
    v = rng.standard_normal((2, 3, 9, 64)).astype(np.float32)
    (kq, ks), (vq, vs) = jm.quantize_kv_rows(jnp.asarray(k)), jm.quantize_kv_rows(jnp.asarray(v))
    mask = (np.arange(9)[None, :] <= np.arange(4)[:, None] + 4)[None, None] if masked else None
    want = jm.attention_quant(jnp.asarray(q), kq, ks, vq, vs,
                              None if mask is None else jnp.asarray(mask))
    got = pm.attention_quant(t(q), t(kq), t(ks), t(vq), t(vs),
                             None if mask is None else t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_kv_cache_int8_layout():
    hp = jinit.tiny_test_hparams()
    kv = pm.KVCache.zeros(hp, 3, quant=True)
    jkv = jm.KVCache.zeros(hp, 3, quant=True)
    assert kv.quantized and kv.k.dtype == kv.v.dtype == torch.int8
    assert kv.ks.dtype == kv.vs.dtype == torch.float32
    assert kv.k.shape == jkv.k.shape and kv.ks.shape == jkv.ks.shape == kv.k.shape[:-1]
    one = pm.KVCache.zeros(hp, 1, quant=True)
    one.ks.fill_(2.0)
    wide = one.broadcast(5)
    assert wide.quantized and wide.ks.shape[1] == 5 and bool((wide.ks == 2.0).all())


def test_decoder_int8_cache_matches_jax():
    """decoder_forward over int8 self- and cross-KV: an 8-row prompt pass
    at batch 3 against the shared cross-KV, then T=1 steps with a beam
    fork, against the JAX package's split path on the same weights.
    float32; the scales multiply the same float32 sums in both, so 1e-4 as
    in tests/test_torch_port_model.py. Cache codes may differ by one where
    a float32 value lies at a rounding midpoint: compare dequantized."""
    hp = jinit.tiny_test_hparams()
    jp = jax.tree_util.tree_map(jnp.asarray, jinit.random_params(hp, 4, "float32"))
    pp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), hp, "float32")
    rng = np.random.default_rng(2)
    enc = rng.standard_normal((1, hp.n_audio_ctx, hp.n_audio_state)).astype(np.float32)
    (ckj, cv_j) = jm.cross_attention_kv(jp, hp, jnp.asarray(enc), quant=True)
    ckp, cvp = pm.cross_attention_kv(pp, hp, t(enc), quant=True)
    np.testing.assert_array_equal(ckp[0].numpy(), np.asarray(ckj[0]))
    np.testing.assert_allclose(cvp[1].numpy(), np.asarray(cv_j[1]), rtol=1e-6)
    B, T, plen = 3, 8, 5
    toks = rng.integers(0, hp.n_vocab, size=(B, T)).astype(np.int32)
    kv_j = jm.KVCache.zeros(hp, B, jnp.float32, quant=True)
    kv_p = pm.KVCache.zeros(hp, B, torch.float32, quant=True)
    lg_j, kv_j, _ = jm.decoder_forward(jp, hp, jnp.asarray(toks), jnp.int32(0), kv_j,
                                       ckj, cv_j, jnp.float32, logit_rows=jnp.int32(plen - 1))
    lg_p, kv_p, _ = pm.decoder_forward(pp, hp, t(toks).long(), 0, kv_p, ckp, cvp,
                                       torch.float32, logit_rows=plen - 1)
    np.testing.assert_allclose(lg_p.numpy(), np.asarray(lg_j), rtol=1e-4, atol=1e-4)
    for i, fork in enumerate([None, [2, 0, 0], None]):
        step = rng.integers(0, hp.n_vocab, size=(B, 1)).astype(np.int32)
        pos = plen + i
        lg_j, kv_j, _ = jm.decoder_forward(
            jp, hp, jnp.asarray(step), jnp.int32(pos), kv_j, ckj, cv_j, jnp.float32,
            fork_src=None if fork is None else jnp.asarray(fork, jnp.int32))
        lg_p, kv_p, _ = pm.decoder_forward(
            pp, hp, t(step).long(), pos, kv_p, ckp, cvp, torch.float32,
            fork_src=None if fork is None else torch.tensor(fork))
        np.testing.assert_allclose(lg_p.numpy(), np.asarray(lg_j), rtol=1e-4, atol=1e-4)
    for codes, scales, jc, js in ((kv_p.k, kv_p.ks, kv_j.k, kv_j.ks),
                                  (kv_p.v, kv_p.vs, kv_j.v, kv_j.vs)):
        n = plen + 3
        got = codes[:, :, :, :n].float() * scales[:, :, :, :n, None]
        want = np.asarray(jc)[:, :, :, :n].astype(np.float32) * np.asarray(js)[:, :, :, :n, None]
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1.01 * float(np.asarray(js).max()))
        assert (codes[:, :, :, :n].float() - t(np.asarray(jc)[:, :, :, :n]).float()
                ).abs().max() <= 1


# -------------------------------------------------------------- end to end

def decisive(mod, strategy_name, beam=5):
    p = mod.FullParams.default(getattr(mod.SamplingStrategy, strategy_name))
    p.beam_search.beam_size = beam
    p.temperature_inc = 0.0
    p.print_progress = False
    p.no_timestamps = True
    p.max_tokens = 10
    p.suppress_regex = r"<syn\d\d\d+>"
    return p


@pytest.fixture(scope="module")
def audio_12s():
    rng = np.random.default_rng(11)
    sr = 16000
    x = np.arange(12 * sr) / sr
    sig = np.sin(2 * np.pi * 180 * x) * (0.5 + 0.5 * np.sin(2 * np.pi * 1.3 * x))
    return (0.3 * sig + 0.02 * rng.standard_normal(x.shape)).astype(np.float32)


def _segments(st):
    return [(s.text, s.t0, s.t1, [tk.id for tk in s.tokens]) for s in st.segments]


def _same_transcript(ps, js):
    """Segments equal (text, t0, t1, token ids); token log-probabilities
    within 1e-4 (measured <= 1.2e-5: float32 sums in another order, and an
    int8 code that a float32 midpoint may round either way)."""
    assert js.full_n_segments() > 0
    assert _segments(ps) == _segments(js)
    np.testing.assert_allclose([tk.plog for s in ps.segments for tk in s.tokens],
                               [tk.plog for s in js.segments for tk in s.tokens],
                               rtol=0, atol=1e-4)


def _run_both(arg, entry, kv_dtype, strategy, audio):
    jctx = getattr(wt.WhisperContext, entry)(arg, wt.ContextParams(
        dtype="float32", keep_quantized=True, kv_dtype=kv_dtype))
    pctx = getattr(pt.WhisperContext, entry)(arg, pt.ContextParams(
        dtype="float32", keep_quantized=True, kv_dtype=kv_dtype, use_gpu=False))
    assert "q" in pctx.params["decoder"]["blocks"][0]["mlp_0"]
    assert pctx.kv_quant == (kv_dtype == "int8")
    js, ps = jctx.create_state(), pctx.create_state()
    js.full(decisive(wt, strategy), audio)
    ps.full(decisive(pt, strategy), audio)
    _same_transcript(ps, js)


@pytest.mark.parametrize("ttype,entry,kv_dtype", [
    (jquant.GGML_TYPE_Q8_0, "new_with_params", ""),
    (jquant.GGML_TYPE_Q5_0, "from_buffer", "int8"),
], ids=["q8_0", "q5_0_int8kv"])
@pytest.mark.parametrize("strategy", ["GREEDY", "BEAM_SEARCH"])
def test_keep_quantized_segments_match(tmp_path, audio_12s, ttype, entry, kv_dtype,
                                       strategy):
    """Q8_0 and Q5_0 tiny checkpoints through each entry point with
    keep_quantized (Q5_0 also with the int8 KV cache), greedy and beam-5."""
    hp = jinit.tiny_test_hparams()
    data = _checkpoint_bytes(jggml, hp, _make_test_tensors(hp, ttype=ttype, seed=4))
    path = tmp_path / "q.bin"
    path.write_bytes(data)
    arg = str(path) if entry == "new_with_params" else data
    _run_both(arg, entry, kv_dtype, strategy, audio_12s)


def test_kquant_keep_quantized_segments_match(tmp_path, audio_12s):
    """A Q5_K checkpoint (offset operand, width 256 with 4 heads of 64),
    written by the port's quantizer from an f16 file, greedy."""
    hp = _hp_256()
    src = tmp_path / "f16.bin"
    src.write_bytes(_checkpoint_bytes(
        jggml, hp, _make_test_tensors(hp, ttype=jquant.GGML_TYPE_F16, seed=5)))
    ptool.quantize_model(str(src), str(tmp_path / "q5k.bin"), "q5_k")
    _run_both(str(tmp_path / "q5k.bin"), "new_with_params", "", "GREEDY",
              audio_12s[: 6 * 16000])


def _sharp_contexts(kv_dtype):
    """The sharpened random tiny model of tests/test_kv_quant.py:18-29
    (token embedding x 8) in both packages, on the same weights."""
    jctx = wt.WhisperContext.random(hp=jinit.tiny_test_hparams(), seed=11,
                                    params=wt.ContextParams(dtype="float32",
                                                            kv_dtype=kv_dtype))
    jctx.params = dict(jctx.params)
    jctx.params["decoder"] = dict(jctx.params["decoder"])
    jctx.params["decoder"]["token_embed"] = jctx.params["decoder"]["token_embed"] * 8.0
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jctx.params),
                             jctx.hparams, "float32")
    model = ploader.LoadedModel(jctx.hparams, params, jctx.mel_filters, jctx.vocab, -1)
    return jctx, pt.WhisperContext(model, pt.ContextParams(
        use_gpu=False, dtype="float32", kv_dtype=kv_dtype))


@pytest.mark.parametrize("beam", [0, 5], ids=["greedy", "beam5"])
def test_int8_kv_segments_match(beam):
    """kv_dtype="int8" on the sharpened random tiny model, greedy and
    beam-5."""
    rng = np.random.default_rng(4)
    audio = (0.1 * rng.standard_normal(16000 * 2)).astype(np.float32)
    jctx, pctx = _sharp_contexts("int8")
    assert pctx.kv_quant
    strategy = "BEAM_SEARCH" if beam else "GREEDY"
    js, ps = jctx.create_state(), pctx.create_state()
    js.full(decisive(wt, strategy), audio)
    ps.full(decisive(pt, strategy), audio)
    assert isinstance(ps.cross_k, tuple) and ps.cross_k[0].dtype == torch.int8
    _same_transcript(ps, js)
