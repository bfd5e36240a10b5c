"""The port's model functions against the JAX package's, in float32 on the
CPU on the same weights (carried across with params_from_jax) and the same
inputs. Tolerance 1e-4 throughout: summation order only, well inside the
2e-3 / 3e-3 the JAX package is held to against HF transformers
(tests/test_torch_parity.py:65, 91)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.checkpoint import init as jinit
from whisper_tpu.models import whisper as jm
from whisper_tpu_torch.checkpoint.from_jax import params_from_jax
from whisper_tpu_torch.models import whisper as pm

TOL = 1e-4


@pytest.fixture(scope="module")
def model():
    hp = jinit.tiny_test_hparams()
    jp = jax.tree_util.tree_map(jnp.asarray, jinit.random_params(hp, 2, "float32"))
    pp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), hp, "float32")
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((1, hp.n_mels, 2 * hp.n_audio_ctx)).astype(np.float32)
    enc_j = jm.encoder_forward(jp, hp, jnp.asarray(mel), jnp.float32)
    ck_j, cv_j = jm.cross_attention_kv(jp, hp, enc_j)
    return hp, jp, pp, mel, enc_j, ck_j, cv_j


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want), rtol=tol, atol=tol)


def t(a):
    return torch.from_numpy(np.array(a))


def test_encoder_and_cross_kv(model):
    hp, jp, pp, mel, enc_j, ck_j, cv_j = model
    enc_p = pm.encoder_forward(pp, hp, t(mel), torch.float32)
    close(enc_p, enc_j)
    ck_p, cv_p = pm.cross_attention_kv(pp, hp, enc_p)
    assert ck_p.shape == ck_j.shape == (hp.n_text_layer, 1, hp.n_text_head,
                                        hp.n_audio_ctx, hp.n_text_state // hp.n_text_head)
    close(ck_p, ck_j)
    close(cv_p, cv_j)


def test_encoder_with_attn_fn_hook(model):
    """encode() passes the flash-attention wrapper as attn_fn on CUDA; on
    CPU tensors the wrapper's plain version must give the same encoder."""
    from whisper_tpu_torch.ops.flash_attention import flash_attention
    hp, jp, pp, mel, enc_j, _, _ = model
    close(pm.encoder_forward(pp, hp, t(mel), torch.float32, flash_attention), enc_j)


def _prompt_pass(model, B, T, prompt_len):
    """A B-row prompt pass (T-row bucket, real length prompt_len) against a
    shared (batch-1) cross K/V, logits only at row prompt_len-1."""
    hp, jp, pp, _, _, ck_j, cv_j = model
    rng = np.random.default_rng(B * 100 + T)
    toks = rng.integers(0, hp.n_vocab, size=(B, T)).astype(np.int32)
    kv_j = jm.KVCache.zeros(hp, B, jnp.float32)
    lg_j, kv_j, _ = jm.decoder_forward(jp, hp, jnp.asarray(toks), jnp.int32(0), kv_j,
                                       ck_j, cv_j, jnp.float32,
                                       logit_rows=jnp.int32(prompt_len - 1))
    kv_p = pm.KVCache.zeros(hp, B, torch.float32)
    lg_p, kv_p, _ = pm.decoder_forward(pp, hp, t(toks).long(), 0, kv_p, t(ck_j), t(cv_j),
                                       torch.float32, logit_rows=prompt_len - 1)
    return (lg_j, kv_j), (lg_p, kv_p)


@pytest.mark.parametrize("B,T,prompt_len", [(1, 8, 3), (3, 64, 64)])
def test_prompt_pass_logit_rows(model, B, T, prompt_len):
    hp = model[0]
    (lg_j, kv_j), (lg_p, kv_p) = _prompt_pass(model, B, T, prompt_len)
    assert lg_p.shape == (B, 1, hp.n_vocab) and lg_p.dtype == torch.float32
    close(lg_p, lg_j)
    close(kv_p.k[:, :, :, :T], kv_j.k[:, :, :, :T])
    close(kv_p.v[:, :, :, :T], kv_j.v[:, :, :, :T])


def _steps(model, forks):
    """Incremental T=1 steps after a 3-row prompt pass; forks[i] is the
    fork_src of step i (None = no fork)."""
    hp, jp, pp, _, _, ck_j, cv_j = model
    B, T, plen = 3, 8, 5
    (_, kv_j), (_, kv_p) = _prompt_pass(model, B, T, plen)
    rng = np.random.default_rng(9)
    for i, fork in enumerate(forks):
        toks = rng.integers(0, hp.n_vocab, size=(B, 1)).astype(np.int32)
        pos = plen + i
        lg_j, kv_j, _ = jm.decoder_forward(
            jp, hp, jnp.asarray(toks), jnp.int32(pos), kv_j, ck_j, cv_j, jnp.float32,
            fork_src=None if fork is None else jnp.asarray(fork, jnp.int32))
        lg_p, kv_p, _ = pm.decoder_forward(
            pp, hp, t(toks).long(), pos, kv_p, t(ck_j), t(cv_j), torch.float32,
            fork_src=None if fork is None else torch.tensor(fork))
        close(lg_p, lg_j)
        close(kv_p.k[:, :, :, : pos + 1], kv_j.k[:, :, :, : pos + 1])
        close(kv_p.v[:, :, :, : pos + 1], kv_j.v[:, :, :, : pos + 1])


def test_five_incremental_steps(model):
    _steps(model, [None] * 5)


def test_beam_fork_steps(model):
    # a non-identity fork persists: later steps read the forked history
    _steps(model, [None, [2, 0, 0], None, [1, 1, 2], None])


def test_position_clamp_and_unported_options(model):
    hp, jp, pp, _, _, ck_j, cv_j = model
    toks = np.full((1, 1), 7, np.int32)
    pos = hp.n_text_ctx + 3          # past the table: clamped to the last row
    kv_j = jm.KVCache.zeros(hp, 1, jnp.float32)
    kv_p = pm.KVCache.zeros(hp, 1, torch.float32)
    lg_j, _, _ = jm.decoder_forward(jp, hp, jnp.asarray(toks), jnp.int32(pos), kv_j,
                                    ck_j, cv_j, jnp.float32)
    lg_p, _, _ = pm.decoder_forward(pp, hp, t(toks).long(), pos, kv_p, t(ck_j),
                                    t(cv_j), torch.float32)
    close(lg_p, lg_j)
    assert kv_p.k.shape[3] == 512
    # collect_cross_qk is this slice's now: per-layer float32 probabilities
    _, _, qk = pm.decoder_forward(pp, hp, t(toks).long(), 0, pm.KVCache.zeros(hp, 1, torch.float32),
                                  t(ck_j), t(cv_j), torch.float32, collect_cross_qk=True)
    assert qk.shape == (hp.n_text_layer, 1, hp.n_text_head, 1, hp.n_audio_ctx)
    assert qk.dtype == torch.float32
    close(qk.sum(-1), np.ones(qk.shape[:-1], np.float32))
    # per-row positions are this slice's now: a (B,) pos0 past the table
    # clamps per row like the scalar one (tests/test_torch_port_batch.py
    # holds the merged path to the JAX package's)
    lg_r, _, _ = pm.decoder_forward(pp, hp, t(toks).long(), torch.tensor([pos]),
                                    pm.KVCache.zeros(hp, 1, torch.float32),
                                    t(ck_j), t(cv_j), torch.float32)
    close(lg_r, lg_j)
    # the int8 cache is this slice's now: int8 codes, float32 scales
    kvq = pm.KVCache.zeros(hp, 1, quant=True)
    assert kvq.quantized and kvq.k.dtype == torch.int8 and kvq.ks.shape == kvq.k.shape[:-1]


def test_linear_bf16_adds_bias_before_rounding():
    """bf16 linear: float32 accumulation, the float32 bias added before the
    one rounding to bf16 (the JAX package's linear, models/whisper.py:41-54)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 96)).astype(np.float32)
    w = rng.standard_normal((96, 40)).astype(np.float32) * 0.1
    b = rng.standard_normal(40).astype(np.float32)
    want = jm.linear(jnp.asarray(x, jnp.bfloat16),
                     {"w": jnp.asarray(w, jnp.bfloat16), "b": jnp.asarray(b)})
    got = pm.linear(t(x).bfloat16(), {"w": t(w.T).bfloat16(), "b": t(b)})
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
