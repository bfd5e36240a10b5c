"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and the CUDA toolkit, skips without
them, and imports no JAX, so the file also runs on a machine with the card
and without JAX:

    python -m pytest tests/test_torch_port_cuda.py -q --noconftest

(`--noconftest`: tests/conftest.py imports JAX for the other tests).
chip_smoke.py checks the same kernels at the main path's shapes.
"""

import pytest
import torch

from whisper_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
def test_flash_attention_matches_plain(dtype, tol):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    for b, h, tq, tk in ((1, 20, 1500, 1500), (1, 20, 8, 1500), (1, 20, 40, 1500),
                         (2, 3, 70, 131), (1, 1, 1, 1), (3, 2, 65, 64)):
        q = torch.randn(b, h, tq, 64, device="cuda", generator=g).to(dtype)
        k = torch.randn(b, h, tk, 64, device="cuda", generator=g).to(dtype)
        v = torch.randn(b, h, tk, 64, device="cuda", generator=g).to(dtype)
        before = flash_attention.launches
        out = flash_attention(q, k, v)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        assert out.dtype == dtype and out.shape == q.shape
        err = (out.float() - flash_attention_plain(q, k, v).float()).abs().max().item()
        assert err <= tol, (b, h, tq, tk, err)


@pytest.mark.cuda
def test_flash_attention_takes_strided_views():
    """Heads split from (B, T, D) activations arrive as transposed views."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(3, 1, 96, 20 * 64, device="cuda", generator=g).bfloat16()
    q, k, v = (t.reshape(1, 96, 20, 64).transpose(1, 2) for t in x)
    assert not q.is_contiguous()
    err = (flash_attention(q, k, v).float()
           - flash_attention_plain(q, k, v).float()).abs().max().item()
    assert err <= 2e-2


@pytest.mark.cuda
def test_bf16_model_on_card_matches_cpu():
    """The bf16 model on the card (flash kernel, float32-output GEMMs)
    against the same model on the CPU (plain attention, widened operands):
    encoder, a prompt pass from position 0 and forked steps. bf16 rounds
    the activations at every layer, so the two agree to a few bf16 ulps of
    the logits' scale."""
    _need_cuda()
    from whisper_tpu_torch.checkpoint.init import random_params
    from whisper_tpu_torch.config import WhisperHParams
    from whisper_tpu_torch.models import whisper as m

    hp = WhisperHParams(n_vocab=51864, n_audio_ctx=1500, n_audio_state=128,
                        n_audio_head=2, n_audio_layer=2, n_text_ctx=448,
                        n_text_state=128, n_text_head=2, n_text_layer=3, n_mels=80)
    params = {dev: random_params(hp, seed=2, device=dev) for dev in ("cpu", "cuda")}
    mel = torch.randn(1, 80, 3000, generator=torch.Generator().manual_seed(3))
    toks = torch.randint(0, 50000, (3, 8), generator=torch.Generator().manual_seed(4))
    out = {}
    for dev, p in params.items():
        attn = flash_attention if dev == "cuda" else None
        enc = m.encoder_forward(p, hp, mel.to(dev), torch.bfloat16, attn)
        ck, cv = m.cross_attention_kv(p, hp, enc)
        kv = m.KVCache.zeros(hp, 3, torch.bfloat16, dev)
        lg = [m.decoder_forward(p, hp, toks.to(dev), 0, kv, ck, cv,
                                logit_rows=5)[0]]
        for i, fork in enumerate((None, [2, 0, 1], None)):
            fork = None if fork is None else torch.tensor(fork, device=dev)
            lg.append(m.decoder_forward(p, hp, toks[:, i:i + 1].to(dev), 6 + i, kv,
                                        ck, cv, fork_src=fork)[0])
        out[dev] = [enc.float().cpu()] + [x.cpu() for x in lg]
    for got, want in zip(out["cuda"], out["cpu"]):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= 3e-2 * want.abs().max()


@pytest.mark.cuda
def test_flash_attention_rejects_what_it_cannot_take():
    _need_cuda()
    q = torch.randn(1, 2, 8, 64, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :32], q[..., :32], q[..., :32])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="one dtype"):
        flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="shapes"):
        flash_attention(q, q[:, :1], q)
