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
    # a contiguous view that does not start on a 16-byte boundary: the
    # kernel loads 16 bytes at a time
    qs = torch.randn(q.numel() + 2, device="cuda")[2:].view_as(q)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(qs, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("bh", [1, 20, 40])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
def test_flash_attention_tiling_edges(bh, dtype, tol):
    """Every edge of the query tiles (64 rows in float32, 128 in bf16), the
    64-key tiles and the key splits: Tq and Tk on both sides of a tile
    boundary, one row, one key."""
    _need_cuda()
    from whisper_tpu_torch.ops.flash_attention import plan_splits
    g = torch.Generator(device="cuda").manual_seed(bh)
    for tq in (1, 8, 40, 64, 65, 127, 128, 129, 1500):
        for tk in (1, 63, 64, 131, 1500):
            q = torch.randn(1, bh, tq, 64, device="cuda", generator=g).to(dtype)
            k = torch.randn(1, bh, tk, 64, device="cuda", generator=g).to(dtype)
            v = torch.randn(1, bh, tk, 64, device="cuda", generator=g).to(dtype)
            before = flash_attention.launches
            out = flash_attention(q, k, v)
            torch.cuda.synchronize()
            assert flash_attention.launches == before + 1   # one per call, split or not
            assert out.dtype == dtype and out.shape == q.shape
            err = (out.float() - flash_attention_plain(q, k, v).float()).abs().max().item()
            assert err <= tol, (bh, tq, tk, plan_splits(bh, tq, tk), err)


def _quantized_weight(fmt, n_in, n_out, seed):
    """q, d, m (or None), qblock on the card: a seeded weight through the
    port's quantizer and the loader's int8 block repack."""
    import numpy as np
    from whisper_tpu_torch.checkpoint import loader, quant
    from whisper_tpu_torch.tools.quantize import NAME_TO_TYPE
    ttype = NAME_TO_TYPE[fmt]
    w = np.random.default_rng(seed).standard_normal((n_out, n_in)).astype(np.float32) * 0.03
    leaves = loader.quantized_leaves(quant.quantize(w, ttype), ttype, n_out, n_in)
    return [torch.from_numpy(leaves[k]).cuda() if k in leaves else None
            for k in "qdm"] + [quant.int8_block_size(ttype)]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["q5_0", "q8_0", "q6_k", "q5_1", "q5_k", "q2_k"])
def test_quant_matmul_matches_plain(fmt):
    """B2 (no offset) and B3 (offset) against the plain version on the
    card, skinny (M <= 16) and wide paths, ragged M and OUT tiles. Both
    round the same bf16 operands; only the order of the float32 sums
    differs: 1e-3 of max(1, max|y|)."""
    _need_cuda()
    from whisper_tpu_torch.ops.quant_matmul import quant_matmul, quant_matmul_plain
    g = torch.Generator(device="cuda").manual_seed(0)
    for m_rows, n_in, n_out in ((1, 1280, 1280), (5, 512, 1536), (16, 256, 272),
                                (70, 1280, 512), (17, 768, 144)):
        q, d, m, bs = _quantized_weight(fmt, n_in, n_out, seed=m_rows)
        x = torch.randn(m_rows, n_in, device="cuda", generator=g).bfloat16()
        counter = "launches" if m is None else "launches_offset"
        before = getattr(quant_matmul, counter)
        y = quant_matmul(x, q, d, m, bs)
        torch.cuda.synchronize()
        assert getattr(quant_matmul, counter) == before + 1
        ref = quant_matmul_plain(x, q, d, m, bs)
        assert y.dtype == torch.float32 and y.shape == (m_rows, n_out)
        err = (y - ref).abs().max().item()
        assert err <= 1e-3 * max(1.0, ref.abs().max().item()), (fmt, m_rows, n_in, n_out, err)


@pytest.mark.cuda
def test_quant_matmul_rejects_what_it_cannot_take():
    _need_cuda()
    from whisper_tpu_torch.ops.quant_matmul import quant_matmul
    q, d, m, bs = _quantized_weight("q5_1", 256, 128, seed=0)
    x = torch.randn(2, 256, device="cuda")
    with pytest.raises(ValueError, match="int8 q"):
        quant_matmul(x, q.float(), d, m, bs)
    with pytest.raises(ValueError, match="float32 d"):
        quant_matmul(x, q, d.bfloat16(), m, bs)
    with pytest.raises(ValueError, match="qblock"):
        quant_matmul(x, q, d, m, 64)
    with pytest.raises(ValueError, match="multiple of 16"):
        quant_matmul(x, q[:, :120].contiguous(), d[:, :120].contiguous(),
                     m[:, :120].contiguous(), bs)
    with pytest.raises(ValueError, match="x's device"):
        quant_matmul(x, q.cpu(), d, m, bs)
    # contiguous views that do not start on a 16-byte boundary: the kernel
    # loads 16 bytes at a time
    xs = torch.randn(2 * 256 + 4, device="cuda").bfloat16()[4:].view(2, 256)
    with pytest.raises(ValueError, match="16-byte"):
        quant_matmul(xs, q, d, m, bs)
    dd = torch.cat([d.flatten(), d.flatten()[:1]])[1:].view_as(d)
    with pytest.raises(ValueError, match="16-byte"):
        quant_matmul(x, q, dd, m, bs)


# (qblock, offset) of the six formats chip_smoke.py checks
QMM_FORMATS = {"q5_0": (32, False), "q8_0": (32, False), "q6_k": (16, False),
               "q5_1": (32, True), "q5_k": (32, True), "q2_k": (16, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", list(QMM_FORMATS))
def test_quant_matmul_wide_path_edges(fmt):
    """The wide path (M > 16) at every edge of its 128 x 128 tiles and
    64-row k-tiles: M on both sides of 128, OUT a multiple of 16 but not of
    128, IN a multiple of qblock but not of 64 (48 with qblock 16). The
    operands are drawn directly (all int8 codes, random scales and
    offsets), since the quantizer takes only whole super-blocks."""
    _need_cuda()
    from whisper_tpu_torch.ops.quant_matmul import quant_matmul, quant_matmul_plain
    qblock, offset = QMM_FORMATS[fmt]
    g = torch.Generator(device="cuda").manual_seed(qblock + offset)
    for n_in in (48, 96, 1280, 5120):
        if n_in % qblock:
            continue
        for n_out in (16, 144, 1280, 5120):
            q = torch.randint(-128, 128, (n_in, n_out), device="cuda", generator=g,
                              dtype=torch.int8)
            d = torch.rand(n_in // qblock, n_out, device="cuda", generator=g) * 0.02
            m = (torch.randn(n_in // qblock, n_out, device="cuda", generator=g) * 0.1
                 if offset else None)
            for m_rows in (17, 127, 128, 129, 1500):
                x = torch.randn(m_rows, n_in, device="cuda", generator=g).bfloat16()
                y = quant_matmul(x, q, d, m, qblock)
                ref = quant_matmul_plain(x, q, d, m, qblock)
                torch.cuda.synchronize()
                assert y.shape == (m_rows, n_out) and bool(torch.isfinite(y).all())
                err = (y - ref).abs().max().item()
                assert err <= 1e-3 * max(1.0, ref.abs().max().item()), (
                    fmt, m_rows, n_in, n_out, err)


def _drawn_operands(n_in, n_out, qblock, offset, g):
    """q, d, m (or None) drawn directly on the card: every int8 code,
    random scales and offsets."""
    q = torch.randint(-128, 128, (n_in, n_out), device="cuda", generator=g, dtype=torch.int8)
    d = torch.rand(n_in // qblock, n_out, device="cuda", generator=g) * 0.02
    m = (torch.randn(n_in // qblock, n_out, device="cuda", generator=g) * 0.1
         if offset else None)
    return q, d, m


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", list(QMM_FORMATS))
def test_quant_matmul_skinny_path_edges(fmt):
    """The skinny path (M <= 16) at every edge: each M of 1..16 (x tiles of
    8 and 16 rows), OUT a multiple of 16 on both sides of the 128-column
    tile (16, 144, 1280, 1296), IN from one block per cluster rank (48
    with qblock 16) to 5120, so that the cluster plan runs from 3 to 16
    ranks, and IN 16384, where a rank's share comes in two pieces of 512
    rows. One launch per call."""
    _need_cuda()
    from whisper_tpu_torch.ops.quant_matmul import quant_matmul, quant_matmul_plain
    qblock, offset = QMM_FORMATS[fmt]
    counter = "launches_offset" if offset else "launches"
    g = torch.Generator(device="cuda").manual_seed(qblock + offset + 1)
    shapes = [(n_in, n_out, range(1, 17)) for n_in in (48, 96, 1280, 5120)
              for n_out in (16, 144, 1280, 1296) if n_in % qblock == 0]
    for n_in, n_out, rows in shapes + [(16384, 144, (1, 9))]:
        q, d, m = _drawn_operands(n_in, n_out, qblock, offset, g)
        for m_rows in rows:
            x = torch.randn(m_rows, n_in, device="cuda", generator=g).bfloat16()
            before = getattr(quant_matmul, counter)
            y = quant_matmul(x, q, d, m, qblock)
            ref = quant_matmul_plain(x, q, d, m, qblock)
            torch.cuda.synchronize()
            assert getattr(quant_matmul, counter) == before + 1
            assert y.shape == (m_rows, n_out) and bool(torch.isfinite(y).all())
            err = (y - ref).abs().max().item()
            assert err <= 1e-3 * max(1.0, ref.abs().max().item()), (
                fmt, m_rows, n_in, n_out, err)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["q5_0", "q5_1", "q2_k"])
def test_quant_matmul_skinny_path_is_bit_identical_across_calls(fmt):
    """The skinny path sums in a fixed order (no atomics): repeated calls
    on the same inputs give the same bits, at large-v3's decode shapes and
    M = 1, 5, 8 and 16."""
    _need_cuda()
    from whisper_tpu_torch.ops.quant_matmul import quant_matmul
    qblock, offset = QMM_FORMATS[fmt]
    g = torch.Generator(device="cuda").manual_seed(7)
    for n_in, n_out in ((1280, 1280), (1280, 5120), (5120, 1280)):
        q, d, m = _drawn_operands(n_in, n_out, qblock, offset, g)
        for m_rows in (1, 5, 8, 16):
            x = torch.randn(m_rows, n_in, device="cuda", generator=g).bfloat16()
            first = quant_matmul(x, q, d, m, qblock)
            for _ in range(5):
                assert torch.equal(quant_matmul(x, q, d, m, qblock), first), (
                    fmt, m_rows, n_in, n_out)


@pytest.fixture
def no_tf32():
    """float32 on the card as float32 (cuDNN's convolutions default to TF32)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


TINY_ML = dict(n_vocab=51865, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2,
               n_audio_layer=2, n_text_ctx=448, n_text_state=128, n_text_head=2,
               n_text_layer=3, n_mels=80)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3])
def test_collect_cross_qk_on_card_matches_cpu(no_tf32, batch):
    """The DTW pass's cross-attention probabilities (the plain path) on the
    card against the CPU, float32, within 1e-5; the encoder on the card
    runs the flash kernel."""
    _need_cuda()
    from whisper_tpu_torch.checkpoint.init import random_params
    from whisper_tpu_torch.config import WhisperHParams
    from whisper_tpu_torch.models import whisper as m

    hp = WhisperHParams(**TINY_ML)
    mel = torch.randn(1, 80, 3000, generator=torch.Generator().manual_seed(5))
    toks = torch.randint(0, 50000, (batch, 13), generator=torch.Generator().manual_seed(6))
    out = {}
    for dev in ("cpu", "cuda"):
        p = random_params(hp, seed=3, compute_dtype="float32", device=dev)
        attn = flash_attention if dev == "cuda" else None
        enc = m.encoder_forward(p, hp, mel.to(dev), torch.float32, attn)
        ck, cv = m.cross_attention_kv(p, hp, enc)
        kv = m.KVCache.zeros(hp, batch, torch.float32, dev, size=128)
        before = flash_attention.launches
        _, _, qk = m.decoder_forward(p, hp, toks.to(dev), 0, kv, ck, cv, torch.float32,
                                     collect_cross_qk=True, logit_rows=0)
        assert flash_attention.launches == before     # collecting: the plain path
        out[dev] = qk.cpu()
    assert out["cuda"].shape == (3, batch, 2, 13, 1500)
    assert (out["cuda"] - out["cpu"]).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_dtw_full_on_card_matches_cpu(no_tf32):
    """full() with language auto-detection, the energy timestamps and DTW
    (N_TOP_MOST) on a tiny multilingual model, float32: the card's segments,
    per-token t0/t1 and t_dtw equal the CPU's (decisive config)."""
    _need_cuda()
    import numpy as np
    import whisper_tpu_torch as pt
    from whisper_tpu_torch.config import AlignmentHeadsPreset, DtwParams, WhisperHParams

    hp = WhisperHParams(**TINY_ML)
    rng = np.random.default_rng(0)
    t = np.arange(12 * 16000) / 16000
    audio = (0.3 * np.sin(2 * np.pi * 180 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 1.3 * t))
             + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)
    got = {}
    for use_gpu in (True, False):
        ctx = pt.WhisperContext.random(hp=hp, seed=4, params=pt.ContextParams(
            use_gpu=use_gpu, dtype="float32", dtw_token_timestamps=True,
            dtw=DtwParams(mode=AlignmentHeadsPreset.N_TOP_MOST)))
        p = pt.FullParams.default()
        p.language = "auto"
        p.token_timestamps = True
        p.temperature_inc = 0.0
        p.print_progress = False
        p.max_tokens = 10
        p.suppress_regex = r"<syn\d\d\d+>"
        st = ctx.create_state()
        st.full(p, audio)
        got[use_gpu] = (st.full_lang_id(), [
            (s.text, s.t0, s.t1, [(k.id, k.t0, k.t1, k.t_dtw) for k in s.tokens])
            for s in st.segments])
    assert got[True] == got[False] and got[True][1]


def _speech_like(seconds, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.7 * t)
    sig = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * 2.3 * t)) * (t % 3.0 < 2.0)
    sig = sig * env + 0.01 * rng.standard_normal(t.shape)
    return (0.3 * sig / np.abs(sig).max()).astype(np.float32)


@pytest.mark.cuda
def test_vad_on_card_matches_cpu_with_tf32_on():
    """The VAD forward on the card against the CPU, with the caller's TF32
    switched on for cuDNN and matmuls: the module computes in full float32
    whatever the setting, so the probabilities agree within 1e-5 and the
    segments are equal (the random model's final conv scaled by 64 to
    spread its probabilities; threshold their 75th percentile)."""
    _need_cuda()
    import numpy as np
    from whisper_tpu_torch.config import VadParams
    from whisper_tpu_torch.models import vad

    model = vad.random_vad_model(0)
    model.params["_model.decoder.decoder.2.weight"] *= 64
    audio = _speech_like(31, 2)                   # > 30 s: 969 windows
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        card = vad.detect_speech(model, audio, "cuda")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    cpu = vad.detect_speech(model, audio, "cpu")
    assert card.shape == cpu.shape == (-(-len(audio) // 512),)
    assert np.abs(card - cpu).max() <= 1e-5
    p = VadParams(threshold=float(np.percentile(cpu, 75)))
    segs = [vad.segments_from_probs(x, p) for x in (card, cpu)]
    assert [(s.start, s.end) for s in segs[0]] == [(s.start, s.end) for s in segs[1]]
    assert segs[1]


@pytest.mark.cuda
@pytest.mark.parametrize("beam", [0, 5])
def test_full_batch_on_card_matches_cpu(no_tf32, beam):
    """full_batch on the card (the batched encode and prompt pass through
    the flash kernel) against the CPU: 3 utterances of different lengths
    through 2 lanes (a refill), greedy and beam-5, float32, decisive
    config: equal segments and equal lane statistics."""
    _need_cuda()
    import numpy as np
    import whisper_tpu_torch as pt
    from whisper_tpu_torch.config import WhisperHParams

    hp = WhisperHParams(**{**TINY_ML, "n_vocab": 51864})
    audios = [_speech_like(s, i) for i, s in enumerate((4, 9, 2))]
    got = {}
    for use_gpu in (True, False):
        ctx = pt.WhisperContext.random(hp=hp, seed=5, params=pt.ContextParams(
            use_gpu=use_gpu, dtype="float32"))
        p = pt.FullParams.default(pt.SamplingStrategy.BEAM_SEARCH if beam
                                  else pt.SamplingStrategy.GREEDY)
        p.beam_search.beam_size = max(beam, 1)
        p.temperature_inc = 0.0
        p.print_progress = False
        p.no_timestamps = True
        p.max_tokens = 10
        p.suppress_regex = r"<syn\d\d\d+>"
        stats = {}
        before = flash_attention.launches
        res = ctx.full_batch(p, audios, n_lanes=2, stats=stats)
        assert (flash_attention.launches > before) == use_gpu
        got[use_gpu] = ([[(s.text, s.t0, s.t1, [k.id for k in s.tokens]) for s in u]
                         for u in res], stats)
    assert got[True] == got[False]
    assert got[True][1]["admitted"] == 3 and all(got[True][0])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8])
def test_speculative_full_on_card_matches_cpu(no_tf32, k):
    """full() with a draft model (another seed's, token embeddings of both
    sharpened x 8 for decisive argmaxes) on the card against the same on
    the CPU, float32, at spec_k 1 and 8: equal segments and acceptance
    counts, and on each device the same segments as full() without the
    draft. At k = 8 the verify chunk's cross-attention runs the flash
    kernel."""
    _need_cuda()
    import whisper_tpu_torch as pt
    from whisper_tpu_torch.config import WhisperHParams

    hp = WhisperHParams(**{**TINY_ML, "n_vocab": 51864})
    audio = _speech_like(8, 3)
    got = {}
    for use_gpu in (True, False):
        cp = pt.ContextParams(use_gpu=use_gpu, dtype="float32", spec_k=k)
        ctx, draft = (pt.WhisperContext.random(hp=hp, seed=s, params=cp) for s in (0, 123))
        for c in (ctx, draft):
            c.params["decoder"]["token_embed"] = c.params["decoder"]["token_embed"] * 8.0
        p = pt.FullParams.default()
        p.temperature_inc = 0.0
        p.print_progress = False
        p.no_timestamps = True
        p.max_tokens = 16
        st = ctx.create_state()
        st.full(p, audio)
        plain = [(s.text, s.t0, s.t1, [t.id for t in s.tokens]) for s in st.segments]
        ctx.attach_draft(draft)
        st = ctx.create_state()
        before = flash_attention.launches
        st.full(p, audio)
        spec = [(s.text, s.t0, s.t1, [t.id for t in s.tokens]) for s in st.segments]
        assert spec == plain and spec
        assert (flash_attention.launches > before) == use_gpu
        got[use_gpu] = (spec, st.spec_stats)
    assert got[True] == got[False]


@pytest.mark.cuda
def test_native_runtime_loads_on_the_card_machine():
    """The host runtime builds with g++ and loads on the card's machine,
    from the port's own _build/."""
    _need_cuda()
    import pathlib
    import numpy as np
    from whisper_tpu_torch.ops import build
    from whisper_tpu_torch.runtime import native

    assert native.available()
    assert pathlib.Path(native.get_lib()._name).parent == build.BUILD_DIR
    ti, tj = native.dtw(np.zeros((3, 4), np.float32))
    assert ti[-1] == 2 and tj[-1] == 3


@pytest.mark.cuda
def test_selfcheck_on_the_card():
    """utils/selfcheck.py's A/B check of B1 against its plain version."""
    _need_cuda()
    from whisper_tpu_torch.utils import selfcheck
    ok, err = selfcheck.flash_attention_ab_check()
    assert ok is True and 0 <= err <= 2e-2


@pytest.mark.cuda
def test_tally_counts_the_kernels_on_the_card():
    """tools/hbm_audit.py's tally sees the kernels' launches through their
    wrappers: B1 and B2 in an int8-block encode, B2 in a decode step, at
    width 128 (2 heads of 64, the kernel's head dim)."""
    _need_cuda()
    import dataclasses
    from whisper_tpu_torch.checkpoint.init import tiny_test_hparams
    from whisper_tpu_torch.tools import hbm_audit

    hp = dataclasses.replace(tiny_test_hparams(), n_audio_state=128, n_text_state=128)
    enc = hbm_audit.audit_encode(hp=hp, weights="q5", device="cuda")
    assert enc["by_class_gb"].get("B1", 0) > 0 and enc["by_class_gb"].get("B2", 0) > 0
    step = hbm_audit.audit_decode_step(hp=hp, weights="q5", kv="int8", beam=5, n_utt=2,
                                       device="cuda")
    assert step["by_class_gb"].get("B2", 0) > 0 and step["launches_tallied_run"]["B2"] > 0
    assert step["step_ms"] > 0 and step["gb_per_s"] > 0
    assert step["per_token_gb"] == pytest.approx(step["step_total_gb"], rel=0.01)
