"""Silero VAD in the PyTorch port against the JAX package: the ggml file
each package writes, the per-window probabilities (the port on the CPU,
the JAX package's jitted forward), the segmenter, the splicing and its
time mapping, the remap, full(vad=True), VadContext, the Silero converter
and the vad-speech-segments tool.

Random VAD weights give probabilities that hover near 0.5 (an all-zero
input gives exactly 0.5), so every threshold passes all of the audio or
none of it. Where a test needs kept speech and dropped silence it uses
`spread_vad_model`: the seeded random model with its final 1x1 conv
scaled by 64 (a power of two, exact in the file's float16), and takes
its threshold from the model's own probabilities on that audio
(`safe_threshold`: a percentile, moved until no probability lies within
1e-4 of it or of its hysteresis partner threshold - 0.15, so that the
1e-5 agreement of the two packages cannot flip a window)."""

import numpy as np
import pytest
import torch

import whisper_tpu as wt
import whisper_tpu_torch as pt
from whisper_tpu.checkpoint.init import tiny_test_hparams
from whisper_tpu.models import vad as jvad
from whisper_tpu_torch.errors import InitError
from whisper_tpu_torch.models import vad as pvad

PROB_TOL = 1e-5


def speech_like(seconds, seed):
    """Speech-like bursts (AM harmonics, 2 s on, 1 s of near silence) plus
    noise, 16 kHz."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.7 * t)
    sig = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * 2.3 * t)) * (t % 3.0 < 2.0)
    sig = sig * env + 0.01 * rng.standard_normal(t.shape)
    return (0.3 * sig / np.abs(sig).max()).astype(np.float32)


def spread_vad_model(seed=0, mod=pvad):
    m = mod.random_vad_model(seed)
    m.params["_model.decoder.decoder.2.weight"] = m.params["_model.decoder.decoder.2.weight"] * 64
    return m


def safe_threshold(probs, percentile):
    thr = float(np.percentile(probs, percentile))
    for _ in range(1000):
        if (np.abs(probs - thr).min() > 1e-4
                and np.abs(probs - max(thr - 0.15, 0.01)).min() > 1e-4):
            return thr
        thr += 2e-5
    raise AssertionError("no threshold clear of the probabilities")


def seg_pairs(segs):
    return [(s.start, s.end) for s in segs]


@pytest.fixture(scope="module")
def models():
    return {"random": (jvad.random_vad_model(0), pvad.random_vad_model(0)),
            "spread": (spread_vad_model(0, jvad), spread_vad_model(0, pvad))}


def test_ggml_files_cross_read(tmp_path, models):
    """The file each package writes reads back equal in the other; the
    random draws are the JAX package's for the same seed."""
    jm, pm_ = models["spread"]
    for k in jm.params:
        np.testing.assert_array_equal(pm_.params[k], jm.params[k])
    for writer, reader, src in ((pvad.write_vad_ggml, jvad.read_vad_ggml, pm_),
                                (jvad.write_vad_ggml, pvad.read_vad_ggml, jm)):
        path = str(tmp_path / "vad.bin")
        writer(path, src)
        got = reader(path)
        assert got.hparams.__dict__ == src.hparams.__dict__
        assert (got.model_type, got.version) == (src.model_type, src.version)
        assert list(got.params) == list(src.params)
        for k, v in src.params.items():
            np.testing.assert_array_equal(got.params[k], v, err_msg=k)
    with open(tmp_path / "bad.bin", "wb") as f:
        f.write(b"\0" * 16)
    with pytest.raises(ValueError, match="bad magic"):
        pvad.read_vad_ggml(str(tmp_path / "bad.bin"))


@pytest.mark.parametrize("n", [512 * 40, 16000 * 3 + 100, 300])
@pytest.mark.parametrize("which", ["random", "spread"])
def test_probs_match(models, n, which):
    """Within 1e-5 of vad_probs_jit, with the last window filled and
    zero-padded."""
    jm, pm_ = models[which]
    audio = speech_like(n / 16000, 3)[:n]
    want = jvad.detect_speech(jm, audio)
    got = pvad.detect_speech(pm_, audio, "cpu")
    assert got.dtype == np.float32 and got.shape == want.shape == (-(-n // 512),)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_TOL)
    assert len(pvad.detect_speech(pm_, np.zeros(0, np.float32))) == 0


def _vad_params(mod, **kw):
    p = mod.FullParams.default()
    for k, v in kw.items():
        setattr(p.vad_params, k, v)
    return p


class _State:
    """What vad_filter_audio reads of a state: the model and the device."""

    def __init__(self, model):
        self.vad_model = model
        self.ctx = type("Ctx", (), {"device": torch.device("cpu")})()


@pytest.mark.parametrize("variant", [dict(), dict(max_speech_duration_s=1.5),
                                     dict(min_silence_duration_ms=300, speech_pad_ms=80),
                                     dict(samples_overlap=0.0, min_speech_duration_ms=60)])
def test_segments_splice_and_remap_match(models, variant):
    """On the same probabilities, segments_from_probs, vad_filter_audio's
    samples and mapping, and remap_segment_times equal the JAX
    package's exactly."""
    jm, pm_ = models["spread"]
    audio = speech_like(9, 4)
    probs = jvad.detect_speech(jm, audio)
    thr = safe_threshold(probs, 60)
    jp, pp = _vad_params(wt, threshold=thr, **variant), _vad_params(pt, threshold=thr, **variant)
    want = jvad.segments_from_probs(probs, jp.vad_params)
    got = pvad.segments_from_probs(probs, pp.vad_params)
    assert seg_pairs(got) == seg_pairs(want) and len(got) >= 2
    j_audio, j_map = jvad.vad_filter_audio(_State(jm), audio, jp)
    p_audio, p_map = pvad.vad_filter_audio(_State(pm_), audio, pp)
    np.testing.assert_array_equal(p_audio, j_audio)
    assert p_map == j_map and len(p_map) > 4
    assert len(p_audio) < len(audio)          # silence dropped
    for t0 in range(-5, j_map[-1][0] + 20, 7):
        assert (pvad.map_processed_to_original_time(t0, p_map)
                == jvad.map_processed_to_original_time(t0, j_map))
        js, ps = wt.api.Segment(t0, t0 + 3, ""), pt.api.Segment(t0, t0 + 3, "")
        jvad.remap_segment_times(js, j_map)
        pvad.remap_segment_times(ps, p_map)
        assert (ps.t0, ps.t1) == (js.t0, js.t1)
    # no segment: no audio and an empty mapping
    none = _vad_params(pt, threshold=0.999)
    assert pvad.vad_filter_audio(_State(pm_), audio, none) == (None, [])


def _decisive(mod, vad_path, thr):
    p = mod.FullParams.default()
    p.print_progress = False
    p.temperature_inc = 0.0
    p.no_timestamps = True
    p.max_tokens = 12
    p.suppress_regex = r"<syn\d\d\d+>"
    p.vad = True
    p.vad_model_path = vad_path
    p.vad_params.threshold = thr
    return p


@pytest.fixture(scope="module")
def vad_path(tmp_path_factory, models):
    path = str(tmp_path_factory.mktemp("vad") / "vad.bin")
    pvad.write_vad_ggml(path, models["spread"][1])
    return path


def test_full_with_vad_matches(vad_path, models):
    """full(vad=True) on a tiny f32 model: the JAX package's segments, with
    the times remapped to the original audio; the no-speech case gives
    none."""
    from test_torch_port_e2e import port_context
    jctx = wt.WhisperContext.random(
        hp=tiny_test_hparams(), params=wt.ContextParams(dtype="float32"), seed=3)
    pctx = port_context(jctx)
    audio = speech_like(12, 5)
    thr = safe_threshold(jvad.detect_speech(models["spread"][0], audio), 75)
    js, ps = jctx.create_state(), pctx.create_state()
    js.full(_decisive(wt, vad_path, thr), audio)
    ps.full(_decisive(pt, vad_path, thr), audio)
    key = [(s.text, s.t0, s.t1, [t.id for t in s.tokens]) for s in js.segments]
    assert [(s.text, s.t0, s.t1, [t.id for t in s.tokens]) for s in ps.segments] == key
    assert ps.full_n_segments() >= 1 and ps.vad_mapping == js.vad_mapping
    assert ps.vad_model is not None                      # read once, kept by the state
    # the mapping moved the times: the spliced audio is shorter than the original
    assert ps.vad_mapping[-1][1] > ps.vad_mapping[-1][0]
    st = pctx.create_state()
    assert st.full(_decisive(pt, vad_path, 0.999), np.zeros(16000, np.float32)) == 0
    assert st.full_n_segments() == 0
    p = _decisive(pt, None, 0.5)
    with pytest.raises(ValueError, match="vad_model_path"):
        pctx.create_state().full(p, audio)


def test_vad_context(vad_path, models):
    """The object API (whisper.h:675-716) on the CPU against the JAX
    package's VadContext; the default context needs CUDA."""
    audio = speech_like(5, 6)
    jctx = wt.VadContext.init_from_file_with_params(vad_path)
    pctx = pt.VadContext.init_from_file_with_params(vad_path, pt.VadContextParams(use_gpu=False))
    assert pctx.device.type == "cpu"
    assert jctx.detect_speech(audio) and pctx.detect_speech(audio)
    assert pctx.n_probs == jctx.n_probs == -(-len(audio) // 512)
    np.testing.assert_allclose(pctx.probs, jctx.probs, rtol=0, atol=PROB_TOL)
    thr = safe_threshold(jctx.probs, 75)
    jp, pp = wt.VadParams(threshold=thr), pt.VadParams(threshold=thr)
    want = seg_pairs(jctx.segments_from_probs(jp))
    assert seg_pairs(pctx.segments_from_probs(pp)) == want and want
    assert seg_pairs(pctx.segments_from_samples(pp, audio)) == want
    assert seg_pairs(pvad.vad_segments_from_samples(models["spread"][1], audio, pp)) == want
    if not torch.cuda.is_available():
        with pytest.raises(InitError, match="use_gpu=False"):
            pt.VadContext.init_from_file_with_params(vad_path)


def test_convert_silero_state_dict(tmp_path):
    """A Silero-style torch state dict (keys without the `_model.` prefix,
    an 8 kHz branch to drop) converts as the JAX package converts it, and
    the file the tool writes reads back to the same model."""
    from whisper_tpu.checkpoint import convert_silero as jconv
    from whisper_tpu_torch.checkpoint import convert_silero as pconv
    ref = pvad.random_vad_model(seed=7)
    sd = {k[len("_model."):]: torch.from_numpy(np.asarray(v)) for k, v in ref.params.items()}
    sd["decoder.decoder.2.weight"] = sd["decoder.decoder.2.weight"].reshape(1, 128, 1)
    sd["_model_8k.encoder.0.reparam_conv.weight"] = torch.zeros(1)
    got = pconv.convert_silero_state_dict(sd, version="5.1.2")
    want = jconv.convert_silero_state_dict(sd, version="5.1.2")
    assert got.version == want.version == "5.1.2"
    assert list(got.params) == list(want.params) == pconv.TENSOR_KEYS
    for k in want.params:
        np.testing.assert_array_equal(got.params[k], want.params[k], err_msg=k)
    sd_path, out = str(tmp_path / "sd.pt"), str(tmp_path / "vad-ggml.bin")
    torch.save(sd, sd_path)
    assert pconv.main(["--output", out, "--state-dict", sd_path]) == 0
    loaded = pvad.read_vad_ggml(out)
    for k, v in ref.params.items():
        np.testing.assert_array_equal(loaded.params[k], v, err_msg=k)
    bad = dict(sd)
    del bad["stft.forward_basis_buffer"]
    with pytest.raises(ValueError, match="missing"):
        pconv.convert_silero_state_dict(bad)


def test_vad_segments_tool(tmp_path, vad_path, models, capsys):
    """The vad-speech-segments printer gives the JAX package's output with
    the same flags (on the CPU: -ng); an unreadable file returns 2."""
    from whisper_tpu.audio.io import write_wav
    from whisper_tpu.serving import vad_segments as jtool
    from whisper_tpu_torch.serving import vad_segments as ptool
    audio = speech_like(7, 8)
    wav = str(tmp_path / "a.wav")
    write_wav(wav, audio)
    thr = safe_threshold(jvad.detect_speech(models["spread"][0], audio), 70)
    args = ["-f", wav, "-vm", vad_path, "-vt", repr(thr), "-vspd", "120", "-vp", "40"]
    assert jtool.main(args) == 0
    want = capsys.readouterr().out
    assert ptool.main(args + ["-ng"]) == 0
    got = capsys.readouterr().out
    assert got == want and "Speech segment 0:" in got
    assert ptool.main(["-f", str(tmp_path / "nope.wav"), "-vm", vad_path, "-ng"]) == 2
    assert ptool.main(["-f", wav, "-vm", str(tmp_path / "nope.bin"), "-ng"]) == 1
