"""WAV input in the PyTorch port (whisper_tpu_torch/audio/io.py) against
the JAX package's audio/io.py: seeded PCM at 8, 16, 24 and 32 bits, mono
and stereo, 16 and 44.1 kHz, written with the standard library's `wave`
and read back by both packages. Every output must be bit-equal."""

import wave

import numpy as np
import pytest

from whisper_tpu.audio import io as jio
from whisper_tpu_torch.audio import io as pio

WIDTHS = [1, 2, 3, 4]
CHANNELS = [1, 2]
RATES = [16000, 44100]


def seeded_pcm(width, channels, rate, seconds=0.25, seed=0):
    """Raw little-endian PCM frames spanning the full range of `width`."""
    rng = np.random.default_rng(seed + 10 * width + channels + rate)
    n = int(seconds * rate) * channels
    if width == 1:
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if width == 3:
        v = rng.integers(-(1 << 23), 1 << 23, n, dtype=np.int32)
        b = v.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3]
        return b.tobytes()
    dt = {2: "<i2", 4: "<i4"}[width]
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, n, dtype=np.int64, endpoint=True).astype(dt).tobytes()


@pytest.fixture
def wav_file(tmp_path):
    def make(width, channels, rate):
        path = tmp_path / f"pcm_{width}_{channels}_{rate}.wav"
        with wave.open(str(path), "wb") as w:
            w.setnchannels(channels)
            w.setsampwidth(width)
            w.setframerate(rate)
            w.writeframes(seeded_pcm(width, channels, rate))
        return str(path)
    return make


def assert_bit_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("channels", CHANNELS)
@pytest.mark.parametrize("width", WIDTHS)
def test_read_wav_bit_equal(wav_file, width, channels, rate):
    path = wav_file(width, channels, rate)
    (pd, psr), (jd, jsr) = pio.read_wav(path), jio.read_wav(path)
    assert psr == jsr == 16000
    assert_bit_equal(pd, jd)
    strict = channels == 1 and rate == 16000
    if strict:
        assert_bit_equal(pio.read_wav(path, True)[0], jio.read_wav(path, True)[0])
    else:
        for mod in (pio, jio):
            with pytest.raises(ValueError, match="16 kHz mono"):
                mod.read_wav(path, require_16khz_mono=True)


@pytest.mark.parametrize("stereo", [False, True])
@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("channels", CHANNELS)
@pytest.mark.parametrize("width", WIDTHS)
def test_read_audio_data_bit_equal(wav_file, width, channels, rate, stereo):
    path = wav_file(width, channels, rate)
    (pm, pch), (jm, jch) = pio.read_audio_data(path, stereo), jio.read_audio_data(path, stereo)
    assert_bit_equal(pm, jm)
    if jch is None:
        assert pch is None
    else:
        assert stereo and channels == 2 and len(pch) == len(jch) == 2
        for a, b in zip(pch, jch):
            assert_bit_equal(a, b)
    chans_p, sr_p, n_p = pio._read_wav_channels(path)
    chans_j, sr_j, n_j = jio._read_wav_channels(path)
    assert (sr_p, n_p) == (sr_j, n_j) == (rate, channels)
    assert_bit_equal(chans_p, chans_j)


@pytest.mark.parametrize("width", WIDTHS)
def test_decode_pcm_frames_bit_equal(width):
    raw = seeded_pcm(width, 2, 16000, seed=3)
    assert_bit_equal(pio._decode_pcm_frames(raw, width), jio._decode_pcm_frames(raw, width))


def test_bad_width_and_bad_file(tmp_path):
    for mod in (pio, jio):
        with pytest.raises(ValueError, match="sample width"):
            mod._decode_pcm_frames(b"\0" * 10, 5)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF....not a wav")
    for mod in (pio, jio):
        with pytest.raises(ValueError, match="failed to read WAV"):
            mod.read_audio_data(str(bad))


@pytest.mark.parametrize("sr_in,sr_out", [(44100, 16000), (8000, 16000), (16000, 16000),
                                          (22050, 16000), (16000, 48000)])
def test_resample_linear_bit_equal(sr_in, sr_out):
    x = np.random.default_rng(sr_in).standard_normal(sr_in // 7).astype(np.float32)
    assert_bit_equal(pio.resample_linear(x, sr_in, sr_out), jio.resample_linear(x, sr_in, sr_out))


def test_conversions_bit_equal():
    rng = np.random.default_rng(1)
    i16 = rng.integers(-32768, 32767, 4000, endpoint=True).astype(np.int16)
    f32 = rng.standard_normal(4000).astype(np.float32)
    assert_bit_equal(pio.convert_integer_to_float_audio(i16),
                     jio.convert_integer_to_float_audio(i16))
    assert_bit_equal(pio.convert_stereo_to_mono_audio(f32), jio.convert_stereo_to_mono_audio(f32))
    assert_bit_equal(pio.convert_stereo_to_mono_audio(f32.reshape(-1, 2)),
                     jio.convert_stereo_to_mono_audio(f32.reshape(-1, 2)))
    assert_bit_equal(pio.convert_stereo_i16_to_mono_f32(i16),
                     jio.convert_stereo_i16_to_mono_f32(i16))
    for peak in (1.0, 0.5):
        assert_bit_equal(pio.normalize_audio(f32, peak), jio.normalize_audio(f32, peak))
    zeros = np.zeros(10, np.float32)
    assert_bit_equal(pio.normalize_audio(zeros), jio.normalize_audio(zeros))
    for mod in (pio, jio):
        with pytest.raises(ValueError, match="odd length"):
            mod.convert_stereo_to_mono_audio(f32[:5])


def test_write_wav_bit_equal(tmp_path):
    x = (0.9 * np.sin(np.arange(8000) / 7.0)).astype(np.float32)
    x[::97] = 1.5                       # clipped
    pio.write_wav(str(tmp_path / "p.wav"), x, 16000)
    jio.write_wav(str(tmp_path / "j.wav"), x, 16000)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    got, sr = pio.read_wav(str(tmp_path / "p.wav"), require_16khz_mono=True)
    assert sr == 16000 and got.shape == x.shape
