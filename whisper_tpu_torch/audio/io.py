"""Audio I/O and PCM conversion utilities (numpy and the standard library).

The port's own copy of whisper_tpu/audio/io.py, with the same functions
and outputs.

Reproduces the reference's Rust audio utilities (src/utilities.rs:21-151)
and the examples' strict WAV handling (examples/full_usage/src/main.rs:7-27):
16 kHz mono f32 is the pipeline's native format.
"""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np

from whisper_tpu_torch.config import SAMPLE_RATE


def convert_integer_to_float_audio(samples: np.ndarray) -> np.ndarray:
    """i16 PCM -> f32 in [-1, 1) by /32768 (reference src/utilities.rs:21-45)."""
    return (np.asarray(samples, dtype=np.int16).astype(np.float32)) / 32768.0


def convert_stereo_to_mono_audio(samples: np.ndarray) -> np.ndarray:
    """Interleaved stereo f32 -> mono mean (reference src/utilities.rs:64-82).
    Raises on odd-length input like the reference's error path."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        if samples.size % 2 != 0:
            raise ValueError("stereo sample buffer has odd length")
        samples = samples.reshape(-1, 2)
    return samples.mean(axis=-1).astype(np.float32)


def convert_stereo_i16_to_mono_f32(samples: np.ndarray) -> np.ndarray:
    return convert_stereo_to_mono_audio(convert_integer_to_float_audio(samples))


def normalize_audio(samples: np.ndarray, peak: float = 1.0) -> np.ndarray:
    """Peak-normalize (reference src/utilities.rs:122-151)."""
    samples = np.asarray(samples, dtype=np.float32)
    mx = np.abs(samples).max() if samples.size else 0.0
    if mx == 0.0:
        return samples
    return samples * (peak / mx)


def resample_linear(samples: np.ndarray, sr_in: int, sr_out: int = SAMPLE_RATE) -> np.ndarray:
    """Linear resampler for non-16 kHz input (the reference cli shells out to
    ffmpeg for this — examples/ffmpeg-transcode.cpp; a linear fallback keeps
    the pure-Python path dependency-free)."""
    if sr_in == sr_out:
        return np.asarray(samples, dtype=np.float32)
    n_out = int(round(samples.shape[-1] * sr_out / sr_in))
    x_out = np.arange(n_out, dtype=np.float64) * (sr_in / sr_out)
    return np.interp(x_out, np.arange(samples.shape[-1]), samples).astype(np.float32)


def _decode_pcm_frames(raw: bytes, sw: int) -> np.ndarray:
    """Flat f32 samples from raw PCM frame bytes at sample width `sw`.

    Python's `wave` only opens format-1 (integer PCM) files — it raises on
    IEEE-float WAVs — so 4-byte samples are ALWAYS int32 here. One decoder
    shared by read_wav and _read_wav_channels so the width handling cannot
    drift.
    """
    if sw == 2:
        return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    if sw == 1:
        return (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                - 128.0) / 128.0
    if sw == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        vals = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16))
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        return vals.astype(np.float32) / float(1 << 23)
    if sw == 4:
        return np.frombuffer(raw, dtype="<i4").astype(np.float32) / float(1 << 31)
    raise ValueError(f"unsupported WAV sample width {sw}")


def read_wav(path: str, require_16khz_mono: bool = False) -> Tuple[np.ndarray, int]:
    """Read a PCM WAV file -> (float32 mono samples, sample_rate).

    Handles 8/16/24/32-bit int PCM; downmixes stereo; optionally enforces
    the reference examples' strict 16 kHz mono check.
    """
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n_ch = w.getnchannels()
        sw = w.getsampwidth()
        raw = w.readframes(w.getnframes())

    data = _decode_pcm_frames(raw, sw)
    if n_ch > 1:
        data = data.reshape(-1, n_ch).mean(axis=1).astype(np.float32)

    if require_16khz_mono and (sr != SAMPLE_RATE or n_ch != 1):
        raise ValueError(f"expected 16 kHz mono WAV, got {sr} Hz {n_ch}ch")
    if sr != SAMPLE_RATE:
        data = resample_linear(data, sr, SAMPLE_RATE)
        sr = SAMPLE_RATE
    return data, sr


def write_wav(path: str, samples: np.ndarray, sr: int = SAMPLE_RATE) -> None:
    """Write mono float32 [-1,1] samples as 16-bit PCM (test fixtures)."""
    pcm = np.clip(np.asarray(samples, dtype=np.float32), -1.0, 1.0)
    pcm16 = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm16.tobytes())


def _read_wav_channels(path: str) -> Tuple[np.ndarray, int, int]:
    """Raw WAV read keeping channels: (samples[N, C] f32, sr, n_channels).
    All PCM widths keep their channels (reference read_audio_data keeps
    both channels for every supported width, examples/common-whisper.cpp:42)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n_ch = w.getnchannels()
        sw = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    data = _decode_pcm_frames(raw, sw)
    return data.reshape(-1, n_ch), sr, n_ch


def _ffmpeg_decode(path: str, stereo: bool) -> Tuple[np.ndarray, int]:
    """Decode any container/codec via an ffmpeg subprocess to 16 kHz f32 PCM.

    Plays the role of the reference's miniaudio/stb_vorbis decoders
    (examples/common-whisper.cpp:42 read_audio_data supports wav/mp3/flac/
    ogg) and its ffmpeg transcode path (examples/ffmpeg-transcode.cpp).
    Returns (samples[N, C], n_channels). Raises FileNotFoundError when
    ffmpeg is absent.
    """
    import subprocess

    n_ch = 2 if stereo else 1
    cmd = ["ffmpeg", "-nostdin", "-v", "error", "-i", path,
           "-f", "f32le", "-acodec", "pcm_f32le",
           "-ac", str(n_ch), "-ar", str(SAMPLE_RATE), "pipe:1"]
    out = subprocess.run(cmd, capture_output=True, check=True)
    data = np.frombuffer(out.stdout, dtype="<f4").astype(np.float32)
    return data.reshape(-1, n_ch), n_ch


def read_audio_data(path: str, stereo: bool = False):
    """Read wav/mp3/flac/ogg/... -> (mono f32 @16 kHz, per-channel list or None).

    Mirrors the reference's read_audio_data (examples/common-whisper.cpp:42):
    returns the mono downmix always, plus per-channel f32 streams when
    `stereo` is requested (used by the CLI's --diarize). WAV is decoded
    natively; other formats shell out to ffmpeg when available.
    """
    pcmf32s = None
    if path.lower().endswith(".wav"):
        try:
            chans, sr, n_ch = _read_wav_channels(path)
        except (wave.Error, EOFError) as e:
            raise ValueError(f"failed to read WAV '{path}': {e}") from e
        mono = chans.mean(axis=1).astype(np.float32)
        if sr != SAMPLE_RATE:
            mono = resample_linear(mono, sr, SAMPLE_RATE)
            chans = np.stack([resample_linear(chans[:, c], sr, SAMPLE_RATE)
                              for c in range(n_ch)], axis=1)
        if stereo and n_ch == 2:
            pcmf32s = [chans[:, 0].copy(), chans[:, 1].copy()]
        return mono, pcmf32s

    chans, n_ch = _ffmpeg_decode(path, stereo)
    mono = chans.mean(axis=1).astype(np.float32)
    if stereo and n_ch == 2:
        pcmf32s = [chans[:, 0].copy(), chans[:, 1].copy()]
    return mono, pcmf32s
