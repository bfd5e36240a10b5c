"""Log-mel spectrogram frontend (PyTorch).

Counterpart of whisper_tpu/audio/mel.py, with the reference numerics
(log_mel_spectrogram, src/whisper.cpp:3186-3276 + worker at 3119-3183):

  - periodic Hann(400)  (fill_hann_window, src/whisper.cpp:3039-3047)
  - padding: reflect 200 samples at the start, then the signal, then
    30 s of zeros + 200 more (src/whisper.cpp:3205-3217)
  - n_len     = (padded - 400) // 160        (drop last frame)
  - n_len_org = 1 + (n + 200 - 400) / 160    (C truncation, frame_counts)
  - power spectrum re^2+im^2 over 201 bins, mel = filters @ power,
    log10(max(mel, 1e-10)), clamp to global max-8, (x+4)/4
    (src/whisper.cpp:3155-3181 + 3244-3260)

The spectrogram is one batched float32 `torch.fft.rfft` over every frame on
the target device, followed by the 201->n_mel projection as a matmul.
`log_mel_reference` is the float64 host oracle, independent of both.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from whisper_tpu_torch.config import (
    HOP_LENGTH,
    N_FFT,
    N_SAMPLES_PER_CHUNK,
    SAMPLE_RATE,
)

N_FFT_BINS = N_FFT // 2 + 1  # 201


def hann_window(n: int = N_FFT) -> np.ndarray:
    """Periodic Hann (reference fill_hann_window with periodic=true)."""
    i = np.arange(n, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / n))).astype(np.float32)


def mel_filterbank(
    n_mels: int = 80, n_fft: int = N_FFT, sr: int = SAMPLE_RATE
) -> np.ndarray:
    """Slaney-normalized mel filterbank, (n_mels, n_fft//2+1) float32.

    Matches librosa.filters.mel(htk=False, norm="slaney"), which is what the
    checkpoints' embedded filters were generated with (OpenAI whisper
    audio.py mel_filters). Real checkpoints carry their own filters
    (reference src/whisper.cpp:1594-1604); this standalone version covers
    stub/random models and the VAD STFT path.
    """
    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        mel = 3.0 * f / 200.0
        log_region = f >= 1000.0
        mel = np.where(log_region, 15.0 + np.log(np.maximum(f, 1e-9) / 1000.0) / (np.log(6.4) / 27.0), mel)
        return mel

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        f = 200.0 * m / 3.0
        log_region = m >= 15.0
        f = np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f)
        return f

    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    weights = weights * enorm[:, None]
    return weights.astype(np.float32)


def pad_audio(samples: np.ndarray) -> np.ndarray:
    """Reference padding (src/whisper.cpp:3205-3217): reflect 200 at the
    start, 30 s zeros + 200 at the end."""
    n = samples.shape[-1]
    stage_2 = N_FFT // 2  # 200
    head = samples[..., 1 : 1 + stage_2][..., ::-1]
    tail_len = N_SAMPLES_PER_CHUNK + stage_2
    tail = np.zeros(samples.shape[:-1] + (tail_len,), dtype=np.float32)
    return np.concatenate([head, samples.astype(np.float32), tail], axis=-1)


def frame_counts(n_samples: int) -> Tuple[int, int]:
    """(n_len, n_len_org) — total padded frames vs original-signal frames
    (reference src/whisper.cpp:3218-3223). C integer division truncates
    TOWARD ZERO; Python's // floors — they differ when the n_len_org
    numerator goes negative (audio < 200 samples), so use int(a/b)
    truncation like the C code (r4 review)."""
    stage_2 = N_FFT // 2
    padded = n_samples + N_SAMPLES_PER_CHUNK + 2 * stage_2
    n_len = (padded - N_FFT) // HOP_LENGTH           # numerator always > 0
    n_len_org = 1 + int((n_samples + stage_2 - N_FFT) / HOP_LENGTH)
    return n_len, n_len_org


def padded_frames_input(samples: np.ndarray) -> Tuple[np.ndarray, int, int]:
    """(padded samples, n_len, n_len_org): pad_audio's padding, extended
    with zeros to cover whole 30 s buckets of frames, as
    log_mel_spectrogram feeds log_mel_padded."""
    samples = np.asarray(samples, dtype=np.float32)
    n_len, n_len_org = frame_counts(samples.shape[-1])
    padded = pad_audio(samples)
    # frames are computed in 30 s buckets like the JAX package: the extra
    # frames read trailing zeros and produce the clamp floor, which cannot
    # raise the spectrogram max, so slicing back to n_len is value-exact
    n_len_b = -(-n_len // 3000) * 3000
    need = (n_len_b - 1) * HOP_LENGTH + N_FFT
    if need > padded.shape[-1]:
        padded = np.concatenate(
            [padded, np.zeros(need - padded.shape[-1], np.float32)])
    return padded, n_len, n_len_org


def log_mel_spectrogram(
    samples: np.ndarray,
    filters: np.ndarray,
    device="cpu",
) -> Tuple[torch.Tensor, int, int]:
    """Full-precision log-mel. Returns (mel[n_mel, n_len] float32 on
    `device`, n_len, n_len_org)."""
    padded, n_len, n_len_org = padded_frames_input(samples)
    x = torch.from_numpy(padded).to(device)
    window = torch.from_numpy(hann_window()).to(device)
    fb = torch.from_numpy(np.ascontiguousarray(filters, np.float32)).to(device)
    return log_mel_padded(x, fb, window, n_len), n_len, n_len_org


def log_mel_padded(x: torch.Tensor, fb: torch.Tensor, window: torch.Tensor,
                   n_len: int) -> torch.Tensor:
    """The device body of log_mel_spectrogram: the (n_mel, n_len) float32
    log-mel of padded samples `x` (padded_frames_input's), with the
    filters `fb` (n_mel, 201) and the Hann `window`, all on one device.
    Nothing crosses from the host."""
    n_len_b = -(-n_len // 3000) * 3000
    frames = x.unfold(0, N_FFT, HOP_LENGTH)[:n_len_b] * window   # (n_len_b, 400)
    spec = torch.fft.rfft(frames, n=N_FFT, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2                       # (n_len_b, 201)
    mel = power @ fb.T                                            # (n_len_b, n_mel)
    logmel = torch.log10(torch.clamp(mel, min=1e-10))
    logmel = torch.maximum(logmel, logmel.max() - 8.0)
    out = ((logmel + 4.0) / 4.0).T                                # (n_mel, n_len_b)
    return out[:, :n_len].contiguous()


def log_mel_reference(samples: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Slow float64 host implementation used as the golden model in tests
    (mirrors the C algorithm step-for-step, incl. the all-zero-frame
    shortcut). Independent of the torch path above."""
    samples = np.asarray(samples, dtype=np.float32)
    n = samples.shape[0]
    stage_2 = N_FFT // 2
    padded = pad_audio(samples)
    n_len, _ = frame_counts(n)
    window = hann_window().astype(np.float64)
    n_samples_eff = n + stage_2

    out = np.full((filters.shape[0], n_len), np.log10(1e-10), dtype=np.float64)
    n_compute = min(n_samples_eff // HOP_LENGTH + 1, n_len)
    for i in range(n_compute):
        off = i * HOP_LENGTH
        fr = padded[off : off + N_FFT].astype(np.float64) * window
        spec = np.fft.rfft(fr, n=N_FFT)
        power = spec.real**2 + spec.imag**2
        melrow = filters.astype(np.float64) @ power
        out[:, i] = np.log10(np.maximum(melrow, 1e-10))

    mmax = out.max() - 8.0
    out = np.maximum(out, mmax)
    return ((out + 4.0) / 4.0).astype(np.float32)
