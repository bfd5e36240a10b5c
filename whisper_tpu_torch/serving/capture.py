"""Live audio capture — the mic front-end for stream/command serving.

Counterpart of whisper_tpu/serving/capture.py (host code only).

reference: examples/common-sdl.{h,cpp} `audio_async` (ring buffer of the
last len_ms of mic audio, SDL callback writes, `get(ms)` reads the tail;
common-sdl.cpp:9-227). The equivalent here keeps the same shape —
a thread-safe ring written by an audio callback, `get(ms)` / `drain()`
readers — but the device backend is pluggable: `sounddevice` (PortAudio)
when importable (`--capture` in serving/stream.py and serving/command.py),
and any object implementing start(callback)/stop() can be injected, which
is how tests drive it without audio hardware (FakeCaptureDevice below).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import numpy as np

from whisper_tpu_torch.config import SAMPLE_RATE


class FakeCaptureDevice:
    """Test/replay double for a capture backend: push() stands in for the
    hardware callback (reference tests use SDL's dummy audio driver the
    same way)."""

    def __init__(self, samples: Optional[np.ndarray] = None,
                 chunk: int = SAMPLE_RATE // 10):
        self._samples = samples
        self._chunk = chunk
        self._cb: Optional[Callable[[np.ndarray], None]] = None
        self.started = False

    def start(self, callback: Callable[[np.ndarray], None]) -> None:
        self._cb = callback
        self.started = True

    def stop(self) -> None:
        self.started = False

    def push(self, samples: np.ndarray) -> None:
        assert self.started and self._cb is not None, "device not started"
        self._cb(np.asarray(samples, np.float32))

    def replay_all(self) -> None:
        """Feed the preloaded samples through the callback in chunks."""
        assert self._samples is not None
        for i in range(0, len(self._samples), self._chunk):
            self.push(self._samples[i:i + self._chunk])


class SoundDeviceBackend:
    """PortAudio mic capture via the optional `sounddevice` package."""

    def __init__(self, device=None, sample_rate: int = SAMPLE_RATE):
        import sounddevice  # optional dependency; ImportError -> caller

        self._sd = sounddevice
        self._device = device
        self._rate = sample_rate
        self._stream = None

    def start(self, callback: Callable[[np.ndarray], None]) -> None:
        def _cb(indata, frames, time_info, status):
            callback(np.asarray(indata[:, 0], np.float32))

        self._stream = self._sd.InputStream(
            samplerate=self._rate, channels=1, dtype="float32",
            device=self._device, callback=_cb)
        self._stream.start()

    def stop(self) -> None:
        if self._stream is not None:
            self._stream.stop()
            self._stream.close()
            self._stream = None


class AudioCapture:
    """Ring buffer of the last len_ms of captured audio (audio_async).

    get(ms)  — snapshot of the most recent `ms` of audio (reference
               audio_async::get, common-sdl.cpp:151-186).
    drain()  — all samples since the previous drain (bounded by the ring),
               the natural feeder for StreamTranscriber.feed().
    """

    def __init__(self, len_ms: int = 10000, sample_rate: int = SAMPLE_RATE,
                 backend=None, device=None):
        self.sample_rate = sample_rate
        self._n = max(1, sample_rate * len_ms // 1000)
        self._ring = np.zeros(self._n, np.float32)
        self._pos = 0          # next write index
        self._count = 0        # total samples ever written
        self._filled = 0       # valid samples currently in the ring (<= _n)
        self._drained = 0      # total samples returned by drain()
        self._lock = threading.Lock()
        self.backend = backend if backend is not None else \
            SoundDeviceBackend(device=device, sample_rate=sample_rate)
        self._running = False

    # -- callback side -----------------------------------------------------
    def _on_audio(self, samples: np.ndarray) -> None:
        if not self._running:      # paused: drop, like audio_async::callback
            return
        s = np.asarray(samples, np.float32).reshape(-1)
        with self._lock:
            if len(s) >= self._n:
                self._ring[:] = s[-self._n:]
                self._pos = 0
            else:
                end = self._pos + len(s)
                if end <= self._n:
                    self._ring[self._pos:end] = s
                else:
                    k = self._n - self._pos
                    self._ring[self._pos:] = s[:k]
                    self._ring[:end - self._n] = s[k:]
                self._pos = end % self._n
            self._count += len(s)
            self._filled = min(self._n, self._filled + len(s))

    # -- control -----------------------------------------------------------
    def resume(self) -> None:
        if not self._running:
            self._running = True
            self.backend.start(self._on_audio)

    def pause(self) -> None:
        if self._running:
            self._running = False
            self.backend.stop()

    def clear(self) -> None:
        """Drop buffered audio (reference audio_async::clear resets the
        valid-length counter, so get() afterwards returns only NEW
        samples — not a zero-padded window)."""
        with self._lock:
            self._ring[:] = 0.0
            self._pos = 0
            self._filled = 0
            self._drained = self._count

    def __enter__(self):
        self.resume()
        return self

    def __exit__(self, *exc):
        self.pause()

    # -- read side ---------------------------------------------------------
    def _tail(self, n: int) -> np.ndarray:
        start = (self._pos - n) % self._n
        if start + n <= self._n:
            return self._ring[start:start + n].copy()
        k = self._n - start
        return np.concatenate([self._ring[start:], self._ring[:n - k]])

    def get(self, ms: int) -> np.ndarray:
        """Last `ms` milliseconds, clamped to the audio actually buffered
        since start/clear (reference audio_async::get)."""
        n = min(self._n, self.sample_rate * ms // 1000)
        with self._lock:
            return self._tail(min(n, self._filled))

    def drain(self) -> np.ndarray:
        """Samples captured since the last drain (clamped to the ring: if
        the reader stalls past len_ms, the overwritten prefix is gone —
        same loss semantics as the reference ring)."""
        with self._lock:
            n = min(self._count - self._drained, self._n)
            self._drained = self._count
            if n <= 0:
                return np.zeros(0, np.float32)
            return self._tail(n)


def run_capture_loop(feed: Callable[[np.ndarray], object],
                     capture: AudioCapture,
                     seconds: Optional[float] = None,
                     step_ms: int = 500,
                     sleep: Callable[[float], None] = None) -> None:
    """Drive a feed() consumer (StreamTranscriber / CommandDetector) from a
    live capture: drain every step_ms, stop after `seconds` (None = until
    KeyboardInterrupt) — the reference stream/command main loops
    (stream.cpp:247-380, command.cpp main) with the SDL poll replaced by
    the ring drain. `sleep` is injectable for tests."""
    import time as _time

    sleep = sleep or _time.sleep
    deadline = None if seconds is None else _time.monotonic() + seconds
    with capture:
        try:
            while deadline is None or _time.monotonic() < deadline:
                sleep(step_ms / 1000.0)
                chunk = capture.drain()
                if len(chunk):
                    feed(chunk)
        except KeyboardInterrupt:
            pass
