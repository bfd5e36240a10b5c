"""Real-time streaming transcription — sliding window / energy-VAD modes.

Counterpart of whisper_tpu/serving/stream.py. The model runs on the first
CUDA device; -ng in main runs it on the CPU.

reference examples/stream/stream.cpp (window params :20-139, main loop
:247-380) and examples/common.cpp vad_simple / high_pass_filter.

Mic capture is out of scope in this environment; StreamTranscriber exposes
a feed(samples) API that any audio source drives (the CLI below reads a WAV
in real-time-sized chunks to simulate one, like the reference's tests)."""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from whisper_tpu_torch.api import WhisperContext
from whisper_tpu_torch.config import ContextParams, FullParams, SAMPLE_RATE


def high_pass_filter(data: np.ndarray, cutoff: float, sample_rate: int) -> np.ndarray:
    """One-pole high-pass (reference common.cpp high_pass_filter).

    y[i] = alpha*(y[i-1] + x[i] - x[i-1]) — an IIR with transfer
    H(z) = alpha*(1 - z^-1) / (1 - alpha*z^-1), evaluated via
    scipy.signal.lfilter when available: the interpreted per-sample loop
    costs tens of ms per 2 s VAD poll on the stream/command hot path. The
    loop fallback keeps the module dependency-free."""
    rc = 1.0 / (2.0 * np.pi * cutoff)
    dt = 1.0 / sample_rate
    alpha = dt / (rc + dt)
    if len(data) == 0:
        return np.empty_like(data)
    try:
        from scipy.signal import lfilter
    except ImportError:
        out = np.empty_like(data)
        y = data[0]
        out[0] = y
        for i in range(1, len(data)):
            y = alpha * (y + data[i] - data[i - 1])
            out[i] = y
        return out
    # first output is x[0] by construction; feed the recurrence from i=1
    # with initial condition y[0] = x[0]
    x = np.asarray(data, np.float64)
    b = np.array([alpha, -alpha])
    a = np.array([1.0, -alpha])
    # DFII-transposed state after emitting y[0] = x[0]:
    # z = b1*x[0] - a1*y[0] = -alpha*x[0] + alpha*x[0] = 0
    out = np.empty_like(x)
    out[0] = x[0]
    if len(x) > 1:
        out[1:], _ = lfilter(b, a, x[1:], zi=np.zeros(1))
    return out.astype(data.dtype)


def vad_simple(pcmf32: np.ndarray, sample_rate: int, last_ms: int,
               vad_thold: float, freq_thold: float) -> bool:
    """True when the last `last_ms` is silent relative to the whole buffer
    (reference common.cpp vad_simple)."""
    n = len(pcmf32)
    n_last = sample_rate * last_ms // 1000
    if n_last >= n:
        return False
    x = pcmf32
    if freq_thold > 0:
        x = high_pass_filter(x.astype(np.float32), freq_thold, sample_rate)
    energy_all = float(np.abs(x).mean())
    energy_last = float(np.abs(x[n - n_last:]).mean())
    return not energy_last > vad_thold * energy_all


@dataclasses.dataclass
class StreamParams:
    """reference stream.cpp whisper_params (:19-46)."""

    step_ms: int = 3000
    length_ms: int = 10000
    keep_ms: int = 200
    vad_thold: float = 0.6
    freq_thold: float = 100.0
    max_tokens: int = 32
    audio_ctx: int = 0
    language: str = "en"
    translate: bool = False
    no_context: bool = True


class StreamTranscriber:
    """Push PCM in; get incremental transcripts out.

    Sliding-window mode (step_ms > 0): every step, transcribe the last
    `length_ms` of audio with the previous window's tail (`keep_ms`) and
    prompt tokens carried over; a "new line" commit happens every
    length/step - 1 steps (reference :137, :247-380).

    VAD mode (step_ms <= 0): wait for energy-silence at the end of the
    buffer, then transcribe the utterance."""

    def __init__(self, ctx: WhisperContext, params: Optional[StreamParams] = None,
                 on_segment: Optional[Callable[[str, bool], None]] = None):
        self.ctx = ctx
        self.p = params or StreamParams()
        self.p.keep_ms = min(self.p.keep_ms, self.p.step_ms) if self.p.step_ms > 0 else self.p.keep_ms
        self.p.length_ms = max(self.p.length_ms, self.p.step_ms)
        self.use_vad = self.p.step_ms <= 0
        self.n_step = int(1e-3 * self.p.step_ms * SAMPLE_RATE) if not self.use_vad else 0
        self.n_len = int(1e-3 * self.p.length_ms * SAMPLE_RATE)
        self.n_keep = int(1e-3 * self.p.keep_ms * SAMPLE_RATE)
        self.n_new_line = max(1, self.p.length_ms // self.p.step_ms - 1) if not self.use_vad else 1

        self.on_segment = on_segment or (lambda text, committed: None)
        self.buffer = np.zeros(0, np.float32)
        self.pcm_old = np.zeros(0, np.float32)
        self.prompt_tokens: List[int] = []
        self.n_iter = 0
        self.committed: List[str] = []
        self.current: str = ""

    def _full_params(self) -> FullParams:
        fp = FullParams.default()
        fp.print_progress = False
        fp.no_timestamps = not self.use_vad
        fp.single_segment = not self.use_vad
        fp.max_tokens = self.p.max_tokens
        fp.language = self.p.language
        fp.translate = self.p.translate
        fp.audio_ctx = self.p.audio_ctx
        fp.temperature_inc = 0.0  # no fallback in streaming (reference :223)
        if not self.p.no_context and self.prompt_tokens:
            fp.prompt_tokens = list(self.prompt_tokens)
        return fp

    def feed(self, samples: np.ndarray) -> List[str]:
        """Add audio; returns any newly available transcript lines."""
        self.buffer = np.concatenate([self.buffer, np.asarray(samples, np.float32)])
        out: List[str] = []
        if self.use_vad:
            # bound the backlog like the reference's ring buffer: only the
            # last length_ms can ever be transcribed (stream.cpp
            # audio.get(params.length_ms)), so keep no more than that
            if len(self.buffer) > self.n_len:
                self.buffer = self.buffer[-self.n_len:]
            # transcribe when the tail goes silent (reference :287-300)
            if len(self.buffer) > 2 * SAMPLE_RATE and vad_simple(
                    self.buffer[-2 * SAMPLE_RATE:], SAMPLE_RATE, 1000,
                    self.p.vad_thold, self.p.freq_thold):
                text = self._transcribe(self.buffer)
                self.buffer = np.zeros(0, np.float32)
                if text.strip():
                    self.committed.append(text)
                    self.on_segment(text, True)
                    out.append(text)
            return out

        while len(self.buffer) >= self.n_step:
            chunk, self.buffer = self.buffer[: self.n_step], self.buffer[self.n_step:]
            # reference window budget is keep + length - new (stream.cpp:273)
            # — dropping n_keep would clip the committed-line overlap one
            # step early
            take_old = min(len(self.pcm_old),
                           max(0, self.n_keep + self.n_len - len(chunk)))
            window = np.concatenate([self.pcm_old[-take_old:] if take_old else
                                     np.zeros(0, np.float32), chunk])
            text = self._transcribe(window)
            self.pcm_old = window
            self.current = text
            self.on_segment(text, False)
            self.n_iter += 1
            if self.n_iter % self.n_new_line == 0:
                # commit line; keep the tail for context (reference :366-380)
                self.committed.append(text)
                out.append(text)
                self.current = ""
                self.pcm_old = window[-self.n_keep:] if self.n_keep else np.zeros(0, np.float32)
                if not self.p.no_context:
                    self.prompt_tokens = [
                        td.id for s in self._last_segments for td in s.tokens]
        return out

    def _transcribe(self, window: np.ndarray) -> str:
        state = self.ctx.create_state()
        fp = self._full_params()
        state.full(fp, window)
        self._last_segments = state.segments
        return "".join(s.text for s in state.segments)

    def flush(self) -> Optional[str]:
        """Force-transcribe whatever remains (end of stream)."""
        data = np.concatenate([self.pcm_old, self.buffer]) if not self.use_vad else self.buffer
        self.buffer = np.zeros(0, np.float32)
        if len(data) < SAMPLE_RATE // 10:
            return None
        text = self._transcribe(data)
        if text.strip():
            self.committed.append(text)
            self.on_segment(text, True)
        return text


def main(argv=None) -> int:
    """Simulated real-time transcription from a WAV file."""
    import argparse

    ap = argparse.ArgumentParser(prog="whisper-tpu-torch-stream")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-f", "--file", default=None,
                    help="WAV replayed in real-time-sized chunks")
    ap.add_argument("--capture", nargs="?", const=-1, type=int, default=None,
                    metavar="DEVICE",
                    help="capture from a live microphone (optional PortAudio"
                         " device index; needs the sounddevice package)")
    ap.add_argument("--capture-seconds", type=float, default=None,
                    help="stop live capture after this many seconds")
    ap.add_argument("--step", type=int, default=3000)
    ap.add_argument("--length", type=int, default=10000)
    ap.add_argument("--keep", type=int, default=200)
    ap.add_argument("-l", "--language", default="en")
    ap.add_argument("--draft-model", default=None,
                    help="speculative-decoding draft checkpoint")
    ap.add_argument("-ng", "--no-gpu", action="store_true",
                    help="run the model on the CPU")
    args = ap.parse_args(argv)
    if (args.file is None) == (args.capture is None):
        ap.error("exactly one of -f/--file or --capture is required")

    ctx = WhisperContext.new_with_params(
        args.model, ContextParams(use_gpu=not args.no_gpu, draft_model=args.draft_model))
    sp = StreamParams(step_ms=args.step, length_ms=args.length,
                      keep_ms=args.keep, language=args.language)
    st = StreamTranscriber(ctx, sp, on_segment=lambda t, c: print(
        ("[commit] " if c else "[...] ") + t, flush=True))

    if args.capture is not None:
        # live mic (reference stream.cpp:247-258 audio_async bring-up)
        from whisper_tpu_torch.serving.capture import AudioCapture, run_capture_loop
        try:
            cap = AudioCapture(len_ms=args.length,
                               device=None if args.capture < 0 else args.capture)
        except ImportError:
            print("live capture needs the `sounddevice` package "
                  "(pip install sounddevice)", flush=True)
            return 1
        run_capture_loop(st.feed, cap, seconds=args.capture_seconds,
                         step_ms=min(args.step, 500))
    else:
        from whisper_tpu_torch.audio.io import read_wav
        samples, _ = read_wav(args.file)
        chunk = SAMPLE_RATE // 2
        for i in range(0, len(samples), chunk):
            st.feed(samples[i : i + chunk])
    st.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
