"""Voice-command detection.

Counterpart of whisper_tpu/serving/command.py. The model runs on the first
CUDA device; -ng in main runs it on the CPU.

reference examples/command/command.cpp (778 LoC): two modes —
 - guided: a fixed list of allowed commands; each detected utterance is
   transcribed and matched against the list (the reference scores commands
   by token probability; here by normalized edit distance over the
   transcript, which is equivalent at the word level)
 - grammar: free-form transcription constrained by a GBNF grammar

Both consume audio through the energy-VAD gate from serving/stream.py, so
any audio source works (file simulation below, mic upstream).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from whisper_tpu_torch.api import WhisperContext
from whisper_tpu_torch.config import ContextParams, FullParams, SAMPLE_RATE
from whisper_tpu_torch.eval.wer import wer_details
from whisper_tpu_torch.serving.stream import vad_simple


@dataclasses.dataclass
class CommandParams:
    """reference command.cpp whisper_params (:20-60)."""

    prompt_ms: int = 5000
    command_ms: int = 8000
    vad_thold: float = 0.6
    freq_thold: float = 100.0
    language: str = "en"
    grammar: Optional[str] = None       # GBNF text -> grammar mode
    grammar_rule: str = "root"


class CommandDetector:
    def __init__(self, ctx: WhisperContext, commands: List[str],
                 params: Optional[CommandParams] = None):
        self.ctx = ctx
        self.commands = commands
        self.p = params or CommandParams()
        self.buffer = np.zeros(0, np.float32)

    def _full_params(self) -> FullParams:
        fp = FullParams.default()
        fp.print_progress = False
        fp.no_timestamps = True
        fp.single_segment = True
        fp.language = self.p.language
        fp.temperature_inc = 0.0
        fp.max_tokens = 32
        if self.p.grammar:
            from whisper_tpu_torch.decoding.grammar import parse_gbnf
            fp.grammar_rules = parse_gbnf(self.p.grammar, self.p.grammar_rule)
        return fp

    def transcribe(self, samples: np.ndarray) -> str:
        st = self.ctx.create_state()
        st.full(self._full_params(), samples)
        return st.full_get_all_text()

    def best_command(self, text: str) -> Tuple[Optional[str], float]:
        """Match transcript to the allowed list by normalized WER
        (reference scores per-command token probs, command.cpp:460-520;
        word-level edit distance gives the same ranking for short phrases)."""
        best, best_score = None, 2.0
        for cmd in self.commands:
            d = wer_details(cmd, text, normalize=True)
            if d["wer"] < best_score:
                best, best_score = cmd, d["wer"]
        # reject weak matches like the reference's probability threshold
        if best_score > 0.5:
            return None, best_score
        return best, best_score

    def feed(self, samples: np.ndarray) -> List[Tuple[Optional[str], str]]:
        """Add audio; returns [(matched_command_or_None, raw_text)] for each
        detected utterance."""
        self.buffer = np.concatenate([self.buffer, np.asarray(samples, np.float32)])
        out = []
        window = int(self.p.command_ms / 1000 * SAMPLE_RATE)
        if len(self.buffer) > 2 * SAMPLE_RATE and vad_simple(
                self.buffer[-2 * SAMPLE_RATE:], SAMPLE_RATE, 1000,
                self.p.vad_thold, self.p.freq_thold):
            utterance = self.buffer[-window:]
            self.buffer = np.zeros(0, np.float32)
            text = self.transcribe(utterance)
            if text.strip():
                if self.p.grammar:
                    out.append((text.strip(), text))
                else:
                    cmd, _score = self.best_command(text)
                    out.append((cmd, text))
        return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="whisper-tpu-torch-command")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-f", "--file", default=None, help="audio to scan")
    ap.add_argument("--capture", nargs="?", const=-1, type=int, default=None,
                    metavar="DEVICE",
                    help="listen on a live microphone (optional PortAudio"
                         " device index; needs the sounddevice package)")
    ap.add_argument("--capture-seconds", type=float, default=None)
    ap.add_argument("-cmd", "--commands", default=None,
                    help="file with one allowed command per line")
    ap.add_argument("--grammar", default=None, help="GBNF grammar file")
    ap.add_argument("-l", "--language", default="en")
    ap.add_argument("-ng", "--no-gpu", action="store_true",
                    help="run the model on the CPU")
    args = ap.parse_args(argv)

    commands: List[str] = []
    if args.commands:
        with open(args.commands) as f:
            commands = [l.strip() for l in f if l.strip()]

    p = CommandParams(language=args.language)
    if args.grammar:
        with open(args.grammar) as f:
            p.grammar = f.read()

    if (args.file is None) == (args.capture is None):
        ap.error("exactly one of -f/--file or --capture is required")

    ctx = WhisperContext.new_with_params(args.model,
                                         ContextParams(use_gpu=not args.no_gpu))
    det = CommandDetector(ctx, commands, p)

    def report(results):
        for cmd, text in results:
            if cmd:
                print(f"detected command: {cmd!r}  (heard: {text.strip()!r})")
            else:
                print(f"no command match  (heard: {text.strip()!r})")

    if args.capture is not None:
        # live mic (reference command.cpp audio_async bring-up)
        from whisper_tpu_torch.serving.capture import AudioCapture, run_capture_loop
        try:
            cap = AudioCapture(device=None if args.capture < 0 else args.capture)
        except ImportError:
            print("live capture needs the `sounddevice` package "
                  "(pip install sounddevice)", flush=True)
            return 1
        run_capture_loop(lambda s: report(det.feed(s)), cap,
                         seconds=args.capture_seconds)
        return 0

    from whisper_tpu_torch.audio.io import read_wav

    samples, _ = read_wav(args.file)
    chunk = SAMPLE_RATE // 2
    for i in range(0, len(samples), chunk):
        report(det.feed(samples[i : i + chunk]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
