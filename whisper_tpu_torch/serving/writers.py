"""Transcript output writers: txt / vtt / srt / lrc / csv / json / score.

Counterpart of whisper_tpu/serving/writers.py: for the same segments it
writes the same bytes in every format; only system_info_string (the
"systeminfo" of the json dump) describes PyTorch and the CUDA devices.

reference examples/cli/cli.cpp:433-921 (formats matched byte-for-byte where
practical: header lines, timestamp formats, CSV escaping per rfc4180, JSON
layout of the full dump).
"""

from __future__ import annotations

import io
import json
from typing import List

import numpy as np

from whisper_tpu_torch import languages
from whisper_tpu_torch.api import Segment, WhisperContext
from whisper_tpu_torch.config import SAMPLE_RATE
from whisper_tpu_torch.decoding.segments import to_timestamp


def _timestamp_to_sample(t: int, n_samples: int) -> int:
    return max(0, min(n_samples - 1, (t * SAMPLE_RATE) // 100))


def estimate_diarization_speaker(pcmf32s, t0: int, t1: int, id_only: bool = False) -> str:
    """Stereo-energy speaker guess (reference cli.cpp:392-423)."""
    n = len(pcmf32s[0])
    i0 = _timestamp_to_sample(t0, n)
    i1 = _timestamp_to_sample(t1, n)
    e0 = float(np.abs(pcmf32s[0][i0:i1]).sum())
    e1 = float(np.abs(pcmf32s[1][i0:i1]).sum())
    if e0 > 1.1 * e1:
        speaker = "0"
    elif e1 > 1.1 * e0:
        speaker = "1"
    else:
        speaker = "?"
    return speaker if id_only else f"(speaker {speaker})"


def _speaker(params, pcmf32s, t0, t1, vtt=False) -> str:
    if not getattr(params, "diarize", False) or pcmf32s is None or len(pcmf32s) != 2:
        return ""
    if vtt:
        return "<v Speaker" + estimate_diarization_speaker(pcmf32s, t0, t1, True) + ">"
    return estimate_diarization_speaker(pcmf32s, t0, t1)


def write_txt(segments: List[Segment], f, params=None, pcmf32s=None) -> None:
    for s in segments:
        f.write(f"{_speaker(params, pcmf32s, s.t0, s.t1)}{s.text}\n")


def write_vtt(segments: List[Segment], f, params=None, pcmf32s=None) -> None:
    f.write("WEBVTT\n\n")
    for s in segments:
        f.write(f"{to_timestamp(s.t0)} --> {to_timestamp(s.t1)}\n")
        f.write(f"{_speaker(params, pcmf32s, s.t0, s.t1, vtt=True)}{s.text}\n\n")


def write_srt(segments: List[Segment], f, params=None, pcmf32s=None,
              offset_n: int = 0) -> None:
    for i, s in enumerate(segments):
        f.write(f"{i + 1 + offset_n}\n")
        f.write(f"{to_timestamp(s.t0, comma=True)} --> {to_timestamp(s.t1, comma=True)}\n")
        f.write(f"{_speaker(params, pcmf32s, s.t0, s.t1)}{s.text}\n\n")


def write_lrc(segments: List[Segment], f, params=None, pcmf32s=None) -> None:
    f.write("[by:whisper_tpu]\n")
    for s in segments:
        msec = s.t0 * 10
        minute = msec // (1000 * 60)
        msec -= minute * 1000 * 60
        sec = msec // 1000
        msec -= sec * 1000
        ts = f"{minute:02d}:{sec:02d}.{msec // 10:02d}"
        f.write(f"[{ts}]{_speaker(params, pcmf32s, s.t0, s.t1)}{s.text}\n")


def _csv_escape(text: str) -> str:
    return text.replace('"', '""')


def write_csv(segments: List[Segment], f, params=None, pcmf32s=None) -> None:
    diarize = getattr(params, "diarize", False) and pcmf32s is not None and len(pcmf32s) == 2
    f.write("start,end," + ("speaker," if diarize else "") + "text\n")
    for s in segments:
        f.write(f"{10 * s.t0},{10 * s.t1},")
        if diarize:
            f.write(estimate_diarization_speaker(pcmf32s, s.t0, s.t1, True) + ",")
        f.write(f'"{_csv_escape(s.text)}"\n')


def write_score(segments: List[Segment], ctx: WhisperContext, f) -> None:
    for s in segments:
        for td in s.tokens:
            f.write(f"{ctx.tokenizer.token_str(td.id)}\t{td.p}\n")


def write_json(
    segments: List[Segment],
    ctx: WhisperContext,
    f,
    params=None,
    pcmf32s=None,
    full: bool = False,
    model_path: str = "",
    language: str = "en",
    translate: bool = False,
    lang_id: int = 0,
) -> None:
    """Structured dump (reference output_json, cli.cpp:594-755)."""
    hp = ctx.hparams
    diarize = getattr(params, "diarize", False) and pcmf32s is not None and len(pcmf32s) == 2

    def times(t0, t1):
        return {
            "timestamps": {"from": to_timestamp(t0, comma=True),
                           "to": to_timestamp(t1, comma=True)},
            "offsets": {"from": t0 * 10, "to": t1 * 10},
        }

    transcription = []
    for s in segments:
        entry = {**times(s.t0, s.t1), "text": s.text}
        if full:
            entry["tokens"] = [
                {
                    "text": ctx.tokenizer.token_str(td.id),
                    **times(td.t0 if td.t0 >= 0 else s.t0,
                            td.t1 if td.t1 >= 0 else s.t1),
                    "id": td.id,
                    "p": round(td.p, 6),
                    "t_dtw": td.t_dtw,
                }
                for td in s.tokens
            ]
        if diarize:
            entry["speaker"] = estimate_diarization_speaker(pcmf32s, s.t0, s.t1, True)
        if s.speaker_turn_next:
            entry["speaker_turn_next"] = True
        transcription.append(entry)

    doc = {
        "systeminfo": system_info_string(),
        "model": {
            "type": hp.model_type.value,
            "multilingual": hp.is_multilingual,
            "vocab": hp.n_vocab,
            "audio": {"ctx": hp.n_audio_ctx, "state": hp.n_audio_state,
                      "head": hp.n_audio_head, "layer": hp.n_audio_layer},
            "text": {"ctx": hp.n_text_ctx, "state": hp.n_text_state,
                     "head": hp.n_text_head, "layer": hp.n_text_layer},
            "mels": hp.n_mels,
            "ftype": hp.ftype,
        },
        "params": {"model": model_path, "language": language, "translate": translate},
        "result": {"language": languages.lang_str(lang_id) or "en"},
        "transcription": transcription,
    }
    json.dump(doc, f, indent=1, ensure_ascii=False)
    f.write("\n")


def system_info_string() -> str:
    """reference whisper_print_system_info (src/whisper.cpp:4314-4352):
    the port reports PyTorch's and CUDA's versions, the first CUDA device
    and the device count (utils/device_info)."""
    import torch

    from whisper_tpu_torch.utils import device_info
    n = device_info.device_count()
    dev = device_info.device_description(0) if n else "cpu"
    return (f"PyTorch {torch.__version__} | CUDA {torch.version.cuda} | "
            f"device={dev} | n_devices={n}")


def write_wts(
    segments: List[Segment],
    ctx: WhisperContext,
    f,
    fname_inp: str,
    t_sec: float,
    fname_out: str = "out.mp4",
    font_path: str = "/usr/share/fonts/truetype/dejavu/DejaVuSansMono.ttf",
) -> None:
    """Karaoke ffmpeg script (reference output_wts, cli.cpp:757-875):
    a bash script drawing token-level word highlights timed by t0/t1."""
    f.write("#!/bin/bash\n\n")
    f.write(f"ffmpeg -i {fname_inp} -f lavfi -i "
            f"color=size=1200x120:duration={t_sec}:rate=25:color=black -vf \"")
    first_seg = True
    for s in segments:
        toks = [td for td in s.tokens if td.id < ctx.vocab.token_eot]
        if not toks:
            continue
        if not first_seg:
            f.write(",")
        first_seg = False
        full_text = "".join(ctx.tokenizer.token_str(td.id) or "" for td in toks)
        esc = full_text.replace("'", "’").replace('"', "”").replace(":", "")
        # gray background line for the whole segment
        f.write(f"drawtext=fontfile='{font_path}':fontsize=24:fontcolor=gray:"
                f"x=(w-text_w)/2:y=h/2:text='{esc}':"
                f"enable='between(t,{s.t0 / 100.0},{s.t1 / 100.0})'")
        # white highlight per token over its [t0, t1) span
        acc = ""
        for td in toks:
            txt = (ctx.tokenizer.token_str(td.id) or "")
            acc += txt
            acc_esc = acc.replace("'", "’").replace('"', "”").replace(":", "")
            tt0 = (td.t0 if td.t0 >= 0 else s.t0) / 100.0
            tt1 = (td.t1 if td.t1 >= 0 else s.t1) / 100.0
            f.write(f",drawtext=fontfile='{font_path}':fontsize=24:"
                    f"fontcolor=lightgreen:x=(w-text_w)/2+8:y=h/2:"
                    f"text='{acc_esc}':enable='between(t,{tt0},{tt1})'")
    f.write(f'" -c:v libx264 -pix_fmt yuv420p -y {fname_out}\n')


WRITERS = {
    "txt": write_txt,
    "vtt": write_vtt,
    "srt": write_srt,
    "lrc": write_lrc,
    "csv": write_csv,
}


def render(fmt: str, segments, ctx=None, **kw) -> str:
    buf = io.StringIO()
    if fmt == "json":
        write_json(segments, ctx, buf, **kw)
    elif fmt == "json_full":
        write_json(segments, ctx, buf, full=True, **kw)
    elif fmt == "score":
        write_score(segments, ctx, buf)
    else:
        WRITERS[fmt](segments, buf, kw.get("params"), kw.get("pcmf32s"))
    return buf.getvalue()
