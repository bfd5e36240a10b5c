"""LSP-style interactive JSON protocol.

Counterpart of whisper_tpu/serving/lsp.py. The model runs on the first
CUDA device; -ng in main runs it on the CPU.

reference examples/lsp/lsp.cpp (469 LoC): a JSON-RPC-ish loop over
stdin/stdout with methods `unguided` (free transcription), `guided`
(choose among a registered command set), `registerCommandset`, and `echo`.
The reference captures mic audio via SDL; here audio arrives in the request
as a base64 16-bit PCM payload (or a WAV path), which also makes the
protocol scriptable/testable.

Request  : {"jsonrpc":"2.0","id":N,"method":"...","params":{...}}
Response : {"jsonrpc":"2.0","id":N,"result":{...}} | {"error": {...}}
"""

from __future__ import annotations

import base64
import json
import sys
from typing import Dict, List

import numpy as np

from whisper_tpu_torch.api import WhisperContext
from whisper_tpu_torch.config import ContextParams, FullParams
from whisper_tpu_torch.eval.wer import wer_details


class LspServer:
    def __init__(self, ctx: WhisperContext, language: str = "en"):
        self.ctx = ctx
        self.language = language
        self.commandsets: List[List[str]] = []

    # -- helpers -------------------------------------------------------------
    def _audio_from_params(self, jparams: Dict) -> np.ndarray:
        if "pcm_base64" in jparams:
            raw = base64.b64decode(jparams["pcm_base64"])
            return np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        if "wav_path" in jparams:
            from whisper_tpu_torch.audio.io import read_wav
            samples, _ = read_wav(jparams["wav_path"])
            return samples
        raise ValueError("params must include pcm_base64 or wav_path")

    def _full_params(self, jparams: Dict) -> FullParams:
        p = FullParams.default()
        p.print_progress = False
        p.no_timestamps = jparams.get("no_timestamps", True)
        p.single_segment = True
        p.max_tokens = int(jparams.get("max_tokens", 32))
        p.language = jparams.get("language", self.language)
        p.temperature_inc = 0.0
        return p

    # -- methods (reference lsp.cpp:157-363) ----------------------------------
    def unguided(self, jparams: Dict) -> Dict:
        samples = self._audio_from_params(jparams)
        st = self.ctx.create_state()
        st.full(self._full_params(jparams), samples)
        return {"transcription": st.full_get_all_text()}

    def guided(self, jparams: Dict) -> Dict:
        cs_id = int(jparams.get("commandset_index", len(self.commandsets) - 1))
        if not (0 <= cs_id < len(self.commandsets)):
            raise ValueError(f"invalid commandset_index {cs_id}")
        commands = self.commandsets[cs_id]
        samples = self._audio_from_params(jparams)
        st = self.ctx.create_state()
        st.full(self._full_params(jparams), samples)
        text = st.full_get_all_text()
        best_i, best_wer = 0, float("inf")
        for i, cmd in enumerate(commands):
            d = wer_details(cmd, text, normalize=True)
            if d["wer"] < best_wer:
                best_i, best_wer = i, d["wer"]
        return {"command_index": best_i, "command_text": commands[best_i],
                "heard": text}

    def register_commandset(self, jparams: Dict) -> Dict:
        commands = jparams["commands"]
        if not isinstance(commands, list) or not commands:
            raise ValueError("commands must be a non-empty list")
        self.commandsets.append([str(c) for c in commands])
        return {"index": len(self.commandsets) - 1}

    def handle(self, body: Dict) -> Dict:
        rid = body.get("id")
        try:
            method = body["method"]
            jparams = body.get("params", {})
            if method == "unguided":
                res = self.unguided(jparams)
            elif method == "guided":
                res = self.guided(jparams)
            elif method == "registerCommandset":
                res = self.register_commandset(jparams)
            elif method == "echo":
                res = jparams
            else:
                raise ValueError(f"unknown method '{method}'")
            return {"jsonrpc": "2.0", "id": rid, "result": res}
        except Exception as e:
            return {"jsonrpc": "2.0", "id": rid,
                    "error": {"code": -32000, "message": str(e)}}

    def serve_stdio(self, fin=None, fout=None) -> None:
        fin = fin or sys.stdin
        fout = fout or sys.stdout
        for line in fin:
            line = line.strip()
            if not line:
                continue
            try:
                body = json.loads(line)
            except json.JSONDecodeError as e:
                fout.write(json.dumps(
                    {"jsonrpc": "2.0", "id": None,
                     "error": {"code": -32700, "message": f"parse error: {e}"}}) + "\n")
                fout.flush()
                continue
            fout.write(json.dumps(self.handle(body), ensure_ascii=False) + "\n")
            fout.flush()


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="whisper-tpu-torch-lsp")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-l", "--language", default="en")
    ap.add_argument("-ng", "--no-gpu", action="store_true",
                    help="run the model on the CPU")
    args = ap.parse_args(argv)
    ctx = WhisperContext.new_with_params(args.model,
                                         ContextParams(use_gpu=not args.no_gpu))
    LspServer(ctx, args.language).serve_stdio()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
