"""HTTP inference server.

Counterpart of whisper_tpu/serving/server.py: the same endpoints, form
fields, batching and response bodies. The model runs on
cuda:{gpu_device} unless ContextParams(use_gpu=False) (`-ng` in main)
asks for the CPU; without a CUDA device and without that, ServerState
raises InitError. Every request thread and the dispatcher's thread run
the model under torch.cuda.device(ctx.device), so the hand-written
kernels launch on the context's card whatever the thread's current
device.

reference examples/server/server.cpp (endpoints :683-1152):
  POST /inference — multipart WAV (field "file") + decode params;
                    response_format: json | text | srt | vtt |
                    verbose_json (OAI-ish)
  POST /load      — hot-swap model {"model": path}
  GET  /health    — liveness

stdlib http.server only (the reference vendors httplib.h; we need no
dependency). A threading lock serializes model access like the
reference's whisper_mutex (server.cpp:569).
"""

from __future__ import annotations

import contextlib
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import torch

from whisper_tpu_torch.api import WhisperContext, resolve_device
from whisper_tpu_torch.config import ContextParams, FullParams, SamplingStrategy
from whisper_tpu_torch.serving import writers


def on_device(ctx: WhisperContext):
    """The context's card as this thread's current CUDA device (kernels
    launched through ctypes go to the current device); nothing on the
    CPU."""
    if ctx.device.type == "cuda":
        return torch.cuda.device(ctx.device)
    return contextlib.nullcontext()


class ServerState:
    def __init__(self, model_path: Optional[str] = None,
                 cparams: Optional[ContextParams] = None,
                 batch_window_ms: int = 0, max_batch: int = 8):
        self.lock = threading.Lock()
        self.cparams = cparams or ContextParams()
        resolve_device(self.cparams)    # InitError without a card, even with no model
        self.ctx: Optional[WhisperContext] = None
        self.model_path = model_path
        if model_path:
            self.ctx = WhisperContext.new_with_params(model_path, self.cparams)
        self.dispatcher = (BatchingDispatcher(self, batch_window_ms, max_batch)
                           if batch_window_ms > 0 else None)

    def load(self, path: str) -> None:
        with self.lock:
            self.ctx = WhisperContext.new_with_params(path, self.cparams)
            self.model_path = path


def _params_key(p: FullParams) -> tuple:
    """Decode-relevant fields that must match for requests to share one
    batched decode (run_full_batch takes a single FullParams for all rows)."""
    return (
        p.strategy, p.language, p.translate, p.no_timestamps,
        p.temperature, p.temperature_inc, p.max_tokens, p.max_len,
        p.suppress_regex, p.initial_prompt, p.token_timestamps,
        p.beam_search.beam_size, p.greedy.best_of, p.offset_ms,
        p.duration_ms, p.split_on_word, p.suppress_blank, p.suppress_nst,
        p.length_penalty, p.entropy_thold, p.logprob_thold,
        p.no_speech_thold, p.n_max_text_ctx, p.no_context, p.audio_ctx,
        # without these, semantically different requests would share one
        # batched decode (the first request's params would win)
        p.detect_language, p.tdrz_enable, p.thold_pt, p.thold_ptsum,
        p.debug_mode,
    )


class _Request:
    __slots__ = ("samples", "params", "done", "segments", "error")

    def __init__(self, samples, params):
        self.samples = samples
        self.params = params
        self.done = threading.Event()
        self.segments = None
        self.error: Optional[Exception] = None


class BatchingDispatcher:
    """Continuous request batching: concurrent /inference requests arriving
    within `window_ms` coalesce into ONE ctx.full_batch call (one batched
    encoder program + one batched on-device token loop for the whole
    group — decoding/batch_full.py). The reference server handles one
    request at a time under a mutex (server.cpp:569); batching concurrent
    utterances is where serving throughput comes from (a 4-row decode
    step costs little more than a 1-row one, PERF.md §5).

    Requests with different decode params (or with VAD, which the batch
    path does not preprocess) fall back to per-request full().

    Determinism note: greedy decodes of identical audio are identical
    across rows; if the temperature-fallback ladder escalates into
    sampling, each row draws its own noise, so identical concurrent
    requests may legitimately differ — same as the reference's per-decoder
    rng (src/whisper.cpp:6897)."""

    def __init__(self, server_state: "ServerState", window_ms: int,
                 max_batch: int = 8):
        self.state = server_state
        self.window_s = window_ms / 1000.0
        self.max_batch = max(1, max_batch)
        self.cond = threading.Condition()
        self.queue = []
        # introspection (tests / metrics)
        self.n_batches = 0
        self.n_rows = 0
        self.max_rows = 0
        self.last_occupancy = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def submit(self, samples, params: FullParams):
        req = _Request(samples, params)
        with self.cond:
            self.queue.append(req)
            self.cond.notify()
        req.done.wait()
        if req.error is not None:
            raise req.error
        return req.segments

    def _run(self):
        import time as _time
        while True:
            with self.cond:
                while not self.queue:
                    self.cond.wait()
            _time.sleep(self.window_s)      # batching window
            with self.cond:
                batch, self.queue = self.queue, []

            groups: Dict[tuple, list] = {}
            for r in batch:
                groups.setdefault(_params_key(r.params), []).append(r)
            for reqs in groups.values():
                # max_batch caps the device LANES, not the group size:
                # run_full_batch streams the whole group through the lanes,
                # refilling each lane as its utterance finishes (continuous
                # batching — short requests never hold lanes hostage to the
                # longest one)
                self._run_group(reqs)

    def _run_group(self, reqs):
        try:
            stats: Dict = {}
            with self.state.lock:
                ctx = self.state.ctx
                with on_device(ctx):
                    results = ctx.full_batch(reqs[0].params,
                                             [r.samples for r in reqs],
                                             n_lanes=self.max_batch,
                                             stats=stats)
            self.n_batches += 1
            self.n_rows += len(reqs)
            self.max_rows = max(self.max_rows, len(reqs))
            self.last_occupancy = stats.get("lane_occupancy")
            for r, segs in zip(reqs, results):
                r.segments = segs
        except Exception as e:  # fail the whole group, not the server
            for r in reqs:
                r.error = e
        finally:
            for r in reqs:
                r.done.set()


def _parse_multipart(body: bytes, content_type: str) -> Dict[str, bytes]:
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise ValueError("no multipart boundary")
    boundary = b"--" + m.group(1).encode()
    fields: Dict[str, bytes] = {}
    for part in body.split(boundary):
        if not part or part.strip(b"\r\n-") == b"":
            continue
        if b"\r\n\r\n" not in part:
            continue
        # split headers/body FIRST; only then trim the protocol framing —
        # a blanket strip(b"\r\n") would eat 0x0D/0x0A bytes that belong to
        # a binary WAV payload
        head, _, data = part.partition(b"\r\n\r\n")
        head = head.strip(b"\r\n")
        if data.endswith(b"\r\n"):
            data = data[:-2]
        # anchored: `filename="x"` must not satisfy the name lookup
        # (header parameter order is unconstrained, RFC 7578)
        nm = re.search(rb'(?:^|;\s*)name="([^"]+)"', head, re.M)
        if nm:
            fields[nm.group(1).decode()] = data
    return fields


def _params_from_fields(fields: Dict[str, bytes]) -> FullParams:
    def get(name, default=None, cast=str):
        v = fields.get(name)
        if v is None:
            return default
        return cast(v.decode().strip())

    beam = get("beam_size", -1, int)
    p = FullParams.default(SamplingStrategy.BEAM_SEARCH if beam and beam > 1
                           else SamplingStrategy.GREEDY)
    if beam and beam > 1:
        p.beam_search.beam_size = beam
    p.print_progress = False
    p.language = get("language", "en")
    if p.language == "auto":
        p.language = None
    p.translate = get("translate", "false") in ("true", "1")
    p.temperature = get("temperature", 0.0, float)
    p.temperature_inc = get("temperature_inc", 0.2, float)
    p.offset_ms = get("offset_t", 0, int)
    p.duration_ms = get("duration", 0, int)
    p.no_timestamps = get("no_timestamps", "false") in ("true", "1")
    p.initial_prompt = get("prompt")
    wt_ = get("word_thold", None, float)
    if wt_ is not None:
        p.thold_pt = wt_     # reference server.cpp copies it into thold_pt
    # reference default: max_len 60 when the field is 0/absent (:899);
    # token_timestamps is decided by the handler from response_format
    p.max_len = get("max_len", 0, int)
    if p.max_len == 0:
        p.max_len = 60
    # remaining reference fields (server.cpp:470-598)
    p.greedy.best_of = get("best_of", p.greedy.best_of, int)
    p.n_max_text_ctx = get("max_context", p.n_max_text_ctx, int)
    p.audio_ctx = get("audio_ctx", 0, int)
    p.entropy_thold = get("entropy_thold", p.entropy_thold, float)
    p.logprob_thold = get("logprob_thold", p.logprob_thold, float)
    p.debug_mode = get("debug_mode", "false") in ("true", "1")
    p.split_on_word = get("split_on_word", "false") in ("true", "1")
    p.tdrz_enable = get("tinydiarize", "false") in ("true", "1")
    p.detect_language = get("detect_language", "false") in ("true", "1")
    p.suppress_nst = (get("suppress_nst", "false") in ("true", "1")
                      or get("suppress_non_speech", "false") in ("true", "1"))
    # reference default false (:106): cross-window conditioning ON
    p.no_context = get("no_context", "false") in ("true", "1")
    p.vad = get("vad", "false") in ("true", "1")
    p.vad_model_path = get("vad_model")
    p.vad_params.threshold = get("vad_threshold", p.vad_params.threshold, float)
    p.vad_params.min_speech_duration_ms = get(
        "vad_min_speech_duration_ms", p.vad_params.min_speech_duration_ms, int)
    p.vad_params.min_silence_duration_ms = get(
        "vad_min_silence_duration_ms", p.vad_params.min_silence_duration_ms, int)
    p.vad_params.speech_pad_ms = get(
        "vad_speech_pad_ms", p.vad_params.speech_pad_ms, int)
    return p


def make_handler(server_state: ServerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass  # quiet; the reference logs via its own hooks

        def _send(self, code: int, body: str, ctype: str = "application/json"):
            data = body.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/health":
                ok = server_state.ctx is not None
                doc = {"status": "ok" if ok else "no model loaded"}
                # continuous-batching observability (beyond the reference
                # server): batch counts and the last group's lane occupancy
                disp = server_state.dispatcher
                if disp is not None:
                    doc["batching"] = {
                        "batches": disp.n_batches,
                        "rows": disp.n_rows,
                        "max_rows": disp.max_rows,
                        "last_lane_occupancy": disp.last_occupancy,
                    }
                self._send(200 if ok else 503, json.dumps(doc))
            else:
                self._send(404, json.dumps({"error": "not found"}))

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            if self.path == "/load":
                try:
                    doc = json.loads(body or b"{}")
                    server_state.load(doc["model"])
                    self._send(200, json.dumps({"status": "model loaded",
                                                "model": doc["model"]}))
                except Exception as e:
                    self._send(400, json.dumps({"error": str(e)}))
                return
            if self.path != "/inference":
                self._send(404, json.dumps({"error": "not found"}))
                return
            if server_state.ctx is None:
                self._send(503, json.dumps({"error": "no model loaded"}))
                return
            try:
                fields = _parse_multipart(body, self.headers.get("Content-Type", ""))
                if "file" not in fields:
                    raise ValueError('missing "file" field')
                from whisper_tpu_torch.audio.io import read_wav
                import tempfile, os
                with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as tf:
                    tf.write(fields["file"])
                    tmp = tf.name
                try:
                    samples, _sr = read_wav(tmp)
                finally:
                    os.unlink(tmp)
                params = _params_from_fields(fields)
                fmt = fields.get("response_format", b"json").decode()
                # verbose_json carries token timings (server.cpp:919)
                params.token_timestamps = (not params.no_timestamps
                                           and fmt == "verbose_json")

                if server_state.dispatcher is not None and not params.vad:
                    # continuous batching: coalesce with concurrent requests
                    segments = server_state.dispatcher.submit(samples, params)
                else:
                    with server_state.lock:
                        ctx = server_state.ctx
                        state = ctx.create_state()
                        with on_device(ctx):
                            if state.full(params, samples) != 0:
                                raise RuntimeError("transcription failed")
                        segments = state.segments

                if fmt == "text":
                    self._send(200, "".join(s.text for s in segments) + "\n",
                               "text/plain")
                elif fmt == "srt":
                    self._send(200, writers.render("srt", segments),
                               "application/x-subrip")
                elif fmt == "vtt":
                    self._send(200, writers.render("vtt", segments), "text/vtt")
                elif fmt == "verbose_json":
                    doc = {
                        "task": "translate" if params.translate else "transcribe",
                        "language": params.language,
                        "duration": len(samples) / 16000.0,
                        "text": "".join(s.text for s in segments),
                        "segments": [
                            {"id": i, "start": s.t0 / 100.0, "end": s.t1 / 100.0,
                             "text": s.text,
                             "no_speech_prob": s.no_speech_prob,
                             "tokens": [td.id for td in s.tokens]}
                            for i, s in enumerate(segments)
                        ],
                    }
                    self._send(200, json.dumps(doc, ensure_ascii=False))
                else:  # json (default)
                    self._send(200, json.dumps(
                        {"text": "".join(s.text for s in segments)},
                        ensure_ascii=False))
            except Exception as e:
                self._send(400, json.dumps({"error": str(e)}))

    return Handler


def serve(model_path: Optional[str], host: str = "127.0.0.1", port: int = 8080,
          cparams: Optional[ContextParams] = None,
          batch_window_ms: int = 0, max_batch: int = 8) -> ThreadingHTTPServer:
    """Create (and return) the server; caller runs serve_forever().
    batch_window_ms > 0 enables continuous request batching."""
    state = ServerState(model_path, cparams, batch_window_ms, max_batch)
    httpd = ThreadingHTTPServer((host, port), make_handler(state))
    httpd.whisper_state = state  # for tests / hot-swap introspection
    return httpd


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="whisper-tpu-torch-server")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--batch-window-ms", type=int, default=0,
                    help="coalesce concurrent requests arriving within this "
                         "window into one batched decode (0 = off)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--draft-model", default=None,
                    help="draft checkpoint for speculative greedy decoding")
    ap.add_argument("--spec-k", type=int, default=8)
    ap.add_argument("--draft-shares-encoder", action="store_true")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 self- and cross-KV cache (halves the cache's "
                         "device memory)")
    ap.add_argument("-ng", "--no-gpu", action="store_true",
                    help="run the model on the CPU")
    args = ap.parse_args(argv)
    cparams = ContextParams(use_gpu=not args.no_gpu,
                            draft_model=args.draft_model,
                            spec_k=args.spec_k,
                            draft_shares_encoder=args.draft_shares_encoder,
                            kv_dtype="int8" if args.kv_int8 else "")
    httpd = serve(args.model, args.host, args.port,
                  batch_window_ms=args.batch_window_ms,
                  max_batch=args.max_batch, cparams=cparams)
    print(f"whisper-tpu-torch server listening on http://{args.host}:{args.port}")
    httpd.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
