"""The PyTorch port's serving modules against the JAX package's.

serving/writers.py, cli.py, server.py, capture.py, stream.py, command.py
and lsp.py of both packages on the same inputs: a tiny ggml checkpoint in
float32 whose decoder token embedding is scaled by 8 (so the argmaxes are
decisive between the two packages, as in test_torch_port_speculative.py),
seeded numpy audio, and segments built once. Writers, CLI files, HTTP
bodies, stream events, command matches and LSP responses must be equal,
byte for byte; the exceptions are verbose_json's and json-full's float
statistics (no_speech_prob, p), held within 1e-4 / 1e-5, and the json
dump's "systeminfo", which describes each package's own backend and is
set to one string here. Both packages run on the CPU (the port's `-ng`
/ ContextParams(use_gpu=False)); without that, every entry point of the
port needs a CUDA device and raises InitError."""

import base64
import concurrent.futures
import dataclasses
import enum
import io
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import whisper_tpu as wt
import whisper_tpu_torch as pt
from whisper_tpu.api import Segment as JSegment, TokenData as JTokenData
from whisper_tpu.checkpoint import ggml_io as jggml
from whisper_tpu.checkpoint.init import tiny_test_hparams
from whisper_tpu.serving import capture as jcap
from whisper_tpu.serving import cli as jcli
from whisper_tpu.serving import command as jcmd
from whisper_tpu.serving import lsp as jlsp
from whisper_tpu.serving import server as jsrv
from whisper_tpu.serving import stream as jstream
from whisper_tpu.serving import writers as jw
from whisper_tpu_torch.api import Segment as PSegment, TokenData as PTokenData
from whisper_tpu_torch.errors import InitError
from whisper_tpu_torch.serving import capture as pcap
from whisper_tpu_torch.serving import cli as pcli
from whisper_tpu_torch.serving import command as pcmd
from whisper_tpu_torch.serving import lsp as plsp
from whisper_tpu_torch.serving import server as psrv
from whisper_tpu_torch.serving import stream as pstream
from whisper_tpu_torch.serving import writers as pw

from test_ggml_io import _make_test_tensors
from test_torch_port_host import _checkpoint_bytes

SR = 16000
PROB_TOL = 1e-4          # no_speech_prob: float32 reductions in two orders


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny model's ops are too small to gain from intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def speech(seconds, seed):
    """Speech-like test signal: AM-modulated harmonics plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    f0 = 120 + 30 * np.sin(2 * np.pi * (0.7 + 0.1 * seed) * t)
    sig = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * 2.3 * t)) * (t % 3.0 < 2.0)
    sig = sig * env + 0.01 * rng.standard_normal(t.shape)
    return (0.3 * sig / np.abs(sig).max()).astype(np.float32)


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    """A tiny f32 ggml checkpoint, the token embedding scaled by 8."""
    hp = tiny_test_hparams()
    tensors = _make_test_tensors(hp, seed=5)
    arr, tt = tensors["decoder.token_embedding.weight"]
    tensors["decoder.token_embedding.weight"] = (arr * 8.0, tt)
    path = tmp_path_factory.mktemp("serving") / "model.bin"
    path.write_bytes(_checkpoint_bytes(jggml, hp, tensors))
    return str(path)


@pytest.fixture(scope="module")
def wav_files(tmp_path_factory):
    """Three WAVs of 2, 3 and 4 s (the port's writer; both packages read
    them)."""
    from whisper_tpu_torch.audio.io import write_wav
    d = tmp_path_factory.mktemp("wav")
    paths = []
    for i, sec in enumerate((2, 3, 4)):
        p = d / f"a{i}.wav"
        write_wav(str(p), speech(sec, i))
        paths.append(str(p))
    return paths


@pytest.fixture(scope="module")
def contexts(model_file):
    """(JAX context, port context) of the checkpoint, float32 on the CPU."""
    return (wt.WhisperContext.new_with_params(model_file, wt.ContextParams(dtype="float32")),
            pt.WhisperContext.new_with_params(
                model_file, pt.ContextParams(dtype="float32", use_gpu=False)))


@pytest.fixture()
def float32_contexts(monkeypatch):
    """Entry points that build their own context (the CLI's main) do so
    in float32 in both packages; the compute dtype of the two CPUs' bf16
    matmuls is not what these tests compare."""
    for mod in (wt, pt):
        orig = mod.WhisperContext.new_with_params.__func__

        def patched(cls, path, params=None, _orig=orig, _mod=mod):
            cp = dataclasses.replace(params or _mod.ContextParams(), dtype="float32")
            return _orig(cls, path, cp)
        monkeypatch.setattr(mod.WhisperContext, "new_with_params", classmethod(patched))


@pytest.fixture()
def same_systeminfo(monkeypatch):
    for mod in (jw, pw):
        monkeypatch.setattr(mod, "system_info_string", lambda: "systeminfo")


def plain(obj):
    """A dataclass tree with enums by name, comparable across packages."""
    if dataclasses.is_dataclass(obj):
        return {f.name: plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.name
    if isinstance(obj, (list, tuple)):
        return [plain(x) for x in obj]
    return obj


# ------------------------------------------------------------------ writers

def _segments(seg_cls, td_cls):
    td = [td_cls(id=300, tid=50363, p=0.9, plog=-0.1, pt=0.5, ptsum=0.6, t0=0, t1=80,
                 t_dtw=12),
          td_cls(id=1200, tid=50363, p=0.123456789, plog=-2.0, pt=0.1, ptsum=0.2),
          td_cls(id=50257, tid=50363, p=0.5, plog=-0.7, pt=0.5, ptsum=0.5)]
    return [
        seg_cls(t0=0, t1=150, text=" Hello world.", tokens=td[:2]),
        seg_cls(t0=150, t1=420, text=' He said "hi\\there": ünïcode, it\'s.',
                tokens=td, speaker_turn_next=True, no_speech_prob=0.25),
        seg_cls(t0=6000, t1=366000, text=" late", tokens=[td[1]]),
    ]


@pytest.fixture(scope="module")
def writer_inputs():
    rng = np.random.default_rng(7)
    stereo = [rng.standard_normal(SR * 5).astype(np.float32) * s for s in (1.0, 0.3)]
    jctx = wt.WhisperContext.random(hp=tiny_test_hparams(),
                                    params=wt.ContextParams(dtype="float32"))
    pctx = pt.WhisperContext.random(hp=tiny_test_hparams(),
                                    params=pt.ContextParams(dtype="float32", use_gpu=False))
    return (_segments(JSegment, JTokenData), jctx), (_segments(PSegment, PTokenData), pctx), stereo


@pytest.mark.parametrize("fmt", ["txt", "vtt", "srt", "lrc", "csv", "json", "json_full",
                                 "score"])
@pytest.mark.parametrize("diarize", [False, True])
def test_writers_bytes_equal(writer_inputs, same_systeminfo, fmt, diarize):
    (jsegs, jctx), (psegs, pctx), stereo = writer_inputs
    args = type("Args", (), {"diarize": diarize})()
    kw = dict(params=args, pcmf32s=stereo)
    if fmt.startswith("json"):
        kw.update(model_path="m.bin", language="de", translate=True, lang_id=2)
    want = jw.render(fmt, jsegs, ctx=jctx, **kw)
    got = pw.render(fmt, psegs, ctx=pctx, **kw)
    assert got == want
    assert want


def test_writers_srt_offset_wts_and_speaker(writer_inputs):
    (jsegs, jctx), (psegs, pctx), stereo = writer_inputs
    outs = []
    for mod, segs, ctx in ((jw, jsegs, jctx), (pw, psegs, pctx)):
        srt, wts = io.StringIO(), io.StringIO()
        mod.write_srt(segs, srt, offset_n=5)
        mod.write_wts(segs, ctx, wts, "in.wav", 3.5, fname_out="o.mp4", font_path="f.ttf")
        spk = [mod.estimate_diarization_speaker(stereo, t0, t1, id_only)
               for t0, t1 in ((0, 50), (100, 250), (0, 500)) for id_only in (False, True)]
        outs.append((srt.getvalue(), wts.getvalue(), spk))
    assert outs[1] == outs[0]
    assert outs[0][0].startswith("6\n")


def test_system_info_names_torch():
    info = pt.print_system_info()
    assert info.startswith(f"PyTorch {torch.__version__} | CUDA {torch.version.cuda} | ")
    assert info.endswith(f"n_devices={pt.device_count()}")
    assert "JAX" not in info


# ---------------------------------------------------------------------- CLI

@pytest.mark.parametrize("argv", [
    ["-m", "x.bin", "-f", "a.wav"],
    ["-m", "x.bin", "-f", "a.wav", "b.wav", "-bs", "5", "-tr", "-l", "de", "--vad",
     "-vt", "0.3", "-nt", "-owts", "-ml", "0", "-p", "2", "-nf", "-mc", "64"],
    ["-f", "a.wav", "-l", "auto", "-dl", "-ojf", "-sow", "-ml", "20", "--prompt", "hi",
     "-sns", "--suppress-regex", "x+", "-tp", "0.4", "-ot", "500", "-d", "1000",
     "-vspd", "100", "-vsd", "50", "-vmsd", "8", "-vp", "10", "-vo", "0.2"],
])
def test_cli_parser_and_params_equal(argv):
    jargs = jcli.build_parser().parse_args(argv)
    pargs = pcli.build_parser().parse_args(argv)
    want = vars(jargs)
    assert want.pop("jax_cache_dir") is None
    assert vars(pargs) == want
    assert plain(pcli.params_from_args(pargs)) == plain(jcli.params_from_args(jargs))
    jcp, pcp = jcli._dtw_params(jargs), pcli._dtw_params(pargs)
    assert (pcp.use_gpu, pcp.kv_dtype, pcp.dtw_token_timestamps) == \
        (jcp.use_gpu, jcp.kv_dtype, jcp.dtw_token_timestamps)


def test_cli_parser_drops_only_the_xla_cache():
    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings}
    assert flags(jcli.build_parser()) - flags(pcli.build_parser()) == {"--jax-cache-dir"}
    assert flags(pcli.build_parser()) <= flags(jcli.build_parser())


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("extra,files", [
    (["-otxt", "-ovtt", "-osrt", "-olrc", "-ocsv", "-oj", "-on", "3"],
     ["txt", "vtt", "srt", "lrc", "csv", "json"]),
    (["-ojf", "-owts", "-ls", "-ml", "8", "-p", "2"], ["json", "wts", "score.txt"]),
])
def test_cli_files_equal(tmp_path, model_file, wav_files, float32_contexts,
                         same_systeminfo, extra, files):
    """main with -ng writes the JAX CLI's files (greedy, no fallback)."""
    out = {}
    base = str(tmp_path / "out")        # one name: the wts script names it
    for name, mod in (("jax", jcli), ("port", pcli)):
        rc = mod.main(["-m", model_file, "-f", wav_files[2], "-ng", "-nf", "-np",
                       "-of", base, *extra])
        assert rc == 0
        out[name] = {ext: _read(f"{base}.{ext}") for ext in files}
        for ext in files:
            os.unlink(f"{base}.{ext}")
    for ext in files:
        want, got = out["jax"][ext], out["port"][ext]
        if ext == "json" and "-ojf" in extra:
            jd, pd = json.loads(want), json.loads(got)
            jp = [t.pop("p") for s in jd["transcription"] for t in s["tokens"]]
            pp = [t.pop("p") for s in pd["transcription"] for t in s["tokens"]]
            np.testing.assert_allclose(pp, jp, rtol=0, atol=1e-5)
            assert pd == jd and jp
        elif ext == "score.txt":
            jl = [ln.split("\t") for ln in want.decode().splitlines()]
            pl = [ln.split("\t") for ln in got.decode().splitlines()]
            assert [t for t, _ in pl] == [t for t, _ in jl] and jl
            np.testing.assert_allclose([float(p) for _, p in pl],
                                       [float(p) for _, p in jl], rtol=0, atol=1e-5)
        else:
            assert got == want, ext
        assert want


def test_cli_exit_codes(capsys):
    assert pcli.main([]) == 1
    assert "no input files" in capsys.readouterr().err
    assert pcli.main(["-m", "/nonexistent.bin", "-f", "x.wav", "-ng"]) == 3
    assert "failed to initialize whisper context" in capsys.readouterr().err


# ------------------------------------------------------------------- server

def _multipart(fields, filename_first=False):
    boundary = "portboundary7"
    body = b""
    for name, value in fields.items():
        body += f"--{boundary}\r\n".encode()
        disp = (f'filename="x.wav"; name="{name}"' if filename_first and name == "file"
                else f'name="{name}"')
        body += f"Content-Disposition: form-data; {disp}\r\n\r\n".encode()
        body += value if isinstance(value, bytes) else str(value).encode()
        body += b"\r\n"
    body += f"--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def _http(url, data=None, ctype=None):
    """(status, content type, body bytes) of one request."""
    headers = {"Content-Type": ctype} if ctype else {}
    req = urllib.request.Request(url, data=data, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


class _Served:
    """One package's server on a free port, serving on a thread."""

    def __init__(self, mod, path, cparams, **kw):
        self.httpd = mod.serve(path, "127.0.0.1", 0, cparams=cparams, **kw)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def _servers(path, **kw):
    return (_Served(jsrv, path, wt.ContextParams(dtype="float32"), **kw),
            _Served(psrv, path, pt.ContextParams(dtype="float32", use_gpu=False), **kw))


@pytest.fixture(scope="module")
def servers(model_file):
    pair = _servers(model_file)
    yield pair
    for s in pair:
        s.close()


def _assert_same_response(want, got):
    """Equal status, content type and body; verbose_json's no_speech_prob
    within PROB_TOL."""
    assert got[:2] == want[:2]
    if want[1] == "application/json" and b'"no_speech_prob"' in want[2]:
        jd, pd = json.loads(want[2]), json.loads(got[2])
        jp = [s.pop("no_speech_prob") for s in jd["segments"]]
        pp = [s.pop("no_speech_prob") for s in pd["segments"]]
        np.testing.assert_allclose(pp, jp, rtol=0, atol=PROB_TOL)
        assert pd == jd
    else:
        assert got[2] == want[2]


@pytest.mark.parametrize("fields", [
    {"response_format": "json"},
    {"response_format": "text"},
    {"response_format": "srt"},
    {"response_format": "vtt"},
    {"response_format": "verbose_json"},
    {"response_format": "verbose_json", "no_timestamps": "true", "language": "auto"},
    {"response_format": "json", "beam_size": "5"},
    {"response_format": "srt", "beam_size": "5", "max_len": "4", "split_on_word": "true"},
], ids=["json", "text", "srt", "vtt", "verbose_json", "verbose_json_nt_auto",
        "json_beam5", "srt_beam5_maxlen"])
def test_server_bodies_equal(servers, wav_files, fields):
    body, ctype = _multipart({"file": _read(wav_files[1]), "temperature_inc": "0.0",
                              **fields}, filename_first=True)
    jres, pres = (_http(s.url + "/inference", body, ctype) for s in servers)
    assert jres[0] == 200, jres
    _assert_same_response(jres, pres)


def test_server_health_load_and_errors(servers, model_file):
    cases = [("/health", None, None), ("/nope", None, None),
             ("/load", json.dumps({"model": model_file}).encode(), "application/json"),
             ("/load", b"{}", "application/json"),
             ("/inference", *_multipart({"language": "en"})),
             ("/inference", b"--x--", "multipart/form-data"),
             ("/inference", *_multipart({"file": b"not a wav"})),
             ("/elsewhere", b"", "text/plain")]
    codes = []
    for path, data, ctype in cases:
        jres, pres = (_http(s.url + path, data, ctype) for s in servers)
        assert pres == jres, path
        codes.append(jres[0])
    assert codes == [200, 404, 200, 400, 400, 400, 400, 404]


def test_server_without_model(model_file):
    pair = _servers(None)
    try:
        body, ctype = _multipart({"file": b"RIFF"})
        for path, data in (("/health", None), ("/inference", body)):
            jres, pres = (_http(s.url + path, data, ctype if data else None) for s in pair)
            assert pres == jres and jres[0] == 503
        load = json.dumps({"model": model_file}).encode()
        jres, pres = (_http(s.url + "/load", load, "application/json") for s in pair)
        assert pres == jres and jres[0] == 200
        jres, pres = (_http(s.url + "/health") for s in pair)
        assert pres == jres and jres[0] == 200
    finally:
        for s in pair:
            s.close()


def test_server_batched_group(model_file, wav_files):
    """Three requests, staggered inside one 2.5 s batching window, run as
    one full_batch group through 2 lanes (a refill) in each package: the
    same texts per request and the same batching stats on /health."""
    pair = _servers(model_file, batch_window_ms=2500, max_batch=2)
    try:
        results = []
        for s in pair:
            def post(path):
                time.sleep(0.15 * wav_files.index(path))      # a known order
                body, ctype = _multipart({"file": _read(path), "temperature_inc": "0.0",
                                          "response_format": "verbose_json"})
                return _http(s.url + "/inference", body, ctype)
            with concurrent.futures.ThreadPoolExecutor(3) as ex:
                bodies = list(ex.map(post, wav_files))
            results.append((bodies, _http(s.url + "/health")))
        (jbodies, jhealth), (pbodies, phealth) = results
        for want, got in zip(jbodies, pbodies):
            assert want[0] == 200
            _assert_same_response(want, got)
        assert phealth == jhealth
        stats = json.loads(jhealth[2])["batching"]
        assert (stats["batches"], stats["rows"], stats["max_rows"]) == (1, 3, 3)
        assert 0.0 < stats["last_lane_occupancy"] <= 1.0
    finally:
        for s in pair:
            s.close()


@pytest.mark.parametrize("body,ctype", [
    (b"--BND\r\nContent-Disposition: form-data; name=\"file\"; filename=\"a.wav\"\r\n"
     b"Content-Type: audio/wav\r\n\r\nRIFFxxxx\x00\n\r\n\r\n--BND\r\n"
     b"Content-Disposition: form-data; name=\"temperature\"\r\n\r\n0.0\r\n--BND--\r\n",
     'multipart/form-data; boundary="BND"'),
    (b"--B\r\nContent-Disposition: form-data; filename=\"a.wav\"; name=\"file\"\r\n"
     b"\r\npayload\r\n--B--\r\n", 'multipart/form-data; boundary="B"'),
    (b"--B\r\nContent-Disposition: form-data; name=\"a\"\r\n\r\n\r\n\r\n--B\r\n"
     b"no header break\r\n--B\r\n\r\n--B--\r\n", "multipart/form-data; boundary=B"),
], ids=["binary_crlf", "filename_first", "empty_and_headless"])
def test_parse_multipart_equal(body, ctype):
    assert psrv._parse_multipart(body, ctype) == jsrv._parse_multipart(body, ctype)
    with pytest.raises(ValueError):
        psrv._parse_multipart(body, "multipart/form-data")


@pytest.mark.parametrize("fields", [
    {},
    {"word_thold": b"0.5"},
    {"best_of": b"3", "max_context": b"64", "audio_ctx": b"512", "entropy_thold": b"2.0",
     "logprob_thold": b"-0.5", "split_on_word": b"true", "tinydiarize": b"true",
     "suppress_non_speech": b"true", "no_context": b"false", "vad": b"true",
     "vad_threshold": b"0.7", "vad_min_speech_duration_ms": b"100"},
    {"beam_size": b"5", "language": b"auto", "translate": b"1", "temperature": b"0.3",
     "temperature_inc": b"0.0", "offset_t": b"250", "duration": b"900",
     "no_timestamps": b"true", "prompt": b"hello", "max_len": b"12",
     "detect_language": b"true", "debug_mode": b"1", "suppress_nst": b"true",
     "vad_model": b"v.bin", "vad_min_silence_duration_ms": b"40",
     "vad_speech_pad_ms": b"7"},
], ids=["empty", "word_thold", "reference_surface", "beam_and_rest"])
def test_params_from_fields_equal(fields):
    got, want = psrv._params_from_fields(fields), jsrv._params_from_fields(fields)
    assert plain(got) == plain(want)
    assert plain(list(psrv._params_key(got))) == plain(list(jsrv._params_key(want)))


# -------------------------------------------------------------- stream

def test_high_pass_filter_and_vad_simple_bit_equal():
    rng = np.random.default_rng(3)
    for n in (0, 1, 2, 1000, SR * 2 + 17):
        x = rng.standard_normal(n).astype(np.float32)
        for cutoff in (50.0, 100.0, 400.0):
            got = pstream.high_pass_filter(x, cutoff, SR)
            want = jstream.high_pass_filter(x, cutoff, SR)
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    loud = (0.5 * rng.standard_normal(SR)).astype(np.float32)
    silent = np.zeros(SR, np.float32)
    for pcm in (np.concatenate([loud, silent]), np.concatenate([silent, loud]),
                loud, loud[:100]):
        for last_ms, thold, freq in ((500, 0.6, 100.0), (1000, 0.6, 0.0), (200, 2.0, 50.0)):
            assert pstream.vad_simple(pcm, SR, last_ms, thold, freq) == \
                jstream.vad_simple(pcm, SR, last_ms, thold, freq)


@pytest.mark.parametrize("mode", ["sliding", "sliding_context", "vad"])
def test_stream_transcriber_equal(contexts, mode):
    """The same chunks through both packages' StreamTranscriber: the same
    events (text, committed), committed lines and carried prompt."""
    rng = np.random.default_rng(9)
    if mode == "vad":
        loud = speech(2.5, 4)
        audio = np.concatenate([loud, np.zeros(SR * 2, np.float32), loud[: SR],
                                np.zeros(int(SR * 2.5), np.float32)])
        kw = dict(step_ms=0, length_ms=5000)
    else:
        audio = speech(4, 3) + 0.01 * rng.standard_normal(SR * 4).astype(np.float32)
        kw = dict(step_ms=1000, length_ms=3000, keep_ms=200,
                  no_context=mode == "sliding")
    out = []
    for mod, ctx in ((jstream, contexts[0]), (pstream, contexts[1])):
        events = []
        st = mod.StreamTranscriber(ctx, mod.StreamParams(**kw),
                                   on_segment=lambda t, c: events.append((t, c)))
        lines = []
        for i in range(0, len(audio), SR // 2):
            lines.append(st.feed(audio[i:i + SR // 2]))
        tail = st.flush()
        out.append((events, lines, tail, st.committed, st.prompt_tokens))
    assert out[1] == out[0]
    assert out[0][0] and any(c for _, c in out[0][0])


# ------------------------------------------------------------------ capture

def test_capture_ring_equal():
    rng = np.random.default_rng(11)
    pushes = [rng.standard_normal(k).astype(np.float32)
              for k in (3000, 2000, 9000, 20000, 100, 5)]
    out = []
    for mod in (jcap, pcap):
        cap = mod.AudioCapture(len_ms=1000, backend=mod.FakeCaptureDevice())
        reads = [cap.get(500)]
        cap._on_audio(pushes[0])                    # paused: dropped
        cap.resume()
        for i, p in enumerate(pushes):
            cap.backend.push(p)
            reads += [cap.get(250), cap.get(2000)]
            if i % 2:
                reads.append(cap.drain())
            if i == 3:
                cap.clear()
                reads += [cap.get(1000), cap.drain()]
        cap.pause()
        out.append(reads)
    assert len(out[1]) == len(out[0])
    for got, want in zip(out[1], out[0]):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_capture_loop_equal():
    rng = np.random.default_rng(12)
    chunks = [rng.standard_normal(SR // 4).astype(np.float32) for _ in range(6)]
    out = []
    for mod in (jcap, pcap):
        fed, pending = [], list(chunks)
        fake = mod.FakeCaptureDevice(np.concatenate(chunks), chunk=SR // 8)
        cap = mod.AudioCapture(len_ms=4000, backend=fake)

        def sleep(_dt, cap=cap, pending=pending):
            if not pending:
                raise KeyboardInterrupt
            cap.backend.push(pending.pop(0))
        mod.run_capture_loop(fed.append, cap, step_ms=250, sleep=sleep)
        replayed = []
        fake.start(replayed.append)
        fake.replay_all()
        out.append((np.concatenate(fed).tobytes(), len(fed), len(replayed),
                    fake.started, cap._running))
    assert out[1] == out[0]
    assert out[0][1] == 6


# ------------------------------------------------------------------ command

COMMANDS = ["turn on the light", "turn off the light", "stop", "play music"]


@pytest.mark.parametrize("text", ["turn on the light", "Turn off light!", "stop.",
                                  "completely unrelated words here", "", "play the music"])
def test_command_best_command_equal(contexts, text):
    jd = jcmd.CommandDetector(contexts[0], COMMANDS, jcmd.CommandParams())
    pd = pcmd.CommandDetector(contexts[1], COMMANDS, pcmd.CommandParams())
    assert pd.best_command(text) == jd.best_command(text)


def test_command_feed_equal(contexts):
    rng = np.random.default_rng(1)
    loud = (0.4 * rng.standard_normal(SR * 2)).astype(np.float32)
    audio = np.concatenate([speech(2, 6), np.zeros(SR * 2, np.float32), loud,
                            np.zeros(SR * 2, np.float32)])
    out = []
    for mod, ctx in ((jcmd, contexts[0]), (pcmd, contexts[1])):
        det = mod.CommandDetector(ctx, COMMANDS, mod.CommandParams(command_ms=3000))
        out.append([det.feed(audio[i:i + SR // 2]) for i in range(0, len(audio), SR // 2)])
    assert out[1] == out[0]
    assert sum(len(e) for e in out[0]) == 2


# ---------------------------------------------------------------------- lsp

def test_lsp_handle_and_stdio_equal(contexts, wav_files):
    pcm = (np.clip(speech(1.5, 8), -1, 1) * 32767).astype("<i2")
    b64 = base64.b64encode(pcm.tobytes()).decode()
    reqs = [
        {"jsonrpc": "2.0", "id": 1, "method": "echo", "params": {"x": [1, "é"]}},
        {"jsonrpc": "2.0", "id": 2, "method": "guided", "params": {"pcm_base64": b64}},
        {"jsonrpc": "2.0", "id": 3, "method": "registerCommandset",
         "params": {"commands": ["lights on", "lights off", 7]}},
        {"jsonrpc": "2.0", "id": 4, "method": "registerCommandset", "params": {"commands": []}},
        {"jsonrpc": "2.0", "id": 5, "method": "unguided", "params": {"pcm_base64": b64}},
        {"jsonrpc": "2.0", "id": 6, "method": "unguided",
         "params": {"wav_path": wav_files[0], "no_timestamps": False, "max_tokens": 5}},
        {"jsonrpc": "2.0", "id": 7, "method": "guided",
         "params": {"pcm_base64": b64, "commandset_index": 0}},
        {"jsonrpc": "2.0", "id": 8, "method": "guided",
         "params": {"pcm_base64": b64, "commandset_index": 3}},
        {"jsonrpc": "2.0", "id": 9, "method": "unguided", "params": {}},
        {"jsonrpc": "2.0", "id": 10, "method": "nope", "params": {}},
        {"jsonrpc": "2.0", "id": 11},
    ]
    out = []
    for mod, ctx in ((jlsp, contexts[0]), (plsp, contexts[1])):
        srv = mod.LspServer(ctx)
        handled = [srv.handle(r) for r in reqs]
        fin = io.StringIO("\n".join(json.dumps(r) for r in reqs[:3]) + "\n\nnot json\n")
        fout = io.StringIO()
        mod.LspServer(ctx).serve_stdio(fin, fout)
        out.append((handled, fout.getvalue()))
    assert out[1] == out[0]
    handled = out[0][0]
    assert "transcription" in handled[4]["result"] and "result" in handled[6]
    assert [("error" in h) for h in handled] == [False, True, False, True, False, False,
                                                 False, True, True, True, True]


# ------------------------------------------------------- entry points on -ng

def test_stream_command_lsp_mains_on_cpu(model_file, wav_files, tmp_path, monkeypatch,
                                         float32_contexts, capsys):
    """The file-driven mains run on the CPU with -ng and print what the
    JAX package's print."""
    cmds = tmp_path / "cmds.txt"
    cmds.write_text("\n".join(COMMANDS) + "\n")
    mods = ((jstream, jcmd, jlsp), (pstream, pcmd, plsp))
    out = []
    for stream_mod, cmd_mod, lsp_mod in mods:
        ng = ["-ng"] if stream_mod is pstream else []
        assert stream_mod.main(["-m", model_file, "-f", wav_files[2], "--step", "1000",
                                "--length", "3000", *ng]) == 0
        assert cmd_mod.main(["-m", model_file, "-f", wav_files[2], "-cmd", str(cmds),
                             *ng]) == 0
        monkeypatch.setattr("sys.stdin", io.StringIO(
            '{"jsonrpc": "2.0", "id": 1, "method": "echo", "params": {"a": 1}}\n'))
        assert lsp_mod.main(["-m", model_file, *ng]) == 0
        out.append(capsys.readouterr().out)
    assert out[1] == out[0] and out[0]


@pytest.mark.parametrize("entry", ["cli", "serve", "serve_no_model", "server_main",
                                   "stream_main", "command_main", "lsp_main"])
def test_entry_points_need_cuda(model_file, wav_files, entry, capsys):
    """Without -ng / use_gpu=False, every serving entry point asks for a
    CUDA device and fails with InitError (the CLI: exit code 3 and its
    message, as whisper-cli reports a failed init); none falls back to the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    if entry == "cli":
        assert pcli.main(["-m", model_file, "-f", wav_files[0], "-np"]) == 3
        err = capsys.readouterr().err
        assert "failed to initialize whisper context" in err and "use_gpu=False" in err
        return
    calls = {
        "serve": lambda: psrv.serve(model_file, "127.0.0.1", 0),
        "serve_no_model": lambda: psrv.serve(None, "127.0.0.1", 0),
        "server_main": lambda: psrv.main(["-m", model_file, "--port", "0"]),
        "stream_main": lambda: pstream.main(["-m", model_file, "-f", wav_files[0]]),
        "command_main": lambda: pcmd.main(["-m", model_file, "-f", wav_files[0]]),
        "lsp_main": lambda: plsp.main(["-m", model_file]),
    }
    with pytest.raises(InitError, match="use_gpu=False"):
        calls[entry]()
