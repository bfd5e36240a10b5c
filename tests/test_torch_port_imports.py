"""The PyTorch port stands alone: it imports neither JAX nor anything of
the JAX package (whisper_tpu), and its entry points run on the GPU unless
the caller asks for the CPU."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import whisper_tpu_torch as pt
from whisper_tpu_torch.checkpoint.init import tiny_test_hparams
from whisper_tpu_torch.errors import InitError

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "whisper_tpu_torch"


def test_import_pulls_no_jax():
    # a fresh interpreter: this process has imported JAX already (conftest)
    code = (
        "import importlib, pkgutil, sys\n"
        "import whisper_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(whisper_tpu_torch.__path__,"
        " 'whisper_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m.split('.')[0] in ('orbax', 'whisper_tpu'))\n"
        "print(len(mods), bad, ' '.join(mods))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    n_mods = int(out.stdout.split()[0])
    assert n_mods >= 20          # every submodule was imported
    mods = out.stdout.split("] ", 1)[1].split()
    for m in ("whisper_tpu_torch.ops.quant_matmul", "whisper_tpu_torch.tools.quantize",
              "whisper_tpu_torch.ops.flash_attention", "whisper_tpu_torch.models.vad",
              "whisper_tpu_torch.checkpoint.convert_silero",
              "whisper_tpu_torch.serving.vad_segments",
              "whisper_tpu_torch.decoding.batch_loop", "whisper_tpu_torch.decoding.batch_full",
              "whisper_tpu_torch.decoding.speculative", "whisper_tpu_torch.runtime.native",
              "whisper_tpu_torch.serving.cli", "whisper_tpu_torch.serving.server",
              "whisper_tpu_torch.serving.stream", "whisper_tpu_torch.serving.lsp",
              "whisper_tpu_torch.eval.librispeech", "whisper_tpu_torch.utils.profiling",
              "whisper_tpu_torch.checkpoint.gguf", "whisper_tpu_torch.checkpoint.convert_hf",
              "whisper_tpu_torch.checkpoint.export_pt",
              "whisper_tpu_torch.checkpoint.native_cache", "whisper_tpu_torch.tools.download",
              "whisper_tpu_torch.tools.micro_bench", "whisper_tpu_torch.tools.dist_check",
              "whisper_tpu_torch.parallel.mesh", "whisper_tpu_torch.parallel.distributed",
              "whisper_tpu_torch.tools.programs", "whisper_tpu_torch.tools.hbm_audit",
              "whisper_tpu_torch.tools.tp_evidence", "whisper_tpu_torch.utils.selfcheck"):
        assert m in mods, m


def test_sources_name_no_jax():
    # _build/ holds kernel build outputs (git-ignored), not sources
    files = sorted(f for f in PORT.rglob("*.py")
                   if "_build" not in f.relative_to(PORT).parts) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    assert PORT / "ops" / "quant_matmul.py" in files
    assert PORT / "tools" / "quantize.py" in files
    for f in ("models/vad.py", "checkpoint/convert_silero.py", "serving/vad_segments.py",
              "decoding/batch_loop.py", "decoding/batch_full.py",
              "decoding/speculative.py", "runtime/native.py", "serving/writers.py",
              "serving/cli.py", "serving/server.py", "serving/capture.py",
              "serving/stream.py", "serving/command.py", "serving/lsp.py", "eval/wer.py",
              "eval/normalizer.py", "eval/common.py", "eval/librispeech.py",
              "eval/earnings21.py", "utils/logging.py", "utils/profiling.py",
              "checkpoint/gguf.py", "checkpoint/convert_hf.py", "checkpoint/export_pt.py",
              "checkpoint/native_cache.py", "tools/download.py", "tools/micro_bench.py",
              "tools/dist_check.py", "parallel/mesh.py", "parallel/distributed.py",
              "tools/programs.py", "tools/hbm_audit.py", "tools/tp_evidence.py",
              "utils/selfcheck.py"):
        assert PORT / f in files, f
    for f in files:
        text = f.read_text()
        assert "import jax" not in text, f
        assert not re.search(r"^\s*(from|import)\s+orbax\b", text, re.M), f
        assert not re.search(r"^\s*from\s+jax\b", text, re.M), f
        assert "whisper_tpu." not in text, f
        assert not re.search(r"^\s*(from|import)\s+whisper_tpu\b(?!_torch)", text, re.M), f
        assert "libwhisper_tpu_runtime" not in text, f     # the JAX package's library


def test_runtime_library_is_the_ports():
    """The host runtime the port loads is its own build of
    csrc/runtime.cpp under _build/, never a library of the JAX package."""
    from whisper_tpu_torch.runtime import native
    if not native.available():
        pytest.skip("the host runtime did not build (no g++?)")
    path = pathlib.Path(native.get_lib()._name).resolve()
    assert path.parent == PORT / "_build" and path.name.startswith("libruntime-")


def test_default_context_needs_cuda(tmp_path):
    """use_gpu=True (the default) never falls back to the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default context is valid")
    with pytest.raises(InitError, match="use_gpu=False"):
        pt.WhisperContext.random(hp=tiny_test_hparams())
    with pytest.raises(InitError, match="use_gpu=False"):
        pt.WhisperContext.new_with_params(str(tmp_path / "missing.bin"))
    ctx = pt.WhisperContext.random(hp=tiny_test_hparams(),
                                   params=pt.ContextParams(use_gpu=False))
    assert ctx.device.type == "cpu" and not ctx.use_flash
    w = ctx.params["encoder"]["blocks"][0]["attn_q"]["w"]
    assert w.device.type == "cpu" and w.dtype == torch.bfloat16


def test_later_slices_raise(tmp_path):
    hp = tiny_test_hparams()
    # keep_quantized and kv_dtype="int8" are this slice's now: a quantized
    # checkpoint keeps int8 leaves, the int8 KV contexts build int8 caches,
    # and random weights stay dense (the JAX package's random ignores
    # keep_quantized)
    import io
    from test_ggml_io import _make_test_tensors
    from whisper_tpu_torch.audio.mel import mel_filterbank
    from whisper_tpu_torch.checkpoint import ggml_io, quant
    from whisper_tpu_torch.tokenizer import synthetic_vocab
    buf = io.BytesIO()
    ggml_io.write_ggml(buf, hp, mel_filterbank(hp.n_mels),
                       synthetic_vocab(hp.n_vocab).id_to_token[:50256],
                       _make_test_tensors(hp, ttype=quant.GGML_TYPE_Q5_0))
    qctx = pt.WhisperContext.from_buffer(buf.getvalue(), pt.ContextParams(
        use_gpu=False, keep_quantized=True, kv_dtype="int8"))
    lin = qctx.params["decoder"]["blocks"][0]["mlp_0"]
    assert lin["q"].dtype == torch.int8 and "w" not in lin and qctx.kv_quant
    rnd = pt.WhisperContext.random(hp=hp, params=pt.ContextParams(
        use_gpu=False, keep_quantized=True, kv_dtype="int8"))
    assert "w" in rnd.params["decoder"]["blocks"][0]["mlp_0"]
    kv = rnd.create_state().new_kv_cache(2)
    assert kv.quantized and kv.k.dtype == torch.int8 and kv.ks.dtype == torch.float32
    ctx = pt.WhisperContext.random(hp=hp, params=pt.ContextParams(
        use_gpu=False, dtype="float32"))
    audio = np.zeros(16000, np.float32)
    # VAD runs now: it needs a model file, as in the JAX package
    p = pt.FullParams.default()
    p.vad = True
    with pytest.raises(ValueError, match="vad_model_path"):
        ctx.create_state().full(p, audio)
    # batching runs now, and so does the mesh, over a process group
    with pytest.raises(ValueError, match="not initialized"):
        ctx.full_batch(pt.FullParams.default(), [audio], mesh=(1, 2))
    # language detection, token timestamps and the logits callback run now
    for field, value in (("token_timestamps", True), ("language", "auto"),
                         ("detect_language", True),
                         ("logits_filter_callback", lambda *a: None)):
        p = pt.FullParams.default()
        p.max_tokens = 2
        setattr(p, field, value)
        assert ctx.create_state().full(p, audio) == 0


def test_device_info_without_cuda():
    """device_info over torch.cuda: with no CUDA device there is none to
    describe; with one, each query describes it."""
    n = pt.device_count()
    assert n == (torch.cuda.device_count() if torch.cuda.is_available() else 0)
    assert len(pt.devices_info()) == n
    with pytest.raises(IndexError):
        pt.device_description(n)
    with pytest.raises(IndexError):
        pt.device_total_memory(n)
    for e in pt.devices_info():
        assert e["platform"] == "gpu" and e["total_memory_bytes"] > 0
        assert e["description"] == pt.device_description(e["index"])
