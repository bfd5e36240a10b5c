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
        " or m == 'whisper_tpu' or m.startswith('whisper_tpu.'))\n"
        "print(len(mods), bad)\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    n_mods = int(out.stdout.split()[0])
    assert n_mods >= 20          # every submodule was imported


def test_sources_name_no_jax():
    # _build/ holds kernel build outputs (git-ignored), not sources
    files = sorted(f for f in PORT.rglob("*.py")
                   if "_build" not in f.relative_to(PORT).parts) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        text = f.read_text()
        assert "import jax" not in text, f
        assert not re.search(r"^\s*from\s+jax\b", text, re.M), f
        assert "whisper_tpu." not in text, f
        assert not re.search(r"^\s*(from|import)\s+whisper_tpu\b(?!_torch)", text, re.M), f


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
    with pytest.raises(NotImplementedError, match="B2/B3"):
        pt.WhisperContext.random(hp=hp, params=pt.ContextParams(
            use_gpu=False, keep_quantized=True))
    with pytest.raises(NotImplementedError, match="A8"):
        pt.WhisperContext.random(hp=hp, params=pt.ContextParams(
            use_gpu=False, kv_dtype="int8"))
    ctx = pt.WhisperContext.random(hp=hp, params=pt.ContextParams(
        use_gpu=False, dtype="float32"))
    audio = np.zeros(16000, np.float32)
    for field, value, item in (("vad", True, "A13"), ("token_timestamps", True, "A9"),
                               ("language", "auto", "A17"),
                               ("detect_language", True, "A17"),
                               ("logits_filter_callback", lambda *a: None, "A10")):
        p = pt.FullParams.default()
        setattr(p, field, value)
        with pytest.raises(NotImplementedError, match=item):
            ctx.create_state().full(p, audio)
