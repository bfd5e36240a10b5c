"""Kernel B1, flash attention: the port's plain version against the JAX
package's Pallas kernel run in interpret mode (as tests/test_flash_attention
runs it), and the wrapper's CPU contract. The CUDA kernel itself builds
and runs only on the card: chip_smoke.py and tests/test_torch_port_cuda.py
hold it against the plain version there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.ops.flash_attention import flash_attention as jax_flash
from whisper_tpu_torch.ops import build
from whisper_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

CASES = [
    # (name, q shape, Tk, dtype, tolerance)
    ("f32", (1, 2, 256, 64), 256, np.float32, 1e-5),
    ("bf16", (1, 2, 256, 64), 256, "bfloat16", 2e-2),
    ("tq_ne_tk", (1, 3, 40, 64), 1500, np.float32, 1e-5),
    ("unaligned_tk", (2, 2, 70, 64), 300, np.float32, 1e-5),
    ("unaligned_tk_bf16", (1, 2, 8, 64), 1500, "bfloat16", 2e-2),
]


def _inputs(shape, tk, dtype, seed):
    rng = np.random.default_rng(seed)
    B, H, Tq, D = shape
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in (shape, (B, H, tk, D), (B, H, tk, D)))
    if dtype == "bfloat16":
        j = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
        t = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    else:
        j = [jnp.asarray(a) for a in (q, k, v)]
        t = [torch.from_numpy(a) for a in (q, k, v)]
    return j, t


@pytest.mark.parametrize("name,shape,tk,dtype,tol", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_pallas_interpret(name, shape, tk, dtype, tol):
    (jq, jk, jv), (tq, tk_, tv) = _inputs(shape, tk, dtype, seed=len(name))
    want = np.asarray(jax_flash(jq, jk, jv, block_q=128, interpret=True), np.float32)
    got = flash_attention_plain(tq, tk_, tv)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_wrapper_on_cpu_takes_plain_version_and_counts_nothing():
    _, (q, k, v) = _inputs((1, 2, 8, 32), 100, np.float32, seed=0)
    before = flash_attention.launches
    out = flash_attention(q, k, v)       # head dim 32: the plain version takes any
    assert flash_attention.launches == before
    torch.testing.assert_close(out, flash_attention_plain(q, k, v), rtol=0, atol=0)


def test_kernel_library_path_follows_source(tmp_path, monkeypatch):
    p1 = build.library_path("flash_attention")
    assert p1.parent == build.BUILD_DIR and p1.name.startswith("libflash_attention-")
    src = tmp_path / "flash_attention.cu"
    src.write_text((build.CSRC_DIR / "flash_attention.cu").read_text() + "\n// edit\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    assert build.library_path("flash_attention") != p1      # an edit rebuilds
