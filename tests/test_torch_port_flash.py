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
from whisper_tpu_torch.ops.flash_attention import (
    BLOCK_K, BLOCK_Q, flash_attention, flash_attention_plain, plan_splits)

CASES = [
    # (name, q shape, Tk, dtype, tolerance)
    ("f32", (1, 2, 256, 64), 256, np.float32, 1e-5),
    ("bf16", (1, 2, 256, 64), 256, "bfloat16", 2e-2),
    ("tq_ne_tk", (1, 3, 40, 64), 1500, np.float32, 1e-5),
    ("unaligned_tk", (2, 2, 70, 64), 300, np.float32, 1e-5),
    ("unaligned_tk_bf16", (1, 2, 8, 64), 1500, "bfloat16", 2e-2),
    # large-v3's beam-5 prompt pass: 5 beams x 8 rows folded into Tq
    ("beam5_folded_bf16", (1, 20, 40, 64), 1500, "bfloat16", 2e-2),
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


def test_kernel_library_path_follows_shared_header(tmp_path, monkeypatch):
    p1 = build.library_path("quant_matmul")
    for f in build.CSRC_DIR.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    assert build.library_path("quant_matmul") == p1         # same bytes, same library
    header = tmp_path / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edit\n")
    assert build.library_path("quant_matmul") != p1         # a header edit rebuilds


SPLIT_SHAPES = [  # (BH, Tq, Tk)
    (20, 8, 1500), (20, 40, 1500), (20, 64, 1500), (20, 1500, 1500),
    (1, 1, 1), (1, 8, 63), (40, 129, 131), (1, 1500, 1500), (3, 1, 64), (200, 8, 1500),
]


def split_bounds(tk, n_splits):
    """The key ranges [start, end) of the splits as the kernel cuts them
    (csrc/flash_attention.cu attn_tc: 64-key tiles [s*n/S, (s+1)*n/S))."""
    n_k = -(-tk // BLOCK_K)
    return [(s * n_k // n_splits * BLOCK_K, min(tk, (s + 1) * n_k // n_splits * BLOCK_K))
            for s in range(n_splits)]


@pytest.mark.parametrize("bh,tq,tk", SPLIT_SHAPES)
def test_split_plan_covers_keys_with_nonempty_splits(bh, tq, tk):
    n = plan_splits(bh, tq, tk)
    assert 1 <= n <= -(-tk // BLOCK_K)
    bounds = split_bounds(tk, n)
    assert bounds[0][0] == 0 and bounds[-1][1] == tk
    for (a, b), (c, _) in zip(bounds, bounds[1:]):
        assert b == c                                     # contiguous, no overlap
    assert all(b > a for a, b in bounds)                  # every split holds a real key


@pytest.mark.parametrize("tq", [8, 40, 64])
def test_split_plan_fills_a_wave_at_the_prompt_shape(tq):
    """large-v3's prompt pass (20 heads, Tq 8, or 40 with beam-5 folded, Tk
    1500): at least one CTA per SM of the H100's 132."""
    n_q = -(-tq // BLOCK_Q)
    assert 20 * n_q * plan_splits(20, tq, 1500) >= 132
    assert plan_splits(20, 1500, 1500) == 1               # the encoder fills the card alone
