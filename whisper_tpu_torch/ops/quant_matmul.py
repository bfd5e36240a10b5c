"""Int8 block-dequant matmul: the hand-written CUDA kernels and their plain
version.

Replaces whisper_tpu/ops/quant_matmul.py::_qmm_kernel (B2) and
::_qmm_kernel_offset (B3), the Pallas TPU kernels, with one source,
csrc/quant_matmul.cu, built for sm_90a by ops/build.py and called through
ctypes on PyTorch's current stream. The source's header says what bounds it
on an H100 and how its design differs from the TPU kernels'. In short:

- M <= 16 (the decode step) is bound by the weight's bytes: one launch of
  a thread block cluster kernel that has each CTA's whole share of q in
  flight at once, multiplies with mma.sync (the weight as the A operand)
  and adds the CTAs' sums through distributed shared memory (st.async
  into the owning CTA, added in rank order), with no atomics, so the same
  inputs give bit-identical y on every call. `plan_skinny` sizes the
  cluster;
- M > 16 (encoder, cross-KV, prompt buckets) runs on wgmma, 128 x 128
  output tiles.

Layout, the JAX package's (keep_quantized leaves of checkpoint/loader.py):

- q (IN, OUT) int8: input rows, output columns — the transpose of the
  dense "w" leaves, which are [out, in];
- d (IN // qblock, OUT) float32: the scale of each qblock-row input block
  of each column; qblock is 32 (legacy formats, q4_K, q5_K) or 16 (the
  16-element K-quant sub-blocks: q2_K, q3_K, q6_K);
- m (IN // qblock, OUT) float32, offset formats only (q4_1, q5_1, q2_K,
  q4_K, q5_K): y = x @ (q * d + m) with d and m repeated over each block.

`quant_matmul(x, q, d, m=None, qblock=32)` takes x (..., IN) and returns
(..., OUT) float32 with the TPU kernel's rounding: x rounded to bf16,
w = bf16(bf16(q) * bf16(d)) (+ bf16(m), rounded to bf16), the products
summed in float32. The caller adds the bias and casts.

- on a CPU tensor it computes `quant_matmul_plain`;
- on a CUDA tensor it launches the kernel or raises (int8 q, float32 d
  and m on x's device, contiguous and starting on a 16-byte boundary, as
  bf16 x must be; IN a multiple of qblock, OUT a multiple of 16, qblock 16
  or 32). There is no fallback. The leaves q, d, m are checked at their
  first call together and not again (a leaf is not reshaped or moved in
  place afterwards; a new tensor is checked anew); x at every call.

`quant_matmul.launches` and `quant_matmul.launches_offset` count kernel
launches without and with the offset operand (never plain calls), so a run
can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

QBLOCK = 32              # default block size (legacy formats)
SKINNY_ROWS = 16         # M at or below it takes the skinny path
SKINNY_COLS = 128        # output columns of a skinny CTA (SK_COLS in the .cu)
SKINNY_MAX_CLUSTER = 16  # CTAs of a cluster (SK_MAX_CLUSTER in the .cu)
SKINNY_CTAS = 320        # CTAs a skinny grid aims at: ~2.5 an SM of an H100's 132


def dequant_reference(q: torch.Tensor, d: torch.Tensor, m=None,
                      qblock: int = QBLOCK) -> torch.Tensor:
    """Materialized float32 dequantization (the test oracle):
    q * repeat(d) (+ repeat(m)), (IN, OUT)."""
    w = q.float() * torch.repeat_interleave(d.float(), qblock, dim=0)
    if m is not None:
        w = w + torch.repeat_interleave(m.float(), qblock, dim=0)
    return w


def dequant_bf16(q: torch.Tensor, d: torch.Tensor, m=None,
                 qblock: int = QBLOCK) -> torch.Tensor:
    """The kernel's weight, (IN, OUT) bf16: bf16(bf16(q) * bf16(d)), then
    + bf16(m) rounded to bf16 for the offset formats (the TPU kernel's
    quant_matmul.py:38-39, 51-53)."""
    IN, OUT = q.shape
    w = q.to(torch.bfloat16).reshape(IN // qblock, qblock, OUT) \
        * d.to(torch.bfloat16)[:, None, :]
    if m is not None:
        w = w + m.to(torch.bfloat16)[:, None, :]
    return w.reshape(IN, OUT)


def quant_matmul_plain(x: torch.Tensor, q: torch.Tensor, d: torch.Tensor,
                       m=None, qblock: int = QBLOCK) -> torch.Tensor:
    """The same function in plain PyTorch: bf16 operands widened to float32
    (exact products) and summed in float32."""
    IN, OUT = q.shape
    xb = x.reshape(-1, IN).to(torch.bfloat16).float()
    y = xb @ dequant_bf16(q, d, m, qblock).float()
    return y.reshape(*x.shape[:-1], OUT)


@functools.lru_cache(maxsize=None)
def plan_skinny(M: int, IN: int, OUT: int, qblock: int) -> int:
    """CTAs of a skinny-path cluster for y (M, OUT) = x (M, IN) @ w: the
    grid is ceil(OUT / 128) column tiles x this many CTAs along IN, about
    SKINNY_CTAS in all (two or three an SM, so that one CTA's loads overlap
    another's products and sums), at most SKINNY_MAX_CLUSTER and at most
    one per qblock-row block (so every CTA holds a real block). The kernel
    gives rank r of C the blocks [r*n/C, (r+1)*n/C) of the n = IN / qblock."""
    if not 1 <= M <= SKINNY_ROWS:
        raise ValueError(f"the skinny path takes 1 <= M <= {SKINNY_ROWS}, got {M}")
    col_tiles = -(-OUT // SKINNY_COLS)
    return max(1, min(SKINNY_MAX_CLUSTER, IN // qblock, SKINNY_CTAS // col_tiles))


def _kernel():
    """The C entry point wt_quant_matmul, built and typed on first use."""
    global _entry
    if _entry is None:
        from whisper_tpu_torch.ops import build
        fn = build.load("quant_matmul").wt_quant_matmul
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


_entry = None


def _check(x, q, d, m, qblock) -> None:
    """The leaves' refusals, made at their first call (see the module
    docstring)."""
    if q.ndim != 2 or x.shape[-1] != q.shape[0]:
        raise ValueError(f"quant_matmul shapes x {tuple(x.shape)}, q {tuple(q.shape)}")
    IN, OUT = q.shape
    if qblock not in (16, 32) or IN % qblock:
        raise ValueError(f"quant_matmul kernel takes qblock 16 or 32 dividing IN, "
                         f"got qblock {qblock}, IN {IN}")
    if OUT % 16:
        raise ValueError(f"quant_matmul kernel takes OUT a multiple of 16, got {OUT}")
    if q.dtype != torch.int8:
        raise ValueError(f"quant_matmul kernel takes int8 q, got {q.dtype}")
    for name, t in (("d", d), ("m", m)):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.shape != (IN // qblock, OUT):
            raise ValueError(f"quant_matmul kernel takes float32 {name} of shape "
                             f"{(IN // qblock, OUT)}, got {t.dtype} {tuple(t.shape)}")
    for name, t in (("q", q), ("d", d), ("m", m)):
        if t is None:
            continue
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("quant_matmul kernel takes contiguous q, d, m on x's device")
        if t.data_ptr() % 16:
            raise ValueError(f"quant_matmul kernel takes {name} starting on a 16-byte "
                             f"boundary (it loads 16 bytes at a time)")


def quant_matmul(x: torch.Tensor, q: torch.Tensor, d: torch.Tensor, m=None,
                 qblock: int = QBLOCK) -> torch.Tensor:
    """y[..., OUT] = bf16(x) @ dequant(q, d[, m]) in float32; the kernel on
    CUDA, the plain version on the CPU (see the module docstring)."""
    if not x.is_cuda:
        return quant_matmul_plain(x, q, d, m, qblock)
    device = x.get_device()
    seen = getattr(q, "_wt_qmm_checked", None)
    if seen is None or seen[0] is not d or seen[1] is not m or seen[2:4] != (qblock, device):
        _check(x, q, d, m, qblock)
        seen = q._wt_qmm_checked = (d, m, qblock, device, q.data_ptr(), d.data_ptr(),
                                    None if m is None else m.data_ptr())
    IN, OUT = q.shape
    if x.shape[-1] != IN:
        raise ValueError(f"quant_matmul shapes x {tuple(x.shape)}, q {tuple(q.shape)}")
    xb = x if x.dim() == 2 else x.reshape(-1, IN)
    if xb.dtype != torch.bfloat16:
        xb = xb.to(torch.bfloat16)
    if not xb.is_contiguous():
        xb = xb.contiguous()
    x_ptr = xb.data_ptr()
    if x_ptr % 16:
        raise ValueError("quant_matmul kernel takes x starting on a 16-byte boundary "
                         "(it loads 16 bytes at a time)")
    M = xb.shape[0]
    y = xb.new_empty((M, OUT), dtype=torch.float32)
    rc = _kernel()(x_ptr, seen[4], seen[5], seen[6], y.data_ptr(), M, IN, OUT, qblock,
                   plan_skinny(M, IN, OUT, qblock) if M <= SKINNY_ROWS else 0,
                   device, torch._C._cuda_getCurrentRawStream(device))
    if rc != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error {rc}")
    if m is None:
        quant_matmul.launches += 1
    else:
        quant_matmul.launches_offset += 1
    return y if x.dim() == 2 else y.reshape(*x.shape[:-1], OUT)


quant_matmul.launches = 0
quant_matmul.launches_offset = 0


def repack_blocks(w_rowmajor_q, w_rowmajor_d, out_dim: int, in_dim: int,
                  w_rowmajor_m=None, qblock: int = QBLOCK):
    """(nb, bs) int8 + (nb,) scales [+ (nb,) offsets] over a row-major
    [out, in] tensor (checkpoint/quant.dequantize_to_int8_blocks) ->
    (in, out) int8 + (in//bs, out) float32 [+ (in//bs, out) float32], the
    layout above (the JAX package's repack_for_tpu)."""
    q = np.asarray(w_rowmajor_q).reshape(out_dim, in_dim).T.copy()
    d = np.asarray(w_rowmajor_d).reshape(out_dim, in_dim // qblock).T.copy()
    if w_rowmajor_m is None:
        return q, d
    m = np.asarray(w_rowmajor_m).reshape(out_dim, in_dim // qblock).T.copy()
    return q, d, m
