"""Flash attention: the hand-written CUDA kernel and its plain version.

Replaces whisper_tpu/ops/flash_attention.py::_attn_kernel (the Pallas TPU
kernel) with csrc/flash_attention.cu, built for sm_90a by ops/build.py and
called through ctypes on PyTorch's current stream. The source's header
says what bounds it on an H100 and how its design differs from the TPU
kernel's.

`flash_attention(q, k, v)` computes softmax(q k^T / sqrt(D)) v for
q (B, H, Tq, D) and k, v (B, H, Tk, D), Tq != Tk allowed:

- on a CPU tensor it computes `flash_attention_plain`;
- on a CUDA tensor it launches the kernel, or raises: D must be 64 (every
  Whisper preset), the dtype float32 or bfloat16, and q, k, v (after
  `.contiguous()`) must start on a 16-byte boundary. There is no fallback.

bfloat16 takes the tensor-core kernel, float32 the CUDA-core one (the
source's header says why). With bf16 and few query tiles, `plan_splits`
splits the keys across CTAs, and the call then starts two CUDA kernels:
the split pass and the merge.

`flash_attention.launches` counts wrapper calls that launched the kernel
(one per call, whether it started one CUDA kernel or two; never plain
calls), so a run can show that its path went through the kernel. Where
`flash_attention.tally` is set (tools/hbm_audit.py), each launch also
reports the bytes of its operands to it, tally("B1", n): q, k, v and out,
and the split pass's partial results written and read back by the merge;
the launch goes through ctypes, which PyTorch's dispatcher never sees.
"""

from __future__ import annotations

import ctypes

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 64
BLOCK_Q = 128       # query rows per CTA of the bf16 kernel (TC_BQ in the .cu)
BLOCK_K = 64        # keys per tile (BLOCK_K in the .cu)
SMS = 132           # streaming multiprocessors of an H100 SXM


def plan_splits(bh: int, tq: int, tk: int) -> int:
    """Key-tile ranges per (head, query tile) for the bf16 kernel: 1 when
    bh * query tiles fill a wave of SMS CTAs, else enough to fill one, at
    most one range per 64-key tile (so every range holds a real key; the
    C entry point refuses more). The kernel gives split s of S the 64-key
    tiles [s*n/S, (s+1)*n/S) of the n = ceil(Tk / 64)."""
    n_q, n_k = -(-tq // BLOCK_Q), -(-tk // BLOCK_K)
    if bh * n_q >= SMS:
        return 1
    return min(n_k, -(-SMS // (bh * n_q)))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: a float32 full-row softmax of
    the scaled scores, p rounded to v's dtype, p v summed in float32, the
    output in q's dtype (the JAX package's `attention` with no mask)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def _lib():
    from whisper_tpu_torch.ops import build
    lib = build.load("flash_attention")
    if not getattr(lib, "_wt_typed", False):
        fn = lib.wt_flash_attention
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib._wt_typed = True
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v; the kernel on CUDA, the plain version
    on the CPU (see the module docstring)."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if D != HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head dim {HEAD_DIM}, got {D}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16 "
                         f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != (B, H, Tk, D) or v.shape != k.shape or Tq == 0 or Tk == 0:
        raise ValueError(f"flash_attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    for name, t in (("q", qc), ("k", kc), ("v", vc)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel takes {name} starting on a 16-byte "
                             f"boundary (it loads 16 bytes at a time)")
    out = torch.empty_like(qc)
    n_splits = plan_splits(B * H, Tq, Tk) if q.dtype == torch.bfloat16 else 1
    part = (torch.empty(n_splits * B * H * Tq * (D + 2), dtype=torch.float32,
                        device=q.device) if n_splits > 1 else None)
    rc = _lib().wt_flash_attention(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), B * H, Tq, Tk, D ** -0.5,
        _DTYPE_CODES[q.dtype], n_splits, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    if flash_attention.tally is not None:
        flash_attention.tally("B1", sum(t.numel() * t.element_size() for t in (qc, kc, vc, out))
                              + (0 if part is None else 2 * part.numel() * part.element_size()))
    return out


flash_attention.launches = 0
flash_attention.tally = None
