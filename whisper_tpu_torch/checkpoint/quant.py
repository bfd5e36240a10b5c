"""ggml block-quantization codecs (numpy, vectorized).

Implements the block formats the reference's quantized checkpoints use
(layouts from ggml/src/ggml-common.h:167-340; scalar codecs in
ggml/src/ggml-quants.c). The legacy formats cover 32 consecutive elements:

  Q4_0: fp16 d;          16B nibbles          v = (q4 - 8) * d
  Q4_1: fp16 d, fp16 m;  16B nibbles          v = q4 * d + m
  Q5_0: fp16 d; u32 qh;  16B nibbles          v = ((q4 | hi_bit<<4) - 16) * d
  Q5_1: fp16 d, fp16 m; u32 qh; 16B nibbles   v = (q4 | hi_bit<<4) * d + m
  Q8_0: fp16 d;          32 int8              v = q8 * d

Nibble packing: byte j holds element j (low nibble) and element j+16 (high
nibble). qh bit i is the 5th bit of element i.

K-quants are 256-element SUPER-blocks (QK_K, ggml-common.h:87-340) with
per-sub-block scales quantized against one fp16 super-scale:

  Q2_K: 16 sub-blocks of 16; v = (d*sc4)*q2 - (dmin*m4)
  Q3_K: 16 sub-blocks of 16; v = (d*(sc6-32)) * (q3-4)       [symmetric]
  Q4_K:  8 sub-blocks of 32; v = (d*sc6)*q4 - (dmin*m6)
  Q5_K:  8 sub-blocks of 32; v = (d*sc6)*(q4|hb<<4) - (dmin*m6)
  Q6_K: 16 sub-blocks of 16; v = (d*sc8) * (q6-32)           [symmetric]

The dequantizers below replicate dequantize_row_q{2..6}_K
(ggml-quants.c:706,1050,1274,1476,1684) element-for-element including float
multiply order, so a K-quantized .bin produced by the reference's own
quantize tool decodes to bit-identical f32 here. The quantizers produce
valid blocks with simple min/max (offset formats) or abs-max (symmetric)
sub-block scaling — the container is reference-loadable; the search
heuristics (make_qkx2_quants etc.) are intentionally not replicated.

This module is pure numpy and runs host-side with no accelerator. It is the
port's own copy of whisper_tpu/checkpoint/quant.py, so the port never
imports the JAX package; the JAX-only shape helper is left out, and the
int8-block repack (`dequantize_to_int8_blocks`) is kept for the
keep_quantized kernels of ROADMAP B2/B3.
"""

from __future__ import annotations

import numpy as np

QK = 32     # block size for the legacy formats
QK_K = 256  # super-block size for K-quants (ggml-common.h:89)
K_SCALE_SIZE = 12

GGML_TYPE_F32 = 0
GGML_TYPE_F16 = 1
GGML_TYPE_Q4_0 = 2
GGML_TYPE_Q4_1 = 3
GGML_TYPE_Q5_0 = 6
GGML_TYPE_Q5_1 = 7
GGML_TYPE_Q8_0 = 8
GGML_TYPE_Q2_K = 10
GGML_TYPE_Q3_K = 11
GGML_TYPE_Q4_K = 12
GGML_TYPE_Q5_K = 13
GGML_TYPE_Q6_K = 14
GGML_TYPE_I8 = 24
GGML_TYPE_I16 = 25
GGML_TYPE_I32 = 26

# type -> (block_nbytes, block_nelems); float/int types have block size 1
TYPE_TRAITS = {
    GGML_TYPE_F32: (4, 1),
    GGML_TYPE_F16: (2, 1),
    GGML_TYPE_Q4_0: (2 + 16, QK),
    GGML_TYPE_Q4_1: (2 + 2 + 16, QK),
    GGML_TYPE_Q5_0: (2 + 4 + 16, QK),
    GGML_TYPE_Q5_1: (2 + 2 + 4 + 16, QK),
    GGML_TYPE_Q8_0: (2 + 32, QK),
    # K-quant super-blocks (ggml-common.h struct sizes)
    GGML_TYPE_Q2_K: (QK_K // 16 + QK_K // 4 + 4, QK_K),           # 84
    GGML_TYPE_Q3_K: (QK_K // 8 + QK_K // 4 + 12 + 2, QK_K),       # 110
    GGML_TYPE_Q4_K: (4 + K_SCALE_SIZE + QK_K // 2, QK_K),         # 144
    GGML_TYPE_Q5_K: (4 + K_SCALE_SIZE + QK_K // 8 + QK_K // 2, QK_K),  # 176
    GGML_TYPE_Q6_K: (QK_K // 2 + QK_K // 4 + QK_K // 16 + 2, QK_K),    # 210
    GGML_TYPE_I8: (1, 1),
    GGML_TYPE_I16: (2, 1),
    GGML_TYPE_I32: (4, 1),
}

TYPE_NAMES = {
    GGML_TYPE_F32: "f32", GGML_TYPE_F16: "f16", GGML_TYPE_Q4_0: "q4_0",
    GGML_TYPE_Q4_1: "q4_1", GGML_TYPE_Q5_0: "q5_0", GGML_TYPE_Q5_1: "q5_1",
    GGML_TYPE_Q8_0: "q8_0", GGML_TYPE_Q2_K: "q2_K", GGML_TYPE_Q3_K: "q3_K",
    GGML_TYPE_Q4_K: "q4_K", GGML_TYPE_Q5_K: "q5_K", GGML_TYPE_Q6_K: "q6_K",
}

# ggml_ftype -> per-tensor ggml_type for the "big" tensors
# (reference ggml/src/ggml.c ggml_ftype_to_ggml_type; K-quant rows
# ggml/include/ggml.h:411-415)
FTYPE_TO_TYPE = {
    0: GGML_TYPE_F32, 1: GGML_TYPE_F16, 2: GGML_TYPE_Q4_0, 3: GGML_TYPE_Q4_1,
    8: GGML_TYPE_Q5_0, 9: GGML_TYPE_Q5_1, 7: GGML_TYPE_Q8_0,
    10: GGML_TYPE_Q2_K, 11: GGML_TYPE_Q3_K, 12: GGML_TYPE_Q4_K,
    13: GGML_TYPE_Q5_K, 14: GGML_TYPE_Q6_K,
}
TYPE_TO_FTYPE = {v: k for k, v in FTYPE_TO_TYPE.items()}

K_QUANT_TYPES = (GGML_TYPE_Q2_K, GGML_TYPE_Q3_K, GGML_TYPE_Q4_K,
                 GGML_TYPE_Q5_K, GGML_TYPE_Q6_K)


def type_size(ttype: int) -> int:
    return TYPE_TRAITS[ttype][0]


def block_size(ttype: int) -> int:
    return TYPE_TRAITS[ttype][1]


def row_nbytes(ttype: int, nelems: int) -> int:
    bs, bn = TYPE_TRAITS[ttype]
    assert nelems % bn == 0, f"nelems {nelems} not divisible by block {bn}"
    return nelems // bn * bs


def _split_nibbles(qs: np.ndarray) -> np.ndarray:
    """(nb, 16) uint8 -> (nb, 32) int: elements [low nibbles | high nibbles]."""
    lo = (qs & 0x0F).astype(np.int32)
    hi = (qs >> 4).astype(np.int32)
    return np.concatenate([lo, hi], axis=1)


def _pack_nibbles(q: np.ndarray) -> np.ndarray:
    """(nb, 32) int -> (nb, 16) uint8."""
    lo = q[:, :16].astype(np.uint8)
    hi = q[:, 16:].astype(np.uint8)
    return lo | (hi << 4)


def _qh_bits(qh: np.ndarray) -> np.ndarray:
    """(nb,) uint32 -> (nb, 32) int 5th bits."""
    shifts = np.arange(32, dtype=np.uint32)
    return ((qh[:, None] >> shifts[None, :]) & 1).astype(np.int32)


def _pack_qh(bits: np.ndarray) -> np.ndarray:
    shifts = np.arange(32, dtype=np.uint32)
    return (bits.astype(np.uint32) << shifts[None, :]).sum(axis=1, dtype=np.uint64).astype(np.uint32)


# ---------------------------------------------------------------------------
# K-quant helpers (256-element super-blocks)
# ---------------------------------------------------------------------------

# flat element index within a super-block, used by several layouts
_EK = np.arange(QK_K)


def _f16col(blocks: np.ndarray, off: int) -> np.ndarray:
    """fp16 scalar at byte offset `off` of each block -> (nb, 1) float32."""
    return blocks[:, off:off + 2].copy().view(np.float16).astype(np.float32)


def _scale_min_k4(s: np.ndarray):
    """Vectorized get_scale_min_k4 (ggml-quants.c:625-633): 12 packed bytes
    -> 8 six-bit scales + 8 six-bit mins per super-block."""
    s = s.astype(np.int32)
    sc = np.empty((s.shape[0], 8), np.int32)
    m = np.empty_like(sc)
    sc[:, :4] = s[:, 0:4] & 63
    m[:, :4] = s[:, 4:8] & 63
    sc[:, 4:] = (s[:, 8:12] & 0xF) | ((s[:, 0:4] >> 6) << 4)
    m[:, 4:] = (s[:, 8:12] >> 4) | ((s[:, 4:8] >> 6) << 4)
    return sc, m


def _pack_scale_min_k4(sc: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Inverse of _scale_min_k4: (nb, 8) six-bit scales/mins -> (nb, 12)."""
    nb = sc.shape[0]
    out = np.zeros((nb, 12), np.uint8)
    out[:, 0:4] = (sc[:, :4] | ((sc[:, 4:] >> 4) << 6)).astype(np.uint8)
    out[:, 4:8] = (m[:, :4] | ((m[:, 4:] >> 4) << 6)).astype(np.uint8)
    out[:, 8:12] = ((sc[:, 4:] & 0xF) | ((m[:, 4:] & 0xF) << 4)).astype(np.uint8)
    return out


def _q3_scales_unpack(sraw: np.ndarray) -> np.ndarray:
    """block_q3_K 12-byte scale field -> (nb, 16) int32 in [0, 63]
    (the kmask shuffle in dequantize_row_q3_K, ggml-quants.c:1054-1073)."""
    a = np.ascontiguousarray(sraw).view(np.uint32)        # (nb, 3)
    a0, a1, t = a[:, 0], a[:, 1], a[:, 2]
    km1 = np.uint32(0x03030303)
    km2 = np.uint32(0x0f0f0f0f)
    n0 = (a0 & km2) | (((t >> np.uint32(0)) & km1) << np.uint32(4))
    n1 = (a1 & km2) | (((t >> np.uint32(2)) & km1) << np.uint32(4))
    n2 = ((a0 >> np.uint32(4)) & km2) | (((t >> np.uint32(4)) & km1) << np.uint32(4))
    n3 = ((a1 >> np.uint32(4)) & km2) | (((t >> np.uint32(6)) & km1) << np.uint32(4))
    packed = np.ascontiguousarray(np.stack([n0, n1, n2, n3], axis=1))
    return packed.view(np.uint8).reshape(-1, 16).astype(np.int32)


def _q3_scales_pack(s6: np.ndarray) -> np.ndarray:
    """(nb, 16) six-bit values -> the 12-byte block_q3_K scale field."""
    nb = s6.shape[0]
    lo = (s6 & 0xF).astype(np.uint8)
    hi = (s6 >> 4).astype(np.uint8)                       # 2 bits
    out = np.zeros((nb, 12), np.uint8)
    out[:, 0:4] = lo[:, 0:4] | (lo[:, 8:12] << 4)
    out[:, 4:8] = lo[:, 4:8] | (lo[:, 12:16] << 4)
    out[:, 8:12] = (hi[:, 0:4] | (hi[:, 4:8] << 2)
                    | (hi[:, 8:12] << 4) | (hi[:, 12:16] << 6))
    return out


# element -> storage maps shared by the 2-bit low-quant layouts (q2/q3):
# qs byte 32*(e//128) + e%32, shift 2*((e//32)%4)
_Q2_BYTE = (32 * (_EK // 128) + _EK % 32)
_Q2_SHIFT = (2 * ((_EK // 32) % 4)).astype(np.uint8)


def _dequant_q2_K(blocks: np.ndarray) -> np.ndarray:
    # layout: scales[16] qs[64] d f16 dmin f16 (ggml-common.h:255-265)
    scales = blocks[:, 0:16].astype(np.int32)
    qs = blocks[:, 16:80]
    d = _f16col(blocks, 80)
    dmin = _f16col(blocks, 82)
    q = ((qs[:, _Q2_BYTE] >> _Q2_SHIFT) & 3).astype(np.float32)
    sc = scales[:, _EK // 16]
    dl = d * (sc & 0xF).astype(np.float32)
    ml = dmin * (sc >> 4).astype(np.float32)
    return (dl * q - ml).reshape(-1)


def _dequant_q3_K(blocks: np.ndarray) -> np.ndarray:
    # layout: hmask[32] qs[64] scales[12] d f16 (ggml-common.h:272-279)
    hm = blocks[:, 0:32]
    qs = blocks[:, 32:96]
    s6 = _q3_scales_unpack(blocks[:, 96:108])
    d = _f16col(blocks, 108)
    q2 = ((qs[:, _Q2_BYTE] >> _Q2_SHIFT) & 3).astype(np.int32)
    mbit = ((hm[:, _EK % 32] >> (_EK // 32).astype(np.uint8)) & 1).astype(bool)
    q = (q2 - np.where(mbit, 0, 4)).astype(np.float32)
    dl = d * (s6[:, _EK // 16] - 32).astype(np.float32)
    return (dl * q).reshape(-1)


# q4_K/q5_K: qs byte 32*(e//64) + e%32, high nibble when (e%64) >= 32
_Q4K_BYTE = (32 * (_EK // 64) + _EK % 32)
_Q4K_SHIFT = (4 * ((_EK % 64) // 32)).astype(np.uint8)


def _dequant_q4_K(blocks: np.ndarray) -> np.ndarray:
    # layout: d f16 dmin f16 scales[12] qs[128] (ggml-common.h:284-296)
    d = _f16col(blocks, 0)
    dmin = _f16col(blocks, 2)
    sc8, m8 = _scale_min_k4(blocks[:, 4:16])
    qs = blocks[:, 16:144]
    q = ((qs[:, _Q4K_BYTE] >> _Q4K_SHIFT) & 0xF).astype(np.float32)
    dl = d * sc8[:, _EK // 32].astype(np.float32)
    ml = dmin * m8[:, _EK // 32].astype(np.float32)
    return (dl * q - ml).reshape(-1)


_Q5K_HBIT = (2 * (_EK // 64) + (_EK % 64) // 32).astype(np.uint8)


def _dequant_q5_K(blocks: np.ndarray) -> np.ndarray:
    # layout: d f16 dmin f16 scales[12] qh[32] qs[128] (ggml-common.h:301-315)
    d = _f16col(blocks, 0)
    dmin = _f16col(blocks, 2)
    sc8, m8 = _scale_min_k4(blocks[:, 4:16])
    qh = blocks[:, 16:48]
    qs = blocks[:, 48:176]
    q4 = ((qs[:, _Q4K_BYTE] >> _Q4K_SHIFT) & 0xF).astype(np.int32)
    hb = ((qh[:, _EK % 32] >> _Q5K_HBIT) & 1).astype(np.int32)
    q = (q4 + 16 * hb).astype(np.float32)
    dl = d * sc8[:, _EK // 32].astype(np.float32)
    ml = dmin * m8[:, _EK // 32].astype(np.float32)
    return (dl * q - ml).reshape(-1)


# q6_K: within each 128-half, ql byte k%64 (nibble k//64), qh byte k%32
# (2 bits at 2*(k//32)); scale index e//16 (ggml-quants.c:1684-1714)
_Q6_K_IN_HALF = _EK % 128
_Q6_QL_BYTE = 64 * (_EK // 128) + _Q6_K_IN_HALF % 64
_Q6_QL_SHIFT = (4 * (_Q6_K_IN_HALF // 64)).astype(np.uint8)
_Q6_QH_BYTE = 32 * (_EK // 128) + _Q6_K_IN_HALF % 32
_Q6_QH_SHIFT = (2 * ((_Q6_K_IN_HALF // 32) % 4)).astype(np.uint8)


def _dequant_q6_K(blocks: np.ndarray) -> np.ndarray:
    # layout: ql[128] qh[64] scales int8[16] d f16 (ggml-common.h:320-327)
    ql = blocks[:, 0:128]
    qh = blocks[:, 128:192]
    sc = blocks[:, 192:208].view(np.int8).astype(np.int32)
    d = _f16col(blocks, 208)
    lo = (ql[:, _Q6_QL_BYTE] >> _Q6_QL_SHIFT) & 0xF
    hi = (qh[:, _Q6_QH_BYTE] >> _Q6_QH_SHIFT) & 3
    q = ((lo.astype(np.int32) | (hi.astype(np.int32) << 4)) - 32).astype(np.float32)
    dl = d * sc[:, _EK // 16].astype(np.float32)
    return (dl * q).reshape(-1)


_K_DEQUANT = {
    GGML_TYPE_Q2_K: _dequant_q2_K, GGML_TYPE_Q3_K: _dequant_q3_K,
    GGML_TYPE_Q4_K: _dequant_q4_K, GGML_TYPE_Q5_K: _dequant_q5_K,
    GGML_TYPE_Q6_K: _dequant_q6_K,
}


def dequantize(raw: bytes | np.ndarray, ttype: int, nelems: int) -> np.ndarray:
    """Decode a raw ggml tensor payload to float32 (flat array of nelems).

    From 2**16 elements on, the threaded host runtime (runtime/native.py)
    decodes the block formats and f16 when it is built; the numpy path
    below computes the same values and serves when it is not."""
    buf = np.frombuffer(raw, dtype=np.uint8) if not isinstance(raw, np.ndarray) else raw
    if ttype == GGML_TYPE_F32:
        return buf.view(np.float32)[:nelems].copy()
    if ttype in (GGML_TYPE_F16, GGML_TYPE_Q4_0, GGML_TYPE_Q4_1, GGML_TYPE_Q5_0,
                 GGML_TYPE_Q5_1, GGML_TYPE_Q8_0) + K_QUANT_TYPES and nelems >= 1 << 16:
        from whisper_tpu_torch.runtime import native
        out = native.dequantize(ttype, buf, nelems)
        if out is not None:
            return out
    if ttype == GGML_TYPE_F16:
        return buf.view(np.float16)[:nelems].astype(np.float32)
    if ttype == GGML_TYPE_I32:
        return buf.view(np.int32)[:nelems].astype(np.float32)

    if ttype in K_QUANT_TYPES:
        nbk = nelems // QK_K
        bsk = type_size(ttype)
        return _K_DEQUANT[ttype](buf[: nbk * bsk].reshape(nbk, bsk))

    nb = nelems // QK
    bs = type_size(ttype)
    blocks = buf[: nb * bs].reshape(nb, bs)

    if ttype == GGML_TYPE_Q4_0:
        d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)
        q = _split_nibbles(blocks[:, 2:18]) - 8
        return (q * d).astype(np.float32).reshape(-1)
    if ttype == GGML_TYPE_Q4_1:
        d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)
        m = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
        q = _split_nibbles(blocks[:, 4:20])
        return (q * d + m).astype(np.float32).reshape(-1)
    if ttype == GGML_TYPE_Q5_0:
        d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)
        qh = blocks[:, 2:6].copy().view(np.uint32).reshape(-1)
        q = _split_nibbles(blocks[:, 6:22]) | (_qh_bits(qh) << 4)
        return ((q - 16) * d).astype(np.float32).reshape(-1)
    if ttype == GGML_TYPE_Q5_1:
        d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)
        m = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
        qh = blocks[:, 4:8].copy().view(np.uint32).reshape(-1)
        q = _split_nibbles(blocks[:, 8:24]) | (_qh_bits(qh) << 4)
        return (q * d + m).astype(np.float32).reshape(-1)
    if ttype == GGML_TYPE_Q8_0:
        d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)
        q = blocks[:, 2:34].view(np.int8).astype(np.int32)
        return (q * d).astype(np.float32).reshape(-1)
    raise ValueError(f"unsupported ggml type {ttype}")


def _nearest(x: np.ndarray) -> np.ndarray:
    """Round to nearest (ties to even, like ggml's nearest_int bit trick)."""
    return np.rint(x).astype(np.int32)


def _safe_div(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """num/den with 0 where den == 0 (ggml guards with `if (!d) continue`)."""
    return np.where(den != 0, num / np.where(den == 0, 1, den), 0.0)


def _minmax_k_scales(sub: np.ndarray, nmax: int, q_bits: int):
    """Shared offset-format sub-block scaling: x ~ dl*q - ml with q in
    [0, nmax], sub-scales/mins quantized to q_bits against fp16 supers.
    sub: (nb, n_sub, sub_len). Returns (d16, dmin16, ls, lm, q)."""
    smax = (1 << q_bits) - 1
    mn = sub.min(axis=2)
    mx = sub.max(axis=2)
    the_min = np.maximum(0.0, -mn)                        # (nb, n_sub)
    scale = np.maximum(mx + the_min, 0.0) / nmax
    max_scale = scale.max(axis=1)
    max_min = the_min.max(axis=1)
    d16 = np.where(max_scale > 0, max_scale / smax, 0.0).astype(np.float16)
    dmin16 = np.where(max_min > 0, max_min / smax, 0.0).astype(np.float16)
    ls = np.clip(_nearest(smax * _safe_div(scale, max_scale[:, None])), 0, smax)
    lm = np.clip(_nearest(smax * _safe_div(the_min, max_min[:, None])), 0, smax)
    # element pass against the DECODED scales so encode/decode round-trips
    dl = d16.astype(np.float32)[:, None] * ls
    ml = dmin16.astype(np.float32)[:, None] * lm
    q = np.clip(_nearest(_safe_div(sub + ml[:, :, None], dl[:, :, None])),
                0, nmax).astype(np.int32)
    q = np.where((dl != 0)[:, :, None], q, 0)
    return d16, dmin16, ls, lm, q


def _absmax_k_scales(sub: np.ndarray, nmax: int, super_max: int):
    """Shared symmetric sub-block scaling (make_qx_quants rmse_type=0 core):
    x ~ (d*sc)*q with q in [-nmax, nmax-1], signed sub-scales quantized
    against one fp16 super-scale d = max_scale/-super_max.
    Returns (d16, ls, q) with ls signed ints, q offset-free."""
    nb, n_sub, _ = sub.shape
    idx = np.abs(sub).argmax(axis=2)
    v = np.take_along_axis(sub, idx[:, :, None], axis=2)[:, :, 0]  # signed absmax
    scale = np.where(v != 0, v / -nmax, 0.0)               # (nb, n_sub)
    sidx = np.abs(scale).argmax(axis=1)
    w = np.take_along_axis(scale, sidx[:, None], axis=1)[:, 0]
    d16 = np.where(w != 0, w / -super_max, 0.0).astype(np.float16)
    df = d16.astype(np.float32)
    ls = np.clip(_nearest(_safe_div(scale, df[:, None])),
                 -super_max, super_max - 1)
    dl = df[:, None] * ls
    q = np.clip(_nearest(_safe_div(sub, dl[:, :, None])),
                -nmax, nmax - 1).astype(np.int32)
    q = np.where((dl != 0)[:, :, None], q, 0)
    return d16, ls, q


def _quant_q2_K(xb: np.ndarray) -> np.ndarray:
    nb = xb.shape[0]
    d16, dmin16, ls, lm, q = _minmax_k_scales(xb.reshape(nb, 16, 16), 3, 4)
    scales_b = (ls | (lm << 4)).astype(np.uint8)
    qv = q.reshape(nb, 2, 4, 32)
    qs = (qv[:, :, 0] | (qv[:, :, 1] << 2) | (qv[:, :, 2] << 4)
          | (qv[:, :, 3] << 6)).astype(np.uint8).reshape(nb, 64)
    return np.concatenate(
        [scales_b, qs, d16[:, None].view(np.uint8),
         dmin16[:, None].view(np.uint8)], axis=1)


def _quant_q3_K(xb: np.ndarray) -> np.ndarray:
    nb = xb.shape[0]
    d16, ls, q = _absmax_k_scales(xb.reshape(nb, 16, 16), 4, 32)
    L = (q + 4).reshape(nb, 256)                           # [0, 7]
    hv = ((L >> 2) & 1).reshape(nb, 8, 32).astype(np.uint8)
    hmask = np.zeros((nb, 32), np.uint8)
    for g in range(8):
        hmask |= hv[:, g] << g
    qv = (L & 3).reshape(nb, 2, 4, 32)
    qs = (qv[:, :, 0] | (qv[:, :, 1] << 2) | (qv[:, :, 2] << 4)
          | (qv[:, :, 3] << 6)).astype(np.uint8).reshape(nb, 64)
    return np.concatenate(
        [hmask, qs, _q3_scales_pack(ls + 32), d16[:, None].view(np.uint8)],
        axis=1)


def _quant_q45_K(xb: np.ndarray, nmax: int, with_qh: bool) -> np.ndarray:
    nb = xb.shape[0]
    d16, dmin16, ls, lm, q = _minmax_k_scales(xb.reshape(nb, 8, 32), nmax, 6)
    scales12 = _pack_scale_min_k4(ls, lm)
    qv = q.reshape(nb, 4, 2, 32)
    qs = ((qv[:, :, 0] & 0xF) | ((qv[:, :, 1] & 0xF) << 4)).astype(
        np.uint8).reshape(nb, 128)
    parts = [d16[:, None].view(np.uint8), dmin16[:, None].view(np.uint8),
             scales12]
    if with_qh:
        hb = ((q >> 4) & 1).reshape(nb, 4, 2, 32).astype(np.uint8)
        qh = np.zeros((nb, 32), np.uint8)
        for j in range(4):
            for n in range(2):
                qh |= hb[:, j, n] << (2 * j + n)
        parts.append(qh)
    parts.append(qs)
    return np.concatenate(parts, axis=1)


def _quant_q6_K(xb: np.ndarray) -> np.ndarray:
    nb = xb.shape[0]
    d16, ls, q = _absmax_k_scales(xb.reshape(nb, 16, 16), 32, 128)
    ls = np.clip(ls, -128, 127)
    L = (q + 32).reshape(nb, 2, 4, 32)                     # [0, 63]
    lo = L & 0xF
    hi = (L >> 4).astype(np.uint8)
    ql = np.concatenate(
        [lo[:, :, 0] | (lo[:, :, 2] << 4), lo[:, :, 1] | (lo[:, :, 3] << 4)],
        axis=2).astype(np.uint8)
    # ql layout per half: bytes 0-31 hold (e0|e64<<4), bytes 32-63 (e32|e96<<4)
    ql = np.stack([ql[:, 0], ql[:, 1]], axis=1).reshape(nb, 128)
    qh = (hi[:, :, 0] | (hi[:, :, 1] << 2) | (hi[:, :, 2] << 4)
          | (hi[:, :, 3] << 6)).reshape(nb, 64)
    return np.concatenate(
        [ql, qh, ls.astype(np.int8).view(np.uint8), d16[:, None].view(np.uint8)],
        axis=1)


_K_QUANT = {
    GGML_TYPE_Q2_K: _quant_q2_K,
    GGML_TYPE_Q3_K: _quant_q3_K,
    GGML_TYPE_Q4_K: lambda xb: _quant_q45_K(xb, 15, False),
    GGML_TYPE_Q5_K: lambda xb: _quant_q45_K(xb, 31, True),
    GGML_TYPE_Q6_K: _quant_q6_K,
}


def quantize(x: np.ndarray, ttype: int) -> bytes:
    """Encode float32 array into a ggml payload (reference codecs:
    quantize_row_* in ggml/src/ggml-quants.c — max-abs / min-max scaling
    with round-to-nearest)."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if ttype == GGML_TYPE_F32:
        return x.tobytes()
    if ttype == GGML_TYPE_F16:
        return x.astype(np.float16).tobytes()

    if ttype in K_QUANT_TYPES:
        assert x.size % QK_K == 0, f"size {x.size} not divisible by {QK_K}"
        return _K_QUANT[ttype](x.reshape(-1, QK_K)).tobytes()

    assert x.size % QK == 0, f"size {x.size} not divisible by {QK}"
    b = x.reshape(-1, QK)
    nb = b.shape[0]

    if ttype in (GGML_TYPE_Q4_0, GGML_TYPE_Q5_0, GGML_TYPE_Q8_0):
        # symmetric: d = max_abs / qmax, with sign carried by the abs-max element
        amax_idx = np.argmax(np.abs(b), axis=1)
        amax_signed = b[np.arange(nb), amax_idx]
        qmax = {GGML_TYPE_Q4_0: -8.0, GGML_TYPE_Q5_0: -16.0, GGML_TYPE_Q8_0: 127.0}[ttype]
        if ttype == GGML_TYPE_Q8_0:
            d = np.abs(amax_signed) / qmax
        else:
            d = amax_signed / qmax
        d16 = d.astype(np.float16)
        dr = d16.astype(np.float32)
        inv_d = np.where(dr != 0, 1.0 / np.where(dr == 0, 1, dr), 0.0)
        if ttype == GGML_TYPE_Q8_0:
            q = np.clip(np.round(b * inv_d[:, None]), -128, 127).astype(np.int8)
            return np.concatenate(
                [d16[:, None].view(np.uint8), q.view(np.uint8)], axis=1).tobytes()
        offset = 8 if ttype == GGML_TYPE_Q4_0 else 16
        hi = offset * 2 - 1
        q = np.clip(np.floor(b * inv_d[:, None] + (offset + 0.5)), 0, hi).astype(np.int32)
        if ttype == GGML_TYPE_Q4_0:
            return np.concatenate(
                [d16[:, None].view(np.uint8), _pack_nibbles(q)], axis=1).tobytes()
        qh = _pack_qh((q >> 4) & 1)
        return np.concatenate(
            [d16[:, None].view(np.uint8), qh[:, None].view(np.uint8),
             _pack_nibbles(q & 0x0F)], axis=1).tobytes()

    if ttype in (GGML_TYPE_Q4_1, GGML_TYPE_Q5_1):
        hi = 15 if ttype == GGML_TYPE_Q4_1 else 31
        mn = b.min(axis=1)
        mx = b.max(axis=1)
        d = (mx - mn) / hi
        d16 = d.astype(np.float16)
        m16 = mn.astype(np.float16)
        dr = d16.astype(np.float32)
        inv_d = np.where(dr != 0, 1.0 / np.where(dr == 0, 1, dr), 0.0)
        q = np.clip(np.floor((b - m16.astype(np.float32)[:, None]) * inv_d[:, None] + 0.5),
                    0, hi).astype(np.int32)
        if ttype == GGML_TYPE_Q4_1:
            return np.concatenate(
                [d16[:, None].view(np.uint8), m16[:, None].view(np.uint8),
                 _pack_nibbles(q)], axis=1).tobytes()
        qh = _pack_qh((q >> 4) & 1)
        return np.concatenate(
            [d16[:, None].view(np.uint8), m16[:, None].view(np.uint8),
             qh[:, None].view(np.uint8), _pack_nibbles(q & 0x0F)], axis=1).tobytes()

    raise ValueError(f"unsupported ggml type {ttype}")


def int8_block_size(ttype: int) -> int:
    """Sub-block granularity of the int8 repack for `ttype` (the span one
    (scale, offset) pair covers): 16 for the 16-element K-quant sub-blocks,
    32 for everything else."""
    return 16 if ttype in (GGML_TYPE_Q2_K, GGML_TYPE_Q3_K, GGML_TYPE_Q6_K) else 32


def dequantize_to_int8_blocks(raw: bytes, ttype: int, nelems: int):
    """Decode a quantized payload into (int8 q, float32 per-block scale d,
    float32 per-block offset m) without expanding to float — the repack used
    by the int8 block matmul path. Returns q:(nb,bs) int8, d:(nb,), m:(nb,)
    with bs = int8_block_size(ttype); value = q*d + m."""
    buf = np.frombuffer(raw, dtype=np.uint8)

    if ttype in K_QUANT_TYPES:
        nbk = nelems // QK_K
        blocks = buf[: nbk * type_size(ttype)].reshape(nbk, -1)
        if ttype == GGML_TYPE_Q2_K:
            scales = blocks[:, 0:16].astype(np.int32)
            q = ((blocks[:, 16:80][:, _Q2_BYTE] >> _Q2_SHIFT) & 3).astype(np.int8)
            dl = _f16col(blocks, 80) * (scales & 0xF).astype(np.float32)
            ml = _f16col(blocks, 82) * (scales >> 4).astype(np.float32)
            return (q.reshape(-1, 16), dl.reshape(-1), -ml.reshape(-1))
        if ttype == GGML_TYPE_Q3_K:
            s6 = _q3_scales_unpack(blocks[:, 96:108])
            q2 = ((blocks[:, 32:96][:, _Q2_BYTE] >> _Q2_SHIFT) & 3).astype(np.int32)
            mbit = ((blocks[:, 0:32][:, _EK % 32]
                     >> (_EK // 32).astype(np.uint8)) & 1).astype(bool)
            q = (q2 - np.where(mbit, 0, 4)).astype(np.int8)
            dl = _f16col(blocks, 108) * (s6 - 32).astype(np.float32)
            return (q.reshape(-1, 16), dl.reshape(-1),
                    np.zeros(nbk * 16, np.float32))
        if ttype == GGML_TYPE_Q4_K:
            sc8, m8 = _scale_min_k4(blocks[:, 4:16])
            q = ((blocks[:, 16:144][:, _Q4K_BYTE] >> _Q4K_SHIFT) & 0xF).astype(np.int8)
            dl = _f16col(blocks, 0) * sc8.astype(np.float32)
            ml = _f16col(blocks, 2) * m8.astype(np.float32)
            return (q.reshape(-1, 32), dl.reshape(-1), -ml.reshape(-1))
        if ttype == GGML_TYPE_Q5_K:
            sc8, m8 = _scale_min_k4(blocks[:, 4:16])
            q4 = ((blocks[:, 48:176][:, _Q4K_BYTE] >> _Q4K_SHIFT) & 0xF).astype(np.int32)
            hb = ((blocks[:, 16:48][:, _EK % 32] >> _Q5K_HBIT) & 1).astype(np.int32)
            q = (q4 + 16 * hb).astype(np.int8)
            dl = _f16col(blocks, 0) * sc8.astype(np.float32)
            ml = _f16col(blocks, 2) * m8.astype(np.float32)
            return (q.reshape(-1, 32), dl.reshape(-1), -ml.reshape(-1))
        if ttype == GGML_TYPE_Q6_K:
            sc = blocks[:, 192:208].view(np.int8).astype(np.int32)
            lo = (blocks[:, 0:128][:, _Q6_QL_BYTE] >> _Q6_QL_SHIFT) & 0xF
            hi = (blocks[:, 128:192][:, _Q6_QH_BYTE] >> _Q6_QH_SHIFT) & 3
            q = ((lo.astype(np.int32) | (hi.astype(np.int32) << 4)) - 32).astype(np.int8)
            dl = _f16col(blocks, 208) * sc.astype(np.float32)
            return (q.reshape(-1, 16), dl.reshape(-1),
                    np.zeros(nbk * 16, np.float32))

    nb = nelems // QK
    bs = type_size(ttype)
    blocks = buf[: nb * bs].reshape(nb, bs)
    if ttype == GGML_TYPE_Q4_0:
        d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32).reshape(-1)
        q = (_split_nibbles(blocks[:, 2:18]) - 8).astype(np.int8)
        return q, d, np.zeros_like(d)
    if ttype == GGML_TYPE_Q5_0:
        d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32).reshape(-1)
        qh = blocks[:, 2:6].copy().view(np.uint32).reshape(-1)
        q = ((_split_nibbles(blocks[:, 6:22]) | (_qh_bits(qh) << 4)) - 16).astype(np.int8)
        return q, d, np.zeros_like(d)
    if ttype == GGML_TYPE_Q8_0:
        d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32).reshape(-1)
        q = blocks[:, 2:34].view(np.int8).copy()
        return q, d, np.zeros_like(d)
    if ttype == GGML_TYPE_Q4_1:
        d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32).reshape(-1)
        m = blocks[:, 2:4].copy().view(np.float16).astype(np.float32).reshape(-1)
        q = _split_nibbles(blocks[:, 4:20]).astype(np.int8)
        return q, d, m
    if ttype == GGML_TYPE_Q5_1:
        d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32).reshape(-1)
        m = blocks[:, 2:4].copy().view(np.float16).astype(np.float32).reshape(-1)
        qh = blocks[:, 4:8].copy().view(np.uint32).reshape(-1)
        q = (_split_nibbles(blocks[:, 8:24]) | (_qh_bits(qh) << 4)).astype(np.int8)
        return q, d, m
    raise ValueError(f"unsupported quantized type {ttype}")
