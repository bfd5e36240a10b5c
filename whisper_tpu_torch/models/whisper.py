"""Whisper encoder/decoder in PyTorch.

Counterpart of whisper_tpu/models/whisper.py (the reference's ggml graph
builders whisper_build_graph_conv src/whisper.cpp:1994-2054, _encoder
:2056-2287, _cross :2290-2363, _decoder :2474-2851). The semantics are the
JAX package's; the idiom is PyTorch's:

- layers are a Python loop over the per-layer parameter dicts
  (checkpoint/loader.py), in place of `lax.scan` over a stacked axis;
- matmuls take the compute dtype (bfloat16 by default) and accumulate and
  return float32, then add the float32 bias and cast, as the JAX package's
  `preferred_element_type=float32` dots do; softmax and LayerNorm
  statistics are float32;
- the self-attention KV cache is updated IN PLACE (one row range per step
  and layer), which keeps one cache buffer alive instead of a copy per
  step;
- a linear layer with int8 block weights ("q", "d" [, "m"]) runs the
  quant_matmul kernels (ops/quant_matmul.py), and the int8 KV cache
  (KVCache.zeros(quant=True), cross_attention_kv(quant=True)) keeps int8
  codes with per-position float32 scales, which factor out of both
  attention products (attention_quant);
- `tp` (encoder_forward, cross_attention_kv, decoder_forward,
  KVCache.zeros) is the model-dim process group of Megatron tensor
  parallelism (parallel/mesh.py), None without it. Each rank then holds
  H / n_model whole heads of every attention (its shard of QKV, mlp_0 and
  their biases), so its caches hold those heads; the attention out
  projections and mlp_2 take the rank's share of the input features, and
  their float32 partial sums are all-reduced over the group before the
  bias is added, once. A vocab-sharded token embedding is looked up
  masked and all-reduced, and its logits are gathered to the full vocab.
  The conv stem, LayerNorms and positional embeddings are replicated.
  All-reduce hands every rank the same bits (NCCL's and gloo's alike), so
  the ranks of a group make the same decisions at every step.

Shape conventions: activations (B, T, D); KV caches (L, B, H, T, Dh);
dense linear weights [out, in]; quantized linear weights q (in, out) with
d / m (in // qblock, out).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from whisper_tpu_torch.config import WhisperHParams
from whisper_tpu_torch.ops.quant_matmul import quant_matmul
from whisper_tpu_torch.parallel.mesh import kv_scale_sharding, kv_sharding, shard_shape

Params = Dict[str, Any]


def layer_norm(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with float32 statistics and affine, cast back to x's dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), p["scale"], p["bias"], eps)
    return y.to(x.dtype)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., in) @ w[out, in]^T, float32 result. Low-precision operands
    accumulate in float32 and the float32 sum is returned unrounded (on
    CUDA through the float32-output GEMM, elsewhere by widening the
    operands, which is exact)."""
    w = w.to(x.dtype)
    if x.dtype == torch.float32:
        return F.linear(x, w)
    if x.is_cuda:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[0])
    return F.linear(x.float(), w.float())


def tp_size(tp) -> int:
    """Ranks of the model group `tp` (1 without tensor parallelism)."""
    return 1 if tp is None else dist.get_world_size(tp)


def tp_all_reduce(y: torch.Tensor, tp) -> torch.Tensor:
    """Sum y over the model group, in place; counted in
    `tp_all_reduce.calls`, its bytes in `tp_all_reduce.bytes`."""
    dist.all_reduce(y, group=tp)
    tp_all_reduce.calls += 1
    tp_all_reduce.bytes += y.numel() * y.element_size()
    return y


def tp_all_gather(y: torch.Tensor, tp, dim: int) -> torch.Tensor:
    """The group's y concatenated along `dim` in rank order; counted in
    `tp_all_gather.calls`. NCCL gathers; gloo gathers no CUDA tensor, so
    there it is an all-reduce of a zero buffer holding y in this rank's
    slot (each element sums one value and zeros, which is exact), moving
    n_model times the bytes of a gather. `tp_all_gather.bytes` counts the
    gathered buffer's."""
    n = tp_size(tp)
    if dist.get_backend(tp) == "nccl":
        buf = y.new_empty((n,) + tuple(y.shape))
        dist.all_gather_into_tensor(buf, y.contiguous(), group=tp)
    else:
        buf = y.new_zeros((n,) + tuple(y.shape))
        buf[dist.get_rank(tp)] = y
        dist.all_reduce(buf, group=tp)
    tp_all_gather.calls += 1
    tp_all_gather.bytes += buf.numel() * buf.element_size()
    return torch.cat(buf.unbind(0), dim)


tp_all_reduce.calls = tp_all_reduce.bytes = 0
tp_all_gather.calls = tp_all_gather.bytes = 0


def linear(x: torch.Tensor, p: Params, tp=None) -> torch.Tensor:
    """x @ w^T + b in x's dtype. With `tp` (an input-sharded linear under
    tensor parallelism) the float32 partial products are summed over the
    group first, and the bias is added once, after the sum."""
    if "q" in p:
        # int8 blocks resident on the device, dequantized inside the kernel;
        # the block size is in // n_blocks (32, or 16 for the K-quant
        # sub-blocks); "m" only for the offset formats
        qb = p["q"].shape[0] // p["d"].shape[0]
        y = quant_matmul(x, p["q"], p["d"], p.get("m"), qblock=qb)
    else:
        y = matmul_f32(x, p["w"])
    if tp is not None:
        y = tp_all_reduce(y, tp)
    if "b" in p:
        y = y + p["b"]
    return y.to(x.dtype)


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """(B, T, D) -> (B, H, T, Dh)"""
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, Dh) -> (B, T, D)"""
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) over equal leading dims, float32
    accumulation and result (low-precision operands: on CUDA through the
    float32-output batched GEMM, elsewhere by widening them, which is
    exact)."""
    if a.dtype == torch.float32 or not a.is_cuda or a.numel() * b.numel() == 0:
        # (an empty operand: a prompt pass at position 0 has no history)
        return torch.matmul(a.float(), b.float())
    n = a.shape[:-2].numel()
    y = torch.bmm(a.reshape(n, *a.shape[-2:]), b.reshape(n, *b.shape[-2:]),
                  out_dtype=torch.float32)
    return y.reshape(*a.shape[:-1], b.shape[-1])


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """float32 q @ k^T * Dh^-0.5."""
    return _bmm_f32(q, k.to(q.dtype).transpose(-1, -2)) * (q.shape[-1] ** -0.5)


def _weighted(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """float32 sum of v's rows weighted by p rounded to v's dtype."""
    return _bmm_f32(p.to(v.dtype), v)


def _attend(q, k, v, ks=None, vs=None, mask=None):
    """Scaled-dot-product attention with a float32 softmax, returning (out,
    probs): float32 logits q . k (times the key scales ks of an int8 K),
    masked (True = keep; fully masked rows give zeros), softmax, then the
    probabilities (times the value scales vs) rounded to q's dtype against
    v. The scales factor out of both products, so int8 codes are used as
    they are and the dequantized K/V is never built."""
    logits = _scores(q, k)
    if ks is not None:
        logits = logits * ks[:, :, None, :]
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    if mask is not None:
        # fully masked rows give NaN from softmax(-inf); zero them
        probs = torch.nan_to_num(probs, nan=0.0)
    pw = probs if vs is None else probs * vs[:, :, None, :]
    return _weighted(pw, v.to(q.dtype)).to(q.dtype), probs


def attention(
    q: torch.Tensor,            # (B, H, Tq, Dh)
    k: torch.Tensor,            # (B, H, Tk, Dh)
    v: torch.Tensor,            # (B, H, Tk, Dh)
    mask: Optional[torch.Tensor] = None,  # broadcastable to (B, H, Tq, Tk); True=keep
) -> torch.Tensor:
    """Masked scaled-dot-product attention, float32 softmax (the JAX
    package's `attention`)."""
    return _attend(q, k, v, mask=mask)[0]


def quantize_kv_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(.., T, Dh) -> int8 codes + per-(.., T) float32 max-abs scales
    (round half to even, like jnp.round)."""
    x32 = x.float()
    s = torch.clamp(x32.abs().amax(dim=-1) / 127.0, min=1e-10)
    q = torch.clamp(torch.round(x32 / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def attention_quant(
    q: torch.Tensor,            # (B, H, Tq, Dh) compute dtype
    kq: torch.Tensor,           # (B, H, Tk, Dh) int8
    ks: torch.Tensor,           # (B, H, Tk) float32
    vq: torch.Tensor,           # (B, H, Tk, Dh) int8
    vs: torch.Tensor,           # (B, H, Tk) float32
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over an int8 K/V (the JAX package's attention_quant):
    scores[.., s] = ks[s] * (q . kq[s]) and out = (probs * vs) @ vq."""
    return _attend(q, kq, vq, ks, vs, mask)[0]


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def conv_stem(params: Params, mel: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Conv1 (s=1) + GELU + Conv2 (s=2) + GELU.
    reference whisper_build_graph_conv (src/whisper.cpp:1994-2054).
    mel: (B, n_mels, 2*n_ctx) -> (B, n_ctx, D). The convolutions run on
    the compute-dtype values widened to float32 (exact products, float32
    sums, like the JAX package's preferred_element_type=float32 conv);
    GELU is the exact erf form."""
    x = mel.to(dtype)
    for name, stride in (("conv1", 1), ("conv2", 2)):
        c = params[name]
        x = F.conv1d(x.float(), c["w"].to(dtype).float(), stride=stride, padding=1)
        x = F.gelu(x + c["b"][:, None], approximate="none").to(dtype)
    return x.transpose(1, 2)


def _mlp(hp: WhisperHParams, x: torch.Tensor, blk: Params, tp=None) -> torch.Tensor:
    h = layer_norm(x, blk["mlp_ln"], hp.eps)
    h = F.gelu(linear(h, blk["mlp_0"]).float(), approximate="none").to(x.dtype)
    return x + linear(h, blk["mlp_2"], tp)


def _encoder_block(hp: WhisperHParams, x: torch.Tensor, blk: Params,
                   attn_fn=None, tp=None) -> torch.Tensor:
    """Pre-LN self-attention block (reference src/whisper.cpp:2109-2283)."""
    H = hp.n_audio_head // tp_size(tp)
    h = layer_norm(x, blk["attn_ln"], hp.eps)
    q = _split_heads(linear(h, blk["attn_q"]), H)
    k = _split_heads(linear(h, blk["attn_k"]), H)
    v = _split_heads(linear(h, blk["attn_v"]), H)
    o = attention(q, k, v) if attn_fn is None else attn_fn(q, k, v)
    x = x + linear(_merge_heads(o), blk["attn_out"], tp)
    return _mlp(hp, x, blk, tp)


def encoder_forward(
    params: Params,
    hp: WhisperHParams,
    mel: torch.Tensor,          # (B, n_mels, 2*n_audio_ctx_used)
    dtype=torch.bfloat16,
    attn_fn=None,
    tp=None,
) -> torch.Tensor:
    """Full encoder (reference whisper_build_graph_encoder,
    src/whisper.cpp:2056-2287). `attn_fn(q, k, v)` replaces the plain
    attention (api.py passes the flash-attention kernel on CUDA); `tp` is
    the model group (module docstring). Returns (B, n_ctx_used, D), the
    same on every rank of the group."""
    enc = params["encoder"]
    x = conv_stem(enc, mel, dtype)
    x = x + enc["pos_embed"][: x.shape[1]].to(dtype)
    for blk in enc["blocks"]:
        x = _encoder_block(hp, x, blk, attn_fn, tp)
    return layer_norm(x, enc["ln_post"], hp.eps)


def cross_attention_kv(
    params: Params,
    hp: WhisperHParams,
    audio_embed: torch.Tensor,  # (B, Ta, D)
    quant: bool = False,
    tp=None,
) -> Tuple[Any, Any]:
    """Cross-attention K/V of every decoder layer from the encoder output
    (reference whisper_build_graph_cross, src/whisper.cpp:2290-2363; once
    per 30 s window). Returns (L, B, H, Ta, Dh) each — or, with quant=True,
    each side as an (int8 codes, float32 (L, B, H, Ta) scales) tuple, which
    halves the cross-KV's storage. (Each step still widens the codes to
    the compute dtype before it reads them, so the read is not halved.)
    Under tensor parallelism (`tp`) H is the rank's H / n_model heads."""
    blocks = params["decoder"]["blocks"]
    B, Ta, D = audio_embed.shape
    H = hp.n_text_head // tp_size(tp)
    shape = (len(blocks), B, H, Ta, D // hp.n_text_head)
    dev = audio_embed.device
    kv = [torch.empty(shape, dtype=torch.int8 if quant else audio_embed.dtype, device=dev)
          for _ in "kv"]
    scales = [torch.empty(shape[:-1], dtype=torch.float32, device=dev) for _ in "kv"]
    for li, blk in enumerate(blocks):
        for j, name in enumerate(("cross_k", "cross_v")):
            x = _split_heads(linear(audio_embed, blk[name]), H)
            if quant:
                kv[j][li], scales[j][li] = quantize_kv_rows(x)
            else:
                kv[j][li] = x
    if quant:
        return (kv[0], scales[0]), (kv[1], scales[1])
    return kv[0], kv[1]


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def _vocab_sharded(table: torch.Tensor, hp: WhisperHParams, tp) -> bool:
    """Whether the token embedding holds this rank's share of the vocab
    rows (parallel/mesh.py replicates it where the vocab does not divide
    by n_model)."""
    return tp is not None and table.shape[0] != hp.n_vocab


def _embed(table: torch.Tensor, tokens: torch.Tensor, hp: WhisperHParams, tp) -> torch.Tensor:
    """Token embedding rows. A vocab-sharded table is looked up masked (a
    token outside this rank's rows gives zeros) and summed over the group
    in float32: one nonzero term per token, so the sum is exact."""
    if not _vocab_sharded(table, hp, tp):
        return table[tokens]
    rows = table.shape[0]
    local = tokens - dist.get_rank(tp) * rows
    inside = (local >= 0) & (local < rows)
    e = table[local.clamp(0, rows - 1)].float().masked_fill(~inside[..., None], 0.0)
    return tp_all_reduce(e, tp)


class KVCache:
    """Self-attention KV cache: (L, B, H, Tmax, Dh) tensors in the compute
    dtype, written in place by decoder_forward.

    Replaces the reference's cell/slot ring allocator (whisper_kv_cache,
    src/whisper.cpp:998-1187): decode batch entry b IS sequence b, so slot
    management reduces to a position counter; the beam fork (kv_seq_cp,
    :1121-1167) is a gather over the batch axis.

    int8 mode (`ks`/`vs` set, the JAX package's kv_dtype="int8"): k and v
    hold int8 codes, ks and vs the float32 (L, B, H, Tmax) scales (max-abs
    over Dh / 127) of each (layer, row, head, position)."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor,
                 ks: Optional[torch.Tensor] = None, vs: Optional[torch.Tensor] = None):
        self.k = k
        self.v = v
        self.ks = ks
        self.vs = vs

    @property
    def quantized(self) -> bool:
        return self.ks is not None

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        """(k, v) or, in int8 mode, (k, v, ks, vs)."""
        return (self.k, self.v) + ((self.ks, self.vs) if self.quantized else ())

    @classmethod
    def zeros(cls, hp: WhisperHParams, batch: int, dtype=torch.bfloat16,
              device="cpu", size: int = 0, quant: bool = False, tp=None) -> "KVCache":
        """An empty cache; under tensor parallelism (`tp`) of the rank's
        H / n_model heads."""
        # pad to 256 like the reference (GGML_PAD(n_text_ctx, 256),
        # src/whisper.cpp:3403-3438): prompt (≤ n_text_ctx/2 + init) plus
        # n_text_ctx/2-4 sampled tokens can exceed n_text_ctx slots
        if size <= 0:
            size = -(-hp.n_text_ctx // 256) * 256
        # `batch` is this rank's rows already; the heads split over the
        # model group as parallel/mesh.py's kv_sharding states
        full = (hp.n_text_layer, batch, hp.n_text_head, size, hp.n_text_state // hp.n_text_head)
        shape = shard_shape(full, kv_sharding(), n_model=tp_size(tp))
        if quant:
            scale = shard_shape(full[:-1], kv_scale_sharding(), n_model=tp_size(tp))
            return cls(*(torch.zeros(shape, dtype=torch.int8, device=device) for _ in "kv"),
                       *(torch.zeros(scale, dtype=torch.float32, device=device)
                         for _ in "kv"))
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))

    def broadcast(self, batch: int) -> "KVCache":
        """A batch-1 cache repeated `batch` times (a copy each decoder may
        write into), as the reference kv_seq_cp's the prompt to every
        decoder (src/whisper.cpp:7115-7154). The scales follow the codes."""
        return KVCache(*(t.expand((t.shape[0], batch) + tuple(t.shape[2:])).contiguous()
                         for t in self.tensors()))

    def reorder(self, src: torch.Tensor) -> "KVCache":
        """Beam fork in place: cache row b becomes a copy of row src[b]
        (the host loop's fork; the device loop defers it into the next
        decoder_forward, fork_src)."""
        for t in self.tensors():
            t.copy_(t.index_select(1, src))
        return self


def _cross_attention(qc: torch.Tensor, ck, cv, use_flash: bool):
    """qc (B, H, T, Dh) against cross K/V (U, H, Ta, Dh), U dividing B, or
    against an int8 cross-KV given as (codes, (U, H, Ta) scales) tuples,
    which takes the plain path and never the flash kernel (the JAX
    package's use_flash_cross, models/whisper.py:472). Returns (out,
    probs): the float32 softmax (B, H, T, Ta) from the plain path, None
    from the flash kernel (which never materialises it).

    When U < B (one encoder copy shared by G = B/U decoder rows: the beam /
    best-of fan-out), each group's rows fold into the query axis and
    contract against the single copy instead of broadcasting it B-fold;
    row u*G+g uses copy u (the JAX package's models/whisper.py:474-507)."""
    ks = vs = None
    if isinstance(ck, tuple):
        (ck, ks), (cv, vs) = ck, cv
    if use_flash and ks is None:
        from whisper_tpu_torch.ops.flash_attention import flash_attention
        def attn(q, k, v):
            return flash_attention(q, k.to(q.dtype), v.to(q.dtype)), None
    else:
        def attn(q, k, v):
            return _attend(q, k, v, ks, vs)
    B, H, T, dh = qc.shape
    U = ck.shape[0]
    if U == B:
        return attn(qc, ck, cv)
    G = B // U

    def unfold(x):          # (U, H, G*T, n) -> (B, H, T, n)
        return (x.reshape(U, H, G, T, x.shape[-1]).permute(0, 2, 1, 3, 4)
                 .reshape(B, H, T, x.shape[-1]))

    qh = (qc.reshape(U, G, H, T, dh).permute(0, 2, 1, 3, 4)
            .reshape(U, H, G * T, dh))
    oc, probs = attn(qh, ck, cv)
    return unfold(oc), None if probs is None else unfold(probs)


def _cache_rows(k_new: torch.Tensor, v_new: torch.Tensor, quant: bool):
    """A chunk's K/V rows in the cache's layout: (k, v), or with an int8
    cache (k codes, v codes, k scales, v scales)."""
    if not quant:
        return k_new, v_new
    (kq, ksc), (vq, vsc) = quantize_kv_rows(k_new), quantize_kv_rows(v_new)
    return kq, vq, ksc, vsc


def _self_attention_split(q, k_new, v_new, layer, pos0: int, causal, quant: bool):
    """The scalar-position self-attention: the history block (cache
    positions < pos0) and the causally masked chunk block under one
    softmax, the chunk's own rows unquantized; then the chunk's rows are
    written in place at [pos0, pos0+T)."""
    hist = [t[:, :, :pos0] for t in layer]
    logits_n = _scores(q, k_new).masked_fill(~causal, float("-inf"))
    logits_h = _scores(q, hist[0])
    if quant:
        logits_h = logits_h * hist[2][:, :, None, :]
    probs = torch.softmax(torch.cat([logits_h, logits_n], -1), -1)
    ph, pn = probs[..., :pos0], probs[..., pos0:]
    if quant:
        o = _weighted(ph * hist[3][:, :, None, :], hist[1].to(q.dtype))
    else:
        o = _weighted(ph, hist[1])
    o = o + _weighted(pn, v_new)
    for t, r in zip(layer, _cache_rows(k_new, v_new, quant)):
        t[:, :, pos0:pos0 + k_new.shape[2]] = r
    return o.to(q.dtype)


def _self_attention_rows(q, k_new, v_new, layer, write_row, write_pos, mask, quant: bool):
    """The per-row self-attention (the JAX package's merged path): each
    row's chunk rows written at its own positions (one index-put per cache
    tensor), then attention over the whole cache under `mask`."""
    for t, r in zip(layer, _cache_rows(k_new, v_new, quant)):
        t[write_row, :, write_pos] = r.movedim(2, 1)   # (B, H, T[, Dh]) -> rows (B, T) of t
    return _attend(q, *layer[:2], *layer[2:], mask=mask)[0]


def decoder_forward(
    params: Params,
    hp: WhisperHParams,
    tokens: torch.Tensor,       # (B, T) int64
    pos0,                       # first position of this chunk: an int (all
                                # rows) or a (B,) int64 tensor (one per row)
    kv: KVCache,
    cross_k,                    # (L, U, H, Ta, Dh); U divides B (U=1: shared);
    cross_v,                    # or (int8 codes, (L, U, H, Ta) scales) tuples
    dtype=torch.bfloat16,
    collect_cross_qk: bool = False,
    logit_rows=None,
    fork_src: Optional[torch.Tensor] = None,
    tp=None,
) -> Tuple[torch.Tensor, KVCache, Optional[torch.Tensor]]:
    """Causal decoder over a chunk of T tokens at positions [pos0, pos0+T)
    (T=1 for the sampling loop, T=n_prompt for prompt ingestion — the
    reference's batched decode, src/whisper.cpp:2474-2851 + 2864-2993).

    Query row t attends the cache history (positions < pos0) and the
    chunk's own rows 0..t; the chunk's K/V rows are then written into the
    cache IN PLACE at [pos0, pos0+T). Cache positions >= pos0 are never
    read, so rows a padded prompt wrote past its real length are harmless:
    later steps overwrite them before any query can see them.

    A (B,) `pos0` (the batched loop, decoding/batch_loop.py: each row has
    its own prompt length) takes the JAX package's merged path
    (models/whisper.py:336-377, :423-447): positions min(pos0[b] + t,
    n_text_ctx - 1); each row's T new K/V rows (with an int8 cache, their
    codes and scales) are written at its own pos0[b] by one index-put per
    cache tensor and layer; then attention runs over the whole cache under
    the mask cache_pos <= pos0[b] + t, so a padding slot above a row's
    prompt is never visible. An int scalar `pos0` keeps the split path
    below.

    `fork_src` ((B,) int64): beam fork. Before row b is read, each layer's
    cache row b becomes a copy of row fork_src[b] (the reference's
    kv_seq_cp, src/whisper.cpp:7272-7285), and the fork persists. Callers
    pass None for the identity.

    `logit_rows` (int or (B,) int64): project only that token row of each
    batch entry against the vocab, returning logits (B, 1, V) — the
    reference's last-row-only logits (src/whisper.cpp:2835).

    Multi-row chunks (T > 1) run cross-attention through the flash-
    attention kernel (ops/flash_attention.py; the plain version on CPU
    tensors); T == 1 steps, an int8 cross-KV and a collecting pass use the
    plain attention, as the JAX package does.

    `collect_cross_qk` (DTW token timestamps): cross-attention takes the
    plain path and its softmaxed probabilities come back per layer.

    With an int8 cache (kv.quantized) the history logits are q . bf16(kq)
    in float32 times the key scales, the history values (p * vs) rounded to
    the compute dtype times bf16(vq); the chunk's own rows use the
    unquantized k_new / v_new, and their int8 codes and scales are then
    written into the cache (the JAX package's split path,
    models/whisper.py:389-422).

    `tp` is the model group of tensor parallelism (module docstring): the
    caches hold the rank's heads, and the logits and cross_qk come back
    whole (all vocab rows, all heads) on every rank of the group.

    Returns (logits[B, T|1, n_vocab] float32, kv, cross_qk): cross_qk is
    the float32 (L, B, H, T, Ta) probabilities with collect_cross_qk, else
    None."""
    per_row = isinstance(pos0, torch.Tensor) and pos0.ndim == 1
    if isinstance(pos0, torch.Tensor) and not per_row:
        pos0 = int(pos0)
    dec = params["decoder"]
    B, T = tokens.shape
    H = hp.n_text_head // tp_size(tp)
    dev = tokens.device

    if per_row:
        # write index (row, position) of each of the chunk's rows, and the
        # mask query t of row b: cache_pos <= pos0[b] + t
        write_pos = pos0.to(dev, torch.long)[:, None] + torch.arange(T, device=dev)
        write_row = torch.arange(B, device=dev)[:, None].expand(B, T)
        positions = torch.clamp(write_pos, max=hp.n_text_ctx - 1)       # (B, T)
        cache_pos = torch.arange(kv.k.shape[3], device=dev)
        mask = (cache_pos[None, None, :] <= write_pos[:, :, None])[:, None]  # (B,1,T,Tmax)
    else:
        positions = torch.clamp(pos0 + torch.arange(T, device=dev),
                                max=hp.n_text_ctx - 1)
        causal = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
    x = _embed(dec["token_embed"], tokens, hp, tp).to(dtype) \
        + dec["pos_embed"][positions].to(dtype)
    quant = kv.quantized
    cross_q8 = isinstance(cross_k, tuple)
    cross_qk = []

    for li, blk in enumerate(dec["blocks"]):
        layer = [t[li] for t in kv.tensors()]             # (B, H, Tmax[, Dh]) views
        if fork_src is not None:
            for t in layer:
                t.copy_(t.index_select(0, fork_src))

        # --- self-attention: per-row (merged) or split path
        h = layer_norm(x, blk["attn_ln"], hp.eps)
        q = _split_heads(linear(h, blk["attn_q"]), H)
        k_new = _split_heads(linear(h, blk["attn_k"]), H)
        v_new = _split_heads(linear(h, blk["attn_v"]), H)
        if per_row:
            o = _self_attention_rows(q, k_new, v_new, layer, write_row, write_pos, mask, quant)
        else:
            o = _self_attention_split(q, k_new, v_new, layer, pos0, causal, quant)
        x = x + linear(_merge_heads(o), blk["attn_out"], tp)

        # --- cross-attention against the precomputed encoder K/V
        h = layer_norm(x, blk["cross_ln"], hp.eps)
        qc = _split_heads(linear(h, blk["cross_q"]), H)
        if cross_q8:
            ck = (cross_k[0][li], cross_k[1][li])
            cv = (cross_v[0][li], cross_v[1][li])
        else:
            ck, cv = cross_k[li], cross_v[li]
        oc, probs = _cross_attention(qc, ck, cv, use_flash=T > 1 and not collect_cross_qk)
        if collect_cross_qk:
            cross_qk.append(probs if tp is None else tp_all_gather(probs, tp, 1))
        x = x + linear(_merge_heads(oc), blk["cross_out"], tp)

        x = _mlp(hp, x, blk, tp)

    x = layer_norm(x, dec["ln"], hp.eps)
    if logit_rows is not None:
        # slice BEFORE the vocab projection (reference src/whisper.cpp:2835)
        lr = torch.as_tensor(logit_rows, dtype=torch.long, device=dev).expand(B)
        x = x[torch.arange(B, device=dev), lr][:, None]
    logits = matmul_f32(x, dec["token_embed"])
    if _vocab_sharded(dec["token_embed"], hp, tp):
        logits = tp_all_gather(logits, tp, -1)
    return logits, kv, torch.stack(cross_qk) if collect_cross_qk else None
