"""The evidence programs: the serving path's programs at a preset's width,
built from shapes alone.

Counterpart of whisper_tpu/tools/programs.py, "the single source of those
lowerings so bench.py, tools/hbm_audit.py and tools/tp_evidence.py cannot
drift". The JAX package lowers each program from abstract shapes and reads
XLA's memory analysis; the port has no compiler to ask, so a program here
is the serving code itself, run once on a device:

- `lv3_abstract(preset)` gives the parameter tree as shapes and dtypes
  (tensors on torch.device("meta"), no weights), in the compute dtype and
  in the int8-block (q5-class) layout of checkpoint/quant.py's
  abstract_int8_block_shapes;
- `encoder`, `decode_window`, `batch_decode` and `speculative` build a
  `Program` over models/whisper.py's encoder_forward / cross_attention_kv,
  decoding/device_loop.py's decode_window, decoding/batch_loop.py's
  decode_windows_batch and decoding/speculative.py's
  decode_window_speculative, with the arguments the serving path gives
  them (the encoder's self-attention through the flash-attention kernel on
  the card, as api.py's encode);
- `Program.args(device, seed)` makes random weights and inputs from a seed
  on that device (`materialize`), and `Program.run(args)` runs the program
  once. Decoding is capped at `n_steps` tokens (no timestamps, end of text
  suppressed, max_tokens = n_steps): the caches are allocated before the
  first step, so a capped run reaches the program's peak;
- `memory_summary(program, device)` gives the JAX keys: arguments, the
  memory the run takes above them, the outputs, and the peak.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from whisper_tpu_torch.checkpoint.init import sinusoid_position_embedding
from whisper_tpu_torch.checkpoint.quant import abstract_int8_block_shapes
from whisper_tpu_torch.config import (PRESET_HPARAMS, FullParams, SamplingStrategy,
                                      WhisperHParams)
from whisper_tpu_torch.decoding import filters
from whisper_tpu_torch.tokenizer import synthetic_vocab

N_STEPS = 4     # decode steps of a capped run


class LV3Abstract(NamedTuple):
    hp: WhisperHParams
    vocab: Any
    abs_params: Dict[str, Any]   # compute-dtype weights, meta tensors
    q_params: Dict[str, Any]     # int8-block (q5-class) layout, meta tensors
    prompt_max: int              # the largest prompt bucket (decoding/loop.py)


def param_shapes(hp: WhisperHParams, dtype=torch.bfloat16) -> Dict[str, Any]:
    """checkpoint/init.random_params' tree as meta tensors: linear weights
    [out, in] and embeddings in `dtype`, convolutions (out, in, k) in
    `dtype`, LayerNorms and biases float32."""
    def t(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")

    def linear(n_in, n_out, bias=True):
        return {"w": t(n_out, n_in), **({"b": t(n_out, dt=torch.float32)} if bias else {})}

    def ln(n):
        return {"scale": t(n, dt=torch.float32), "bias": t(n, dt=torch.float32)}

    def block(d, cross):
        blk = {"attn_ln": ln(d), "attn_q": linear(d, d), "attn_k": linear(d, d, bias=False),
               "attn_v": linear(d, d), "attn_out": linear(d, d)}
        if cross:
            blk.update({"cross_ln": ln(d), "cross_q": linear(d, d),
                        "cross_k": linear(d, d, bias=False), "cross_v": linear(d, d),
                        "cross_out": linear(d, d)})
        blk.update({"mlp_ln": ln(d), "mlp_0": linear(d, 4 * d), "mlp_2": linear(4 * d, d)})
        return blk

    d_a, d_t = hp.n_audio_state, hp.n_text_state
    conv_b = t(d_a, dt=torch.float32)
    return {
        "encoder": {
            "pos_embed": t(hp.n_audio_ctx, d_a),
            "conv1": {"w": t(d_a, hp.n_mels, 3), "b": conv_b},
            "conv2": {"w": t(d_a, d_a, 3), "b": conv_b},
            "ln_post": ln(d_a),
            "blocks": [block(d_a, False) for _ in range(hp.n_audio_layer)],
        },
        "decoder": {
            "pos_embed": t(hp.n_text_ctx, d_t),
            "token_embed": t(hp.n_vocab, d_t),
            "ln": ln(d_t),
            "blocks": [block(d_t, True) for _ in range(hp.n_text_layer)],
        },
    }


def lv3_abstract(preset: str = "large-v3", beam: bool = True,
                 hp: Optional[WhisperHParams] = None, dtype=torch.bfloat16) -> LV3Abstract:
    """The preset's (or `hp`'s) parameter tree as shapes, in the compute
    `dtype` and int8-block. `beam` is the JAX signature's (it picks the
    filter constants there); the port builds its constants per program."""
    del beam
    hp = hp or PRESET_HPARAMS[preset]
    abs_params = param_shapes(hp, dtype)
    return LV3Abstract(hp, synthetic_vocab(hp.n_vocab), abs_params,
                       abstract_int8_block_shapes(abs_params), hp.n_text_ctx // 2 + 8)


def materialize(tree, device, seed: int = 0):
    """Random weights of a shape tree on `device`, from `seed`: linear and
    conv weights normal / sqrt(fan-in), the token embedding normal /
    sqrt(width), decoder positions normal x 0.01, encoder positions the
    sinusoids, LayerNorm scales 1, biases 0; int8 blocks uniform codes in
    [-16, 15] (Q5_0's range) with scales that give the weight a standard
    deviation of about 1 / sqrt(fan-in). The same seed gives the same
    weights on the same kind of device."""
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, scale, dtype):
        x = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
        return (x * scale).to(dtype)

    def leaf(t, key, parent):
        if key == "q":
            return torch.randint(-16, 16, t.shape, generator=g, device=device, dtype=torch.int8)
        if key == "d":
            u = torch.rand(t.shape, generator=g, device=device)
            return ((0.5 + u) * (parent["q"].shape[0] ** -0.5 / 9.2)).to(t.dtype)
        if key in ("b", "bias"):
            return torch.zeros(t.shape, dtype=t.dtype, device=device)
        if key == "scale":
            return torch.ones(t.shape, dtype=t.dtype, device=device)
        if key == "token_embed":
            return normal(t.shape, t.shape[1] ** -0.5, t.dtype)
        if key == "w":     # [out, in] or a conv's (out, in, k)
            return normal(t.shape, t.shape[1] ** -0.5, t.dtype)
        if key == "pos_embed" and "conv1" in parent:
            pos = torch.from_numpy(sinusoid_position_embedding(*t.shape))
            return pos.to(device, t.dtype)
        if key == "pos_embed":
            return normal(t.shape, 0.01, t.dtype)
        raise ValueError(f"no random rule for leaf {key!r}")

    def walk(node, key, parent):
        if isinstance(node, dict):
            return {k: walk(v, k, node) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, key, parent) for v in node]
        return leaf(node, key, parent)

    return walk(tree, "", None)


def tree_bytes(tree) -> int:
    """Bytes of the tensors and arrays in a tree (dicts, lists, tuples,
    NamedTuples)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return tree.nbytes
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def capped_params(strategy: SamplingStrategy, n_steps: int) -> FullParams:
    """The decode options of a capped run: no timestamps, end of text
    suppressed, max_tokens = n_steps, so every window decodes exactly
    n_steps + 1 tokens in n_steps decoder steps after the prompt pass."""
    p = FullParams.default(strategy)
    p.no_timestamps = True
    p.suppress_regex = r"\[_EOT_\]"
    p.max_tokens = n_steps
    return p


def prompt_tokens(a: LV3Abstract, n_utt: Optional[int] = None):
    """The start-of-transcript prompt (sot, en, transcribe) right-padded
    to the largest bucket, as the JAX programs are lowered: (prompt_max,),
    or (n_utt, prompt_max); and its length."""
    v = a.vocab
    row = np.zeros(a.prompt_max, np.int64)
    row[:3] = (v.token_sot, v.token_lang(0), v.token_transcribe)
    return (row if n_utt is None else np.tile(row, (n_utt, 1))), 3


def cross_kv(hp: WhisperHParams, n_utt: int, device, g: torch.Generator,
             quant: bool = False, dtype=torch.bfloat16, n_layer: Optional[int] = None):
    """Random cross-attention K and V of n_utt utterances, (L, U, H, Ta, Dh)
    each, or (int8 codes, (L, U, H, Ta) float32 scales) tuples; the
    decoders' argument, made without running the encoder."""
    H = hp.n_text_head
    shape = (n_layer or hp.n_text_layer, n_utt, H, hp.n_audio_ctx, hp.n_text_state // H)

    def side():
        if quant:
            q = torch.randint(-127, 128, shape, generator=g, device=device, dtype=torch.int8)
            return q, torch.rand(shape[:-1], generator=g, device=device) / 127.0
        return torch.randn(shape, generator=g, device=device).to(dtype)

    return side(), side()


@dataclasses.dataclass
class Program:
    """One serving program: its weights as shape trees by argument name
    ("params", and "params_draft" for speculation), `make_inputs(device,
    generator)` its other arguments, `body(**args)` runs it; an argument
    `tp` (the model group, models/whisper.py) runs it tensor-parallel on
    a rank's shard (tools/tp_evidence.py)."""

    name: str
    hp: WhisperHParams
    weights: Dict[str, Any]
    make_inputs: Callable[..., Dict[str, Any]]
    body: Callable[..., Any]

    def inputs(self, device, seed: int = 0) -> Dict[str, Any]:
        """The arguments but the weights, random from `seed`."""
        device = torch.device(device)
        return self.make_inputs(device, torch.Generator(device=device).manual_seed(seed + 1))

    def args(self, device, seed: int = 0) -> Dict[str, Any]:
        """Every argument: random weights (`materialize`) and inputs."""
        weights = {k: materialize(tree, device, seed + 2 * i)
                   for i, (k, tree) in enumerate(self.weights.items())}
        return {**weights, **self.inputs(device, seed)}

    def run(self, args: Dict[str, Any]):
        return self.body(**args)


def _flash(device):
    """The encoder's self-attention as api.py runs it: the kernel on the
    card, the plain attention elsewhere."""
    if device.type != "cuda":
        return None
    from whisper_tpu_torch.ops.flash_attention import flash_attention
    return flash_attention


def filter_consts(a: LV3Abstract, strategy: SamplingStrategy, n_steps: int, device):
    """The filter constants and token ids of a capped run, on `device`."""
    return filters.build_filter_consts(a.vocab, a.hp, capped_params(strategy, n_steps), device)


def encoder(a: LV3Abstract, batch: int = 1, dtype=torch.bfloat16) -> Program:
    """The encode of `batch` 30 s windows: encoder_forward, then
    cross_attention_kv, as WhisperState.encode runs them (the JAX program
    lowers the encoder alone). Returns (embed, cross_k, cross_v)."""
    from whisper_tpu_torch.models import whisper as model_mod
    hp = a.hp

    def make_inputs(device, g):
        return {"mel": torch.randn((batch, hp.n_mels, 2 * hp.n_audio_ctx), generator=g,
                                   device=device)}

    def body(params, mel, tp=None):
        embed = model_mod.encoder_forward(params, hp, mel, dtype, _flash(mel.device), tp=tp)
        return (embed,) + tuple(model_mod.cross_attention_kv(params, hp, embed, tp=tp))

    return Program(f"encoder_b{batch}", hp, {"params": a.abs_params}, make_inputs, body)


def decode_window(a: LV3Abstract, quantized: bool = False, beam_size: int = 5,
                  n_steps: int = N_STEPS, dtype=torch.bfloat16) -> Program:
    """The single-utterance window decode (decoding/device_loop.py):
    beam search with `beam_size` decoders (greedy at beam_size 1), bf16
    or int8-block weights, the bf16 cross-KV of one utterance."""
    from whisper_tpu_torch.decoding import device_loop
    hp = a.hp
    strategy = SamplingStrategy.BEAM_SEARCH if beam_size > 1 else SamplingStrategy.GREEDY
    prompt, prompt_len = prompt_tokens(a)

    def make_inputs(device, g):
        consts, tids = filter_consts(a, strategy, n_steps, device)
        ck, cv = cross_kv(hp, 1, device, g, dtype=dtype)
        return {"consts": consts, "tids": tids, "cross_k": ck, "cross_v": cv, "prompt": prompt}

    def body(params, consts, tids, cross_k, cross_v, prompt, tp=None):
        return device_loop.decode_window(
            params, hp, consts, cross_k, cross_v, prompt, prompt_len, 0.0, 0,
            2 * hp.n_audio_ctx, tids=tids, n_dec=beam_size,
            strategy=device_loop.BEAM if beam_size > 1 else device_loop.GREEDY_BEST,
            beam_size=beam_size, max_tokens=n_steps, no_timestamps=True, dtype=dtype, tp=tp)

    name = f"decode_window_{'beam%d' % beam_size if beam_size > 1 else 'greedy'}_" \
           f"{'q5' if quantized else 'bf16'}"
    return Program(name, hp, {"params": a.q_params if quantized else a.abs_params},
                   make_inputs, body)


def batch_decode(a: LV3Abstract, n_utt: int, weights: str = "bf16", kv_quant: bool = False,
                 n_per_utt: int = 5, n_steps: int = N_STEPS,
                 dtype=torch.bfloat16) -> Program:
    """The serving program: the batched window decode of n_utt utterances
    (decoding/batch_loop.py), n_per_utt rows each (beam search, greedy at
    1), bf16 or "q5" weights, the bf16 or int8 self- and cross-KV."""
    from whisper_tpu_torch.decoding import batch_loop, device_loop
    hp = a.hp
    strategy = SamplingStrategy.BEAM_SEARCH if n_per_utt > 1 else SamplingStrategy.GREEDY
    prompts, prompt_len = prompt_tokens(a, n_utt)

    def make_inputs(device, g):
        consts, tids = filter_consts(a, strategy, n_steps, device)
        ck, cv = cross_kv(hp, n_utt, device, g, quant=kv_quant, dtype=dtype)
        return {"consts": consts, "tids": tids, "cross_k": ck, "cross_v": cv,
                "prompts": prompts}

    def body(params, consts, tids, cross_k, cross_v, prompts, tp=None):
        return batch_loop.decode_windows_batch(
            params, hp, consts, cross_k, cross_v, prompts, np.full(n_utt, prompt_len), 0.0,
            np.zeros(n_utt, np.int32), np.full(n_utt, 2 * hp.n_audio_ctx, np.int32),
            np.ones(n_utt, bool), tids=tids, n_utt=n_utt, n_per_utt=n_per_utt,
            strategy=device_loop.BEAM if n_per_utt > 1 else device_loop.GREEDY_BEST,
            max_tokens=n_steps, no_timestamps=True, dtype=dtype, kv_quant=kv_quant, tp=tp)

    return Program(f"batch_decode_u{n_utt}_k{n_per_utt}_{weights}"
                   f"{'_kv8' if kv_quant else ''}", hp,
                   {"params": a.q_params if weights == "q5" else a.abs_params},
                   make_inputs, body)


def draft_hparams(hp: WhisperHParams, draft_layers: int = 2) -> WhisperHParams:
    """A distil-shaped draft: the main model's widths and vocab,
    `draft_layers` decoder layers."""
    return dataclasses.replace(hp, n_text_layer=draft_layers)


def speculative(a: LV3Abstract, k_spec: int = 8, draft_layers: int = 2,
                n_steps: int = N_STEPS, dtype=torch.bfloat16) -> Program:
    """Speculative greedy (decoding/speculative.py): the main model and a
    distil-shaped draft of `draft_layers` decoder layers that shares the
    main model's encoder (ContextParams.draft_shares_encoder), so the
    draft holds its decoder only; bf16 cross-KV for both. With n_steps <
    k_spec the window is one round when every proposal is accepted."""
    from whisper_tpu_torch.decoding.speculative import decode_window_speculative
    hp = a.hp
    hp_d = draft_hparams(hp, draft_layers)
    d_shapes = {"decoder": param_shapes(hp_d, dtype)["decoder"]}
    prompt, prompt_len = prompt_tokens(a)

    def make_inputs(device, g):
        consts, tids = filter_consts(a, SamplingStrategy.GREEDY, n_steps, device)
        ck, cv = cross_kv(hp, 1, device, g, dtype=dtype)
        dck, dcv = cross_kv(hp, 1, device, g, dtype=dtype, n_layer=draft_layers)
        return {"consts": consts, "tids": tids, "cross_k": ck, "cross_v": cv,
                "draft_ck": dck, "draft_cv": dcv, "prompt": prompt}

    def body(params, params_draft, consts, tids, cross_k, cross_v, draft_ck, draft_cv,
             prompt, tp=None):
        return decode_window_speculative(
            params, params_draft, hp, hp_d, consts, cross_k, cross_v, draft_ck, draft_cv,
            prompt, prompt_len, 0, 2 * hp.n_audio_ctx, tids=tids, k_spec=k_spec,
            max_tokens=n_steps, no_timestamps=True, dtype=dtype, tp=tp)

    return Program(f"speculative_k{k_spec}_draft{draft_layers}", hp,
                   {"params": a.abs_params, "params_draft": d_shapes}, make_inputs, body)


def memory_summary(program: Program, device, seed: int = 0) -> dict:
    """The JAX keys for one run of `program` on `device`: args_gb, the
    bytes of its weights and inputs; out_mb, of what it returns; on the
    card temp_gb, the most allocated above the arguments during the run
    (outputs included), and hbm_peak_gb, the most allocated from before
    the arguments were made (torch.cuda.max_memory_allocated after
    reset_peak_memory_stats, so allocations made earlier in the process
    do not count). On the CPU temp_gb and hbm_peak_gb are None: nothing
    there measures them."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        start = torch.cuda.memory_allocated(device)
    args = program.args(device, seed)
    args_b = tree_bytes(args)
    if cuda:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    out = program.run(args)
    out_b = tree_bytes(out)
    res = {"program": program.name, "device": str(device), "args_gb": args_b / 2 ** 30,
           "temp_gb": None, "out_mb": out_b / 2 ** 20, "hbm_peak_gb": None}
    if cuda:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
        res["temp_gb"] = (peak - base) / 2 ** 30
        res["hbm_peak_gb"] = (peak - start) / 2 ** 30
    return res
