"""What one decode step moves through device memory, counted and modelled.

Counterpart of whisper_tpu/tools/hbm_audit.py. The JAX package reads the
bytes of the compiled program's loop bodies out of its optimized HLO and
reconciles them with the analytic per-token model of bench.py. The port
compiles no program, so it gives the same answer two ways:

- `analytic(hp, weights, kv, rows)`: the bytes a decode step must move
  and the FLOPs of an encode, from the shapes alone (bench.py's formulas:
  the per-token weights 14·L·d² + V·d, the cross-KV 2·L·T·d, the self-KV
  2·L·SK_T·d, beam rows sharing the weights and the cross-KV; int8 blocks
  at 1 + 4/32 bytes a weight, an int8 KV at 1 + 4/Dh bytes an element),
  and the least time for them on an H100 SXM (3.35 TB/s, 989 TFLOP/s
  dense bf16). What implements the step does not change them, so a
  benchmark can divide by them;
- `audit_step(fn)`: a tally of what a run of `fn` moves. Every aten op
  runs under a TorchDispatchMode, which counts the bytes of the op's
  distinct input and output storages, each tensor at its viewed size
  (broadcast dims once). Three rules follow what the op really touches: a
  view moves nothing; a gather (index, index_select, embedding, gather)
  reads from its source the bytes it returns; an indexed write (index_put,
  scatter) writes into its destination the bytes of its values. The
  hand-written kernels launch through ctypes, which the dispatcher never
  sees, so their wrappers report their operands' bytes
  (ops/flash_attention.py's and ops/quant_matmul.py's `tally`). Bytes are
  grouped by class: B1, B2, B3, matmul, copy (copies, casts, gathers,
  scatters), elementwise (pointwise ops and reductions), other;
- `audit_decode_step(...)`: a capped window decode
  (tools/programs.py) tallied op by op, split at the decoder layers'
  entry and exit, which a marked list of decoder blocks reports as
  decoder_forward walks it. One step is the span from a decoder call's
  first layer to the next call's: token_body is what lies outside the
  layers (the logits, the filters and the choice of the token, the next
  token's embedding), layer_body one layer;
  per_token_gb = token_body + n_layers × layer_body, beside the analytic
  bytes. The step's ms comes from a separate run with the tally off (CUDA
  events at each call's first layer: nothing is cloned or synchronised
  inside the timed steps).

On the card the attention and the int8-block linears are the kernels. On
the CPU they run as their plain versions, which materialise float32
scores and dequantized weights, so a CPU tally is not the card's: every
result names its device.

    python -m whisper_tpu_torch.tools.hbm_audit [--preset P] [--q5] [--kv8]
        [--batch U] [--cpu]

audits the beam-5 window (or, with --batch, U utterances x 5 rows; --kv8
needs --batch) on the card and prints JSON; --cpu tallies on the CPU.
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from whisper_tpu_torch.config import WhisperHParams
from whisper_tpu_torch.ops.flash_attention import flash_attention
from whisper_tpu_torch.ops.quant_matmul import quant_matmul

H100_HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
H100_BF16_FLOPS = 989e12          # H100 SXM dense bf16 tensor-core rate
QBLOCK = 32                       # int8-block (q5-class) weights: one f32 scale per 32

CLASSES = ("B1", "B2", "B3", "matmul", "copy", "elementwise", "other")
_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul", "linear", "mv", "dot",
           "addmv"}
_GATHER = {"index", "index_select", "embedding", "gather", "_unsafe_index"}
_SCATTER = {"index_put", "index_put_", "_index_put_impl_", "scatter", "scatter_",
            "index_copy", "index_copy_", "scatter_add", "scatter_add_"}
_COPY = _GATHER | _SCATTER | {"copy_", "_to_copy", "clone", "cat", "stack", "repeat",
                              "repeat_interleave", "expand_copy", "constant_pad_nd",
                              "_copy_from", "_copy_from_and_resize", "flip", "roll"}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "cumsum",
           "cumprod", "prod", "any", "all", "_softmax", "_log_softmax", "softmax",
           "log_softmax", "native_layer_norm", "logsumexp", "var_mean", "norm"}
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "_local_scalar_dense", "set_", "resize_", "lift_fresh", "detach", "alias"}


def analytic(hp: WhisperHParams, weights: str = "bf16", kv: str = "bf16", rows: int = 1,
             n_utt: int = 1) -> dict:
    """The bytes one decode step of `rows` decoder rows over `n_utt`
    utterances' cross-KV must move (each weight and KV element read once),
    and the FLOPs of one encode (bench.py analytic_roofline's formulas;
    its `dec_gb_per_tok` is rows = 1, its `bch5_step_gb` rows = 5), in
    bf16 or int8-block ("q5") weights and a bf16 or "int8" KV; with the
    least time for each on an H100 SXM."""
    d, Le, Ld = hp.n_text_state, hp.n_audio_layer, hp.n_text_layer
    T, V = hp.n_audio_ctx, hp.n_vocab
    sk_t = -(-hp.n_text_ctx // 256) * 256       # the padded self-KV (KVCache.zeros)
    dh = d // hp.n_text_head
    w_elt = 2 if weights == "bf16" else 1 + 4 / QBLOCK
    kv_elt = 2 if kv == "bf16" else 1 + 4 / dh
    # per token: self-attention QKV + out (4 d²), cross Q + out (2 d²), the
    # MLP (8 d²); cross K / V are projected once a window; the token
    # embedding (bf16 in every layout) is the logits' weight
    w_b = 14 * Ld * d * d * w_elt + V * d * 2
    ck_b = n_utt * 2 * Ld * T * d * kv_elt
    sk_b = rows * 2 * Ld * sk_t * d * kv_elt
    step_b = w_b + ck_b + sk_b
    d_a = hp.n_audio_state
    enc_flops = Le * (24 * T * d_a * d_a + 4 * T * T * d_a)
    return {"weights": weights, "kv": kv, "rows": rows, "n_utt": n_utt,
            "weights_gb": w_b / 1e9, "cross_kv_gb": ck_b / 1e9, "self_kv_gb": sk_b / 1e9,
            "step_gb": step_b / 1e9, "step_bound_ms": step_b / H100_HBM_BYTES_PER_S * 1e3,
            "enc_gflops": enc_flops / 1e9,
            "enc_bound_ms": enc_flops / H100_BF16_FLOPS * 1e3}


def _op_class(func) -> str:
    name = func.__name__.split(".")[0]
    if name in _MATMUL:
        return "matmul"
    if name in _COPY:
        return "copy"
    if name in _REDUCE or torch.Tag.pointwise in func.tags:
        return "elementwise"
    return "other"


def _viewed_bytes(t: torch.Tensor) -> int:
    """A tensor's bytes at its viewed size, a broadcast (stride 0) dim
    counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size() if t.numel() else 0


class Tally(TorchDispatchMode):
    """Bytes by (section, class) of every aten op run under it, and of the
    kernels' launches (their wrappers' `tally` hook, set while it is
    entered). `section` is whatever the caller sets it to between ops
    (audit_decode_step: the decoder call and layer)."""

    def __init__(self):
        super().__init__()
        self.section = None
        self.bytes: Dict[tuple, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
        self.ops: Dict[tuple, int] = defaultdict(int)

    def kernel(self, cls: str, n: int) -> None:
        self.bytes[self.section][cls] += n
        self.ops[self.section] += 1

    def __enter__(self):
        flash_attention.tally = quant_matmul.tally = self.kernel
        return super().__enter__()

    def __exit__(self, *exc):
        flash_attention.tally = quant_matmul.tally = None
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        name = func.__name__.split(".")[0]
        if name in _FREE:
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        sizes: Dict[int, int] = {}

        def add(t, n=None):
            key = t.untyped_storage().data_ptr()
            sizes[key] = max(sizes.get(key, 0), _viewed_bytes(t) if n is None else n)

        if name in _GATHER and ins:
            # the source is read where the op gathers: the bytes it returns
            # (plus the indices)
            got = sum(_viewed_bytes(t) for t in outs)
            add(ins[0], got)
            for t in ins[1:]:
                add(t)
            for t in outs:
                add(t)
        elif name in _SCATTER and ins:
            # the destination is written where the op scatters: the bytes of
            # its values (the last tensor argument), read once
            vals = _viewed_bytes(ins[-1])
            dst = ins[0].untyped_storage().data_ptr()
            for t in ins[1:]:
                add(t)
            sizes[dst] = sizes.get(dst, 0) + vals
        else:
            for t in ins + outs:
                add(t)
        self.bytes[self.section][_op_class(func)] += sum(sizes.values())
        self.ops[self.section] += 1
        return out


def _by_class(sections) -> Dict[str, int]:
    """Bytes by class summed over sections ({class: bytes} each)."""
    by: Dict[str, int] = defaultdict(int)
    for per in sections:
        for cls, n in per.items():
            by[cls] += n
    return {c: by[c] for c in CLASSES if by[c]}


def launch_counts() -> Dict[str, int]:
    """The kernels' launch counters by class (B1, B2, B3)."""
    return {"B1": flash_attention.launches, "B2": quant_matmul.launches,
            "B3": quant_matmul.launches_offset}


def audit_step(fn: Callable[[], object]) -> dict:
    """Run `fn()` once under a Tally and return its bytes by class (GB),
    its total and its op count (kernel launches included)."""
    tally = Tally()
    with tally:
        fn()
    by = _by_class(tally.bytes.values())
    return {"gb": sum(by.values()) / 1e9, "by_class_gb": {c: n / 1e9 for c, n in by.items()},
            "ops": sum(tally.ops.values())}


class LayerMarks:
    """Marks a decoder's layers: `blocks(params)` returns the params with
    the decoder's blocks in a list that reports each decoder_forward call
    (the walk's start) and each layer's entry and exit as the call walks
    it. `calls` counts the calls; `section` is (call, layer), layer None
    outside the layers; with `events`, a CUDA event is recorded at each
    call's first layer."""

    def __init__(self, tally: Optional[Tally] = None, events: bool = False):
        self.tally = tally
        self.calls = 0
        self.events = [] if events else None

    def _at(self, layer) -> None:
        if self.tally is not None:
            self.tally.section = (self.calls - 1, layer)

    def blocks(self, params: dict) -> dict:
        marks = self

        class Marked(list):
            def __iter__(self):
                marks.calls += 1
                if marks.events is not None:
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    marks.events.append(ev)
                for li, blk in enumerate(list.__iter__(self)):
                    marks._at(li)
                    yield blk
                marks._at(None)

        dec = dict(params["decoder"], blocks=Marked(params["decoder"]["blocks"]))
        return dict(params, decoder=dec)


def _program(a, rows: int, weights: str, kv: str, n_utt: int, n_steps: int):
    from whisper_tpu_torch.tools import programs
    if n_utt:
        return programs.batch_decode(a, n_utt, weights=weights, kv_quant=kv == "int8",
                                     n_per_utt=rows, n_steps=n_steps)
    if kv == "int8":
        raise ValueError("the single-utterance window takes the bf16 cross-KV "
                         "(the JAX program's); an int8 KV needs --batch")
    return programs.decode_window(a, quantized=weights == "q5", beam_size=rows,
                                  n_steps=n_steps)


def audit_decode_step(preset: str = "large-v3", weights: str = "bf16", kv: str = "bf16",
                      beam: int = 1, n_utt: int = 0, device="cuda", seed: int = 0,
                      n_steps: int = 4, hp: Optional[WhisperHParams] = None) -> dict:
    """The tally of one steady decode step of a capped window (module
    docstring) with the JAX keys: token_body, layer_body (the first
    layer's), n_layers, per_token_gb; beside them the step's total (the
    sum over its span, to hold the split to), every layer's bytes, the
    analytic bytes and the ratio, the bytes by class, the kernel
    launches and, on the card, the step's ms (mean over the steady steps
    of the untallied run) and the GB/s it implies. `n_utt` > 0 takes the
    batched program (decoding/batch_loop.py) of n_utt utterances × `beam`
    rows, else the single window (decoding/device_loop.py) of `beam`
    decoders (greedy at 1). n_steps >= 3 (two whole steps)."""
    from whisper_tpu_torch.tools import programs

    if n_steps < 3:
        raise ValueError("n_steps >= 3: a step is measured between two later decoder calls")
    device = torch.device(device)
    a = programs.lv3_abstract(preset, hp=hp)
    hp = a.hp
    prog = _program(a, beam, weights, kv, n_utt, n_steps)
    args = prog.args(device, seed)
    cuda = device.type == "cuda"

    # the timed run: the tally off, a CUDA event at each call's first layer
    marks = LayerMarks(events=cuda)
    prog.run(dict(args, params=marks.blocks(args["params"])))
    step_ms = None
    if cuda:
        torch.cuda.synchronize(device)
        ev = marks.events
        spans = [ev[c].elapsed_time(ev[c + 1]) for c in range(1, len(ev) - 1)]
        step_ms = sum(spans) / len(spans)

    # the tallied run: the same inputs, the step from call 1's first layer
    # to call 2's
    tally = Tally()
    marks = LayerMarks(tally)
    before = launch_counts()
    with tally:
        prog.run(dict(args, params=marks.blocks(args["params"])))
    launches = {k: n - before[k] for k, n in launch_counts().items()}
    step = 1
    n_layers = hp.n_text_layer
    per_sec = {k: dict(v) for k, v in tally.bytes.items() if k is not None and k[0] == step}
    layers = [sum(per_sec.get((step, li), {}).values()) / 1e9 for li in range(n_layers)]
    token_body = sum(per_sec.get((step, None), {}).values()) / 1e9
    by = _by_class(per_sec.values())
    total = sum(by.values()) / 1e9
    rows = beam * max(1, n_utt)
    ana = analytic(hp, weights, kv, rows=rows, n_utt=max(1, n_utt))
    per_token = token_body + n_layers * layers[0]
    return {
        "device": str(device),
        "device_name": torch.cuda.get_device_name(device) if cuda else "cpu",
        "note": ("bytes tallied per aten op and kernel launch (module docstring); "
                 + ("the kernels on the card" if cuda else
                    "on the CPU the kernels run as their plain versions (float32 scores, "
                    "dequantized weights): not the card's traffic")),
        "program": prog.name, "preset": preset, "weights": weights, "kv": kv,
        "rows": rows, "n_utt": max(1, n_utt), "decoder_calls": marks.calls,
        "token_body": {"gb": token_body,
                       "by_class_gb": {c: n / 1e9 for c, n in
                                       per_sec.get((step, None), {}).items()}},
        "layer_body": {"gb": layers[0],
                       "by_class_gb": {c: n / 1e9 for c, n in
                                       per_sec.get((step, 0), {}).items()}},
        "layers_gb": layers, "n_layers": n_layers,
        "per_token_gb": per_token, "step_total_gb": total,
        "by_class_gb": {c: n / 1e9 for c, n in by.items()},
        "ops": sum(tally.ops[k] for k in per_sec),
        "analytic": ana, "ratio_to_analytic": per_token / ana["step_gb"],
        "launches_tallied_run": launches,
        "step_ms": step_ms,
        "gb_per_s": None if step_ms is None else per_token / (step_ms / 1e3),
    }


def audit_encode(preset: str = "large-v3", batch: int = 1, weights: str = "bf16",
                 device="cuda", seed: int = 0, hp: Optional[WhisperHParams] = None) -> dict:
    """The tally of one encode (encoder + cross-KV) beside the analytic
    FLOPs."""
    from whisper_tpu_torch.tools import programs
    device = torch.device(device)
    a = programs.lv3_abstract(preset, hp=hp)
    if weights == "q5":
        a = a._replace(abs_params=a.q_params)
    prog = programs.encoder(a, batch)
    args = prog.args(device, seed)
    res = audit_step(lambda: prog.run(args))
    return {"device": str(device), "program": prog.name, **res,
            "analytic": analytic(a.hp)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m whisper_tpu_torch.tools.hbm_audit")
    ap.add_argument("--preset", default="large-v3")
    ap.add_argument("--q5", action="store_true", help="int8-block (q5-class) weights")
    ap.add_argument("--kv8", action="store_true", help="int8 self- and cross-KV (needs --batch)")
    ap.add_argument("--batch", type=int, default=0,
                    help="audit the U-utterance batched program instead")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (not the card's tally)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        from whisper_tpu_torch.errors import InitError
        raise InitError("no CUDA device; pass --cpu to tally on the CPU")
    out = audit_decode_step(args.preset, "q5" if args.q5 else "bf16",
                            "int8" if args.kv8 else "bf16", beam=5, n_utt=args.batch,
                            device="cpu" if args.cpu else "cuda")
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
