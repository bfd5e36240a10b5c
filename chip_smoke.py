#!/usr/bin/env python3
"""Drive the PyTorch port (whisper_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and turns TF32 off;
2. builds the CUDA kernels from whisper_tpu_torch/csrc with nvcc;
3. holds each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it, and times it beside its bound and the
   library call that computes the same function;
4. drives the main path through the user entry points:
   (a) a tiny ggml checkpoint written with the port's writer, loaded with
       WhisperContext.new_with_params, transcribed on the card and checked
       against the same transcription on the CPU;
   (b) WhisperContext.random("large-v3") in bf16: greedy full() on 40 s of
       seeded audio (two windows);
   (c) the same context, beam search with beam 5 on one window;
   each run counts the kernel launches it made, and must have made them;
5. prints the kernels line, the card line and, last, the result line.

It exits non-zero, without the result line, when CUDA is absent, when it
is not run from the repository, or when any phase fails.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bytes/s
TOLS = {"bfloat16": 2e-2, "float32": 1e-4}


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 3, runs: int = 15) -> float:
    """Median milliseconds of one call, from CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_bound(B, H, Tq, Tk, D, itemsize):
    """Least time (ms) for softmax(q k^T) v on the card: each input read
    once and the output written once at the memory rate, or 4*Tq*Tk*D
    operations per head at the bf16 tensor-core rate, whichever is larger."""
    nbytes = itemsize * B * H * D * (2 * Tq + 2 * Tk)
    flops = 4 * B * H * Tq * Tk * D
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(dev):
    """Flash attention against its plain version at the main path's
    shapes, in bf16 and f32; timings at the encoder and prompt shapes."""
    import torch
    import torch.nn.functional as F
    from whisper_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    cases = [  # (case, Tq, Tk): H = 20, D = 64 (large-v3)
        ("encoder_self", 1500, 1500),
        ("prompt_cross_8", 8, 1500),
        ("prompt_cross_64", 64, 1500),
        ("prompt_cross_232", 232, 1500),
        ("beam5_folded_8", 5 * 8, 1500),
        ("unaligned_tail", 70, 131),
    ]
    g = torch.Generator(device=dev).manual_seed(0)
    worst = {}
    timings = {}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        for case, tq, tk in cases:
            q = torch.randn(1, 20, tq, 64, device=dev, generator=g).to(dtype)
            k = torch.randn(1, 20, tk, 64, device=dev, generator=g).to(dtype)
            v = torch.randn(1, 20, tk, 64, device=dev, generator=g).to(dtype)
            out = flash_attention(q, k, v)
            ref = flash_attention_plain(q, k, v)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ok = bool(torch.isfinite(out).all().item()) and err <= TOLS[dtype_name]
            log({"kernel": "flash_attention", "case": case, "dtype": dtype_name,
                 "q": [1, 20, tq, 64], "tk": tk, "max_abs_err": err,
                 "tol": TOLS[dtype_name], "ok": ok})
            if not ok:
                raise AssertionError(f"flash_attention disagrees with its plain "
                                     f"version: {case} {dtype_name} err {err}")
            worst[dtype_name] = max(worst.get(dtype_name, 0.0), err)
            if dtype_name == "bfloat16" and case in ("encoder_self", "prompt_cross_8"):
                bound, bound_by = attention_bound(1, 20, tq, tk, 64, 2)
                timings[case] = {
                    "ms": cuda_ms(lambda: flash_attention(q, k, v)),
                    "plain_ms": cuda_ms(lambda: flash_attention_plain(q, k, v)),
                    "library_ms": cuda_ms(
                        lambda: F.scaled_dot_product_attention(q, k, v)),
                    "bound_ms": bound, "bound_by": bound_by,
                    "q": [1, 20, tq, 64], "tk": tk, "dtype": dtype_name}
                log({"kernel": "flash_attention", "timing": case, **timings[case]})
    return worst, timings


def synthetic_audio(seconds: float, seed: int):
    """Speech-like test signal: AM-modulated harmonics plus noise."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.7 * t)
    sig = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * 2.3 * t)) * (t % 3.0 < 2.0)
    sig = sig * env + 0.01 * rng.standard_normal(t.shape)
    return (0.3 * sig / np.abs(sig).max()).astype(np.float32)


def tiny_checkpoint(path: pathlib.Path):
    """A tiny ggml checkpoint (head dim 64, as the kernel requires) written
    with the port's own writer from the port's random weights."""
    from whisper_tpu_torch.audio.mel import mel_filterbank
    from whisper_tpu_torch.checkpoint import ggml_io, quant
    from whisper_tpu_torch.checkpoint.init import random_params
    from whisper_tpu_torch.config import WhisperHParams
    from whisper_tpu_torch.tokenizer import synthetic_vocab

    hp = WhisperHParams(n_vocab=51864, n_audio_ctx=1500, n_audio_state=128,
                        n_audio_head=2, n_audio_layer=2, n_text_ctx=448,
                        n_text_state=128, n_text_head=2, n_text_layer=3, n_mels=80)
    p = random_params(hp, seed=1, compute_dtype="float32")
    f32, f16 = quant.GGML_TYPE_F32, quant.GGML_TYPE_F16
    t = {}

    def put(name, a, ttype=f32):
        t[name] = (a.float().numpy(), ttype)

    def linear(prefix, lin):
        put(prefix + ".weight", lin["w"], f16)
        if "b" in lin:
            put(prefix + ".bias", lin["b"])

    def ln(prefix, pp):
        put(prefix + ".weight", pp["scale"])
        put(prefix + ".bias", pp["bias"])

    enc, dec = p["encoder"], p["decoder"]
    put("encoder.positional_embedding", enc["pos_embed"])
    for c in ("conv1", "conv2"):
        put(f"encoder.{c}.weight", enc[c]["w"], f16)
        put(f"encoder.{c}.bias", enc[c]["b"][:, None])
    ln("encoder.ln_post", enc["ln_post"])
    names = {"attn_q": "attn.query", "attn_k": "attn.key", "attn_v": "attn.value",
             "attn_out": "attn.out", "cross_q": "cross_attn.query",
             "cross_k": "cross_attn.key", "cross_v": "cross_attn.value",
             "cross_out": "cross_attn.out", "mlp_0": "mlp.0", "mlp_2": "mlp.2",
             "attn_ln": "attn_ln", "cross_ln": "cross_attn_ln", "mlp_ln": "mlp_ln"}
    for part, blocks in (("encoder", enc["blocks"]), ("decoder", dec["blocks"])):
        for i, blk in enumerate(blocks):
            for key, val in blk.items():
                name = f"{part}.blocks.{i}.{names[key]}"
                (ln if key.endswith("_ln") else linear)(name, val)
    put("decoder.positional_embedding", dec["pos_embed"])
    put("decoder.token_embedding.weight", dec["token_embed"], f16)
    ln("decoder.ln", dec["ln"])
    vocab = synthetic_vocab(hp.n_vocab)
    ggml_io.write_ggml(str(path), hp, mel_filterbank(hp.n_mels),
                       vocab.id_to_token[:50256], t)


def run_full(name, ctx, params, audio, expect_launches: bool = True):
    """One full() through the entry points; reports segments, timings and
    the kernel launches this run made, and checks them."""
    import torch
    from whisper_tpu_torch.ops.flash_attention import flash_attention

    st = ctx.create_state()
    flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st.full(params, audio)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    tm = st.get_timings()
    windows = tm["encode"]["calls"]
    hp = ctx.hparams
    expected = windows * (hp.n_audio_layer + hp.n_text_layer) if ctx.use_flash else 0
    finite = (bool(torch.isfinite(st.audio_embed).all())
              and bool(torch.isfinite(st.cross_k).all())
              and bool(torch.isfinite(st.cross_v).all()))
    # one prompt pass through the low-level entry point: finite logits
    logits, _ = st.decode([ctx.vocab.token_sot], 0, st.new_kv_cache(1))
    finite = finite and bool(torch.isfinite(logits).all())
    toks = [t for s in st.segments for t in s.tokens]
    finite = finite and all(map(lambda x: x == x and abs(x) != float("inf"),
                                [t.p for t in toks] + [t.plog for t in toks]))
    steps = tm["decode"]["calls"]
    report = {
        "run": name, "device": str(ctx.device), "dtype": str(ctx.dtype),
        "segments": st.full_n_segments(), "tokens": len(toks),
        "mel_ms": tm["mel"]["total_ms"], "encode_ms": tm["encode"]["total_ms"],
        "windows": windows, "decode_ms": tm["decode"]["total_ms"],
        "decode_steps": steps, "ms_per_step": tm["decode"]["total_ms"] / max(1, steps),
        "wall_s": wall, "flash_launches": launches,
        "flash_launches_expected": expected, "finite": finite,
        "text_head": st.full_get_all_text()[:60],
    }
    log(report)
    if not finite:
        raise AssertionError(f"{name}: non-finite values")
    if st.full_n_segments() == 0:
        raise AssertionError(f"{name}: no segments")
    if expect_launches and not (launches > 0 and launches == expected):
        raise AssertionError(f"{name}: flash_attention launched {launches} times, "
                             f"expected {expected}")
    return st, report


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import whisper_tpu_torch as pt
    from whisper_tpu_torch.ops import build
    from whisper_tpu_torch.ops.flash_attention import flash_attention

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    log(card)
    log({"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
         "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: off for matmul and cuDNN (float32 results are full float32)")

    # ---- 2. build
    t0 = time.perf_counter()
    built = build.build(ptxas_verbose=True)
    for name, info in built.items():
        log({"build": name, "seconds": info["seconds"]})
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log("  " + line.strip())
    log({"build_total_s": time.perf_counter() - t0})

    # ---- 3. kernels against their plain versions
    worst, timings = kernel_phase(dev)

    # ---- 4a. load path: a tiny ggml checkpoint, card against CPU
    ckpt = build.BUILD_DIR / "chip_smoke_tiny.bin"
    tiny_checkpoint(ckpt)
    audio = synthetic_audio(12, seed=0)
    runs = {}
    p = pt.FullParams.default()
    p.temperature_inc = 0.0
    p.print_progress = False
    p.no_timestamps = True
    p.max_tokens = 12
    p.suppress_regex = r"<syn\d\d\d+>"
    gpu32 = pt.WhisperContext.new_with_params(str(ckpt), pt.ContextParams(dtype="float32"))
    cpu32 = pt.WhisperContext.new_with_params(
        str(ckpt), pt.ContextParams(dtype="float32", use_gpu=False))
    st_gpu, runs["tiny_ggml_f32"] = run_full("tiny_ggml_f32", gpu32, p, audio)
    st_cpu = cpu32.create_state()
    st_cpu.full(p, audio)
    seg = lambda st: [(s.text, s.t0, s.t1, [t.id for t in s.tokens]) for s in st.segments]
    same = seg(st_gpu) == seg(st_cpu)
    log({"check": "tiny ggml f32: card segments == CPU segments", "ok": same})
    if not same:
        raise AssertionError("tiny model: card and CPU transcriptions differ")
    tiny = pt.WhisperContext.new_with_params(str(ckpt))        # bf16, the default
    pd = pt.FullParams.default()
    pd.temperature_inc = 0.0
    pd.print_progress = False
    _, runs["tiny_ggml_bf16"] = run_full("tiny_ggml_bf16", tiny, pd, audio)
    del gpu32, cpu32, tiny
    ckpt.unlink()

    # ---- 4b. large-v3, random weights, greedy, two windows
    t0 = time.perf_counter()
    ctx = pt.WhisperContext.random("large-v3", seed=0)
    torch.cuda.synchronize()
    log({"context": "large-v3 random bf16", "build_s": time.perf_counter() - t0,
         "weights_gib": torch.cuda.memory_allocated() / 2 ** 30})
    pg = pt.FullParams.default()
    pg.temperature_inc = 0.0
    pg.print_progress = False
    _, runs["large_v3_greedy"] = run_full("large_v3_greedy", ctx, pg, synthetic_audio(40, 1))

    # ---- 4c. beam 5, one window
    pb = pt.FullParams.default(pt.SamplingStrategy.BEAM_SEARCH)
    pb.beam_search.beam_size = 5
    pb.temperature_inc = 0.0
    pb.print_progress = False
    _, runs["large_v3_beam5"] = run_full("large_v3_beam5", ctx, pb, synthetic_audio(25, 2))
    log({"peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})

    # ---- 5. results
    enc = timings["encoder_self"]
    log({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "whisper_tpu_torch/csrc/flash_attention.cu",
        "replaces": "whisper_tpu/ops/flash_attention.py:25",
        "tpu_kernel": "whisper_tpu/ops/flash_attention.py::_attn_kernel",
        "launches": runs["large_v3_greedy"]["flash_launches"],
        "launches_by_run": {k: r["flash_launches"] for k, r in runs.items()},
        "max_abs_err": worst["bfloat16"], "max_err": worst["bfloat16"],
        "tol": TOLS["bfloat16"], "max_abs_err_f32": worst["float32"],
        "tol_f32": TOLS["float32"],
        "ms": enc["ms"], "kernel_ms": enc["ms"], "plain_ms": enc["plain_ms"],
        "bound_ms": enc["bound_ms"], "bound_by": enc["bound_by"],
        "library_ms": enc["library_ms"], "shape": {"q": enc["q"], "tk": enc["tk"],
                                                   "dtype": enc["dtype"]},
        "prompt_pass": timings["prompt_cross_8"],
    }]})
    log({"wall_s": time.perf_counter() - t_start})
    log(card)
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
