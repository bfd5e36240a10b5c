#!/usr/bin/env python3
"""Drive the PyTorch port (whisper_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and the port's
   device_info, and turns TF32 off;
2. builds the CUDA kernels from whisper_tpu_torch/csrc with nvcc (and the
   host runtime, csrc/runtime.cpp, with g++, all at once) and prints, per
   kernel function, its registers, shared memory and spills (-Xptxas -v)
   and its count of tensor-core instructions (cuobjdump -sass); the
   tensor-core kernels must have some: flash attention's
   attn_tc and quant_matmul's qmm_wide and qmm_skinny_cluster;
3. holds each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it, and times it (device time over cold
   copies of the inputs) beside its bound and the library call that
   computes the same function: (a) flash attention at the encoder and
   prompt shapes, one lane and four (the batched encode and prompt pass),
   and at one tensor-parallel rank's heads (10 at TP = 2, 5 at TP = 4),
   (b) the int8 block-dequant matmul, B2 (no offset) and
   B3 (offset), in six ggml formats on the skinny path (M = 1, 2, 3, 4, 5,
   8, 9, 10, 16) and the wide one (M = 20, 40 (the batched beam-5 step),
   70, 232, 1500), and in Q5_0 and Q5_1 at one tensor-parallel rank's
   shards of large-v3's linears (TP = 2: 1280 -> 640, 640 -> 1280,
   1280 -> 2560, 2560 -> 1280; TP = 4: 1280 -> 320, 320 -> 1280) at M = 1,
   2, 8, 20, 1500 and 3000 (Q5_0 timed at 1 and 1500); a skinny call
   repeated must give the same bits, and profiled skinny calls must run
   one device kernel each and no memset; Q5_0 and Q5_1 timed at M = 1, 5, 8,
   20, 40 and 1500 at large-v3's three linear shapes, with the host time per
   call and, at M = 1, 1280 -> 5120, where the host path spends it;
4. drives the main path through the user entry points:
   (a) a tiny ggml checkpoint written with the port's writer, loaded with
       WhisperContext.new_with_params, transcribed on the card and checked
       against the same transcription on the CPU;
   (b) WhisperContext.random("large-v3") in bf16: greedy full() on 6 s of
       seeded audio;
   (c) the same context, beam search with beam 5 on 15 s;
   (d) the tiny checkpoint written as Q5_0 by the port's quantizer, loaded
       with keep_quantized and the int8 KV cache, card against CPU;
   (e) large-v3 as Q5_0 (the weights of (b), quantized by the port's
       quantizer rule) through new_with_params with keep_quantized and the
       int8 KV cache: greedy on 3 s;
   (f) `small` (the layout of whisper.cpp's ggml-small-q5_1.bin) as Q5_1,
       keep_quantized, bf16 KV cache: beam 5 for 200 tokens (timestamps
       off and end-of-text suppressed, so the random weights decode to the
       token limit);
   (g) a tiny multilingual ggml checkpoint in f32 on 12 s of audio written
       as a 44.1 kHz stereo WAV and read back by the port's audio/io.py,
       card against CPU (segments, per-token t0/t1 and t_dtw, language):
       language auto-detection, token timestamps and DTW, first with a
       grammar compiled to the token DFA, then with a logits callback and
       a grammar over the DFA's budget (the host loop, on the card);
   (h) large-v3 as in (b): lang_detect() timed, then greedy on 6 s with
       language auto-detection, token timestamps and DTW (the LARGE_V3
       alignment heads), each window's t_dtw checked;
   (i) large-v3, greedy, one window of 32 tokens (no timestamps, no
       end-of-text) on 6 s: alone, with a grammar on the token DFA (its
       compile timed; the port's grammar machine must accept every text
       token emitted) and with a logits callback (the host loop): ms per
       step of each loop;
   (j) VAD: a seeded random Silero model (its final conv scaled to spread
       its probabilities) written by the port's writer; VadContext on the
       card, with TF32 switched on around it, against VadContext on the
       CPU (probabilities within 1e-5, segments equal; VAD ms for 12 s);
       a tiny f32 checkpoint's full(vad=True), card against CPU (segments
       with their remapped times); large-v3 bf16 full(vad=True) on 12 s
       of bursts with silent gaps (VAD ms, seconds kept, encode and step
       ms);
   (k) continuous batching: a tiny f32 checkpoint's full_batch on 3
       utterances through 2 lanes (a refill), greedy and beam-5, card
       against CPU, and a 1-lane batch against full() on the card;
       large-v3 bf16 full_batch on 4 x 6 s, greedy, 4 lanes (rounds, lane
       occupancy, encode ms per round, ms per batched step, audio-s per s
       beside (b)'s single stream); large-v3 full_parallel(4) with VAD on
       12 s (the merged segments monotone, without overlap); large-v3
       Q5_0 + int8 KV (the context of (e)) full_batch on 4 x 3 s, beam-5,
       whose steps run B2's wide path at M = 20;
   (l) speculative greedy decoding (a draft model proposes k tokens, one
       main forward verifies them): a tiny f32 model with its token
       embedding sharpened x 8 and another seed's draft at k = 1, 4, 8,
       card against its vanilla full() and against the CPU; large-v3 bf16
       (embedding sharpened x 8 on a copy, restored before (e)): vanilla
       greedy on 6 s, the context as its own draft at k = 8 (its stream
       must equal vanilla's; if bf16 rounding flips a token, the first
       divergence is printed and the check runs in float32), and a
       distil-large-v3-shaped draft (the shared encoder, 2 decoder layers
       copied from the first and last); the Q5_0 + int8 KV context of (e),
       vanilla and as its own draft (B2's skinny path at M = 8) on one
       window of 33 tokens; each speculative run prints tokens, rounds,
       tokens per round, ms per emitted token, per draft step and per
       verify;
   (n) the host C++ runtime (csrc/runtime.cpp, built with g++): loaded,
       and against the Python paths: DTW at 40 x 85, 200 x 750 and
       448 x 1500, the signal energy on 30 s, the dequantization of a
       1280 x 5120 Q5_0 tensor, the token-DFA compile of (g)'s grammar;
   (o) serving through the port's entry points: a tiny f32 checkpoint
       served twice by serving/server.serve() on a free local port, on
       the card and with ContextParams(use_gpu=False), the same requests
       to both (/inference in json, text, srt, vtt and verbose_json,
       greedy and beam-5, /health, /load): equal bodies (verbose_json's
       no_speech_prob within 1e-4); serving/cli.main with -otxt -osrt
       -ovtt -oj -ocsv on the card and with -ng (both in float32): equal
       files; a sliding-window StreamTranscriber and LspServer.handle on
       the card's and the CPU's context: equal events and answers;
       cli.main --profile-dir in its default bf16: the torch.profiler
       Chrome trace names attn_tc; then (e)'s large-v3 Q5_0 file served
       with keep_quantized and the int8 KV cache: one 1 s request through
       the lock path, its text equal to state.full on the server's own
       context, then the dispatcher on (2 s window, max_batch 4) and 4
       concurrent 1 s requests, staggered: /health shows one batch of 4
       rows and each text equals ctx.full_batch of the same audios at
       n_lanes = 4; per request the wall and audio-s per s through HTTP,
       per run each kernel's launches (B2 split into its wide and skinny
       paths), B1 and both B2 paths at least once;
   (p) the checkpoint tools and the mesh: a tiny f32 GGUF
       (checkpoint/gguf.py) on the card against the CPU; (b)'s large-v3
       weights written as F16 to a .bin and a .gguf, loaded to bit-equal
       params with equal greedy streams; (e)'s Q5_0 file through the
       native cache (checkpoint/native_cache.py): the first
       load_model_cached (parse, write) and the second (read) timed, the
       params bit-equal, keep_quantized + int8 KV contexts of both with
       equal greedy streams on 1 s; tools/dist_check.py's tp, dp and tp4
       topologies in 4 ranks sharing cuda:0 over gloo, tokens equal to
       its un-meshed reference; an NCCL process group of one; large-v3
       Q5_0 + int8 KV from the cache at TP = 2 (`--tp-rank`: two gloo
       ranks on cuda:0, each a mesh_shape (1, 2) context loaded on the
       host, so only its shard reaches the card, held to <= 0.6 of the
       model; the token embedding sharpened x 8 as in (l)):
       full_batch over the mesh (1, 2) on 2 x 1 s, each rank's segments
       equal to the un-meshed card run (else the first differing token
       is printed and both run again in float32), ms per batched step
       per rank against the un-meshed step, all-reduces per decoder call
       and each rank's B1 and B2 launches held to expected_launches;
       tools/micro_bench.main (copy GB/s, bf16 GEMM and B2 Q8_0
       TFLOP/s);
   (q) the evidence tools at large-v3 width (random weights, seed 0,
       decodes capped at 4 steps): utils/selfcheck's A/B check of flash
       attention; tools/programs.memory_summary of the encoder at batch 1
       and 4, decode_window beam-5 in bf16 and Q5_0, batch_decode Q5_0 +
       int8 KV at U = 1, 4, 8, 16, and from those peaks the utterances the
       card holds (a linear extrapolation, marked so); tools/hbm_audit's
       tally of one decode step (greedy and beam-5 bf16, greedy Q5_0 +
       int8 KV) against the analytic bytes, with its ms; the programs'
       and audits' launches held to what their calls imply;
       tools/tp_evidence at TP = 1, 2 and 4, speculation at TP = 2 (its
       stream equal to the un-meshed one, else again in float32) and the
       2 x 2 capacity mesh, each in gloo ranks on cuda:0: per-rank GiB,
       collectives per encode and per decoder call (97 all-reduces and a
       gather at TP = 2, 96 at TP = 4, where 51866 does not divide);
   (r) the benchmark harness (tools/bench.py) at large-v3 in this
       process, the launch counts set to 0 before it: the timing probe
       (chained 4096^3 bf16 products, below 1.05x the bf16 peak), the
       mel, encode, cross-kv, decode, bch5 and pp phases (random bf16
       weights, seed 0; CUDA events over two chain lengths), each finite
       and positive, B1 launched encodes x 32 times in the encode phase;
       the beam-5 memory check (memory_summary and the tallied step
       against the analytic bytes); the capacity sweep on the card's
       memory for Q5_0 + int8 KV (R_LABELS), exact, B2 launched in its
       cells; then tools/bench_all.py tiny --no-lv3 --no-batch as a
       process of its own, its table's row without an error; the JSON
       line and the table are printed;
   each run counts the kernel launches it made and holds them to the
   count derived from the run's encodes and decoder calls (a batched call
   counts once, whatever its rows); after (b) and (e), a few encodes under
   torch.profiler give the device's busy time and idle share per encode;
5. prints the kernels line, the card line and, last, the result line.

It exits non-zero, without the result line, when CUDA is absent, when it
is not run from the repository, or when any phase fails.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bytes/s
TOLS = {"bfloat16": 2e-2, "float32": 1e-4}
# quant_matmul against its plain version: both use the same bf16 operands,
# so only the float32 summation order differs (fixed from call to call on
# both paths); a wrong scale or offset index gives errors of order 1
QMM_TOL = 1e-3                # times max(1, max|plain|)


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


def device_ms(fns, rounds: int = 4, reps: int = 7) -> float:
    """Median device milliseconds of one call, for calls shorter than their
    host-side launch cost: a spin kernel holds the stream while the host
    queues `rounds` passes over `fns` between two CUDA events, so the
    events time the calls back to back on the device and not the Python
    that launches them. The spin lasts at least twice the host time of the
    queued passes (measured in the warm-up), so the device never waits for
    the host. Each of `fns` reads its own copy of the inputs; with more
    copies than the 50 MB L2 holds, every call finds its inputs cold, as
    the main path does."""
    import torch
    t_end = time.perf_counter() + 0.05          # warm up the clocks: >= 50 ms
    passes, t0 = 0, time.perf_counter()
    while time.perf_counter() < t_end:
        for fn in fns:
            fn()
        passes += 1
        torch.cuda.synchronize()
    spin_s = max(0.01, 2 * rounds * (time.perf_counter() - t0) / passes)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_s * 2e9))    # ~2e9 cycles a second
        start.record()
        for _ in range(rounds):
            for fn in fns:
                fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / (rounds * len(fns)))
    return statistics.median(times)


def host_us(fn, calls: int = 200) -> float:
    """Microseconds of host time per call (its launch path)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def kernel_resources(built) -> dict:
    """Per kernel function of each built library: registers, static shared
    memory, stack and spills from nvcc's -Xptxas -v log, and the count of
    tensor-core instructions (HMMA / HGMMA) in its SASS, from cuobjdump
    where the toolkit has it (absent where it does not)."""
    import re
    import shutil
    from whisper_tpu_torch.ops import build

    out = {}
    for name, info in built.items():
        funcs, cur = {}, None
        for line in info["log"].splitlines():
            if m := re.search(r"Compiling entry function '(\S+)'", line):
                cur = funcs.setdefault(m.group(1), {})
            elif cur is not None and (m := re.search(
                    r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads", line)):
                cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            elif cur is not None and (m := re.search(r"Used (\d+) registers", line)):
                smem = re.search(r"(\d+) bytes smem", line)
                cur.update(registers=int(m.group(1)),
                           static_smem=int(smem.group(1)) if smem else 0)
        cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        if pathlib.Path(cuobjdump).exists():
            sass = subprocess.run([cuobjdump, "-sass", str(build.library_path(name))],
                                  capture_output=True, text=True, timeout=300,
                                  check=True).stdout
            fn = None
            for line in sass.splitlines():
                if m := re.search(r"Function : (\S+)", line):
                    fn = m.group(1)
                    funcs.setdefault(fn, {})["tensor_core_instructions"] = 0
                elif fn is not None and re.search(r"\bH(G)?MMA\b", line):
                    funcs[fn]["tensor_core_instructions"] += 1
        names = list(funcs)
        filt = shutil.which("c++filt")
        if filt and names:
            names = subprocess.run([filt], input="\n".join(names), capture_output=True,
                                   text=True, timeout=60, check=True).stdout.splitlines()
        out[name] = {re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", short): funcs[raw]
                     for raw, short in zip(funcs, names)}
    return out


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
    shapes, in bf16 and f32; timings at the encoder shape and the prompt
    shapes (8 rows, and 40 with beam-5 folded): device time over cold
    copies of the inputs (`device_ms`), and CUDA events around one call
    (`cuda_ms`, as PRs 1-2 timed it)."""
    import torch
    import torch.nn.functional as F
    from whisper_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain, plan_splits)

    cases = [  # (case, B, H, Tq, Tk): D = 64; H = 20 (large-v3)
        ("encoder_self", 1, 20, 1500, 1500),
        ("prompt_cross_8", 1, 20, 8, 1500),
        ("prompt_cross_64", 1, 20, 64, 1500),
        ("prompt_cross_232", 1, 20, 232, 1500),
        ("beam5_folded_8", 1, 20, 5 * 8, 1500),
        ("unaligned_tail", 1, 20, 70, 131),
        # the batched path at 4 lanes: the encode, and the prompt pass's
        # cross-attention at each prompt bucket
        ("encoder_self_b4", 4, 20, 1500, 1500),
        ("prompt_cross_b4_8", 4, 20, 8, 1500),
        ("prompt_cross_b4_64", 4, 20, 64, 1500),
        ("prompt_cross_b4_232", 4, 20, 232, 1500),
        # one rank's heads under tensor parallelism: TP = 2 (10 heads; the
        # 2-lane encode of (p)) and TP = 4 (5 heads), the prompt pass at 10
        ("encoder_self_h10_tp2", 1, 10, 1500, 1500),
        ("encoder_self_b2_h10_tp2", 2, 10, 1500, 1500),
        ("encoder_self_h5_tp4", 1, 5, 1500, 1500),
        ("prompt_cross_b2_h10_tp2_8", 2, 10, 8, 1500),
    ]
    timed = ("encoder_self", "prompt_cross_8", "beam5_folded_8", "encoder_self_b4",
             "prompt_cross_b4_8", "encoder_self_h10_tp2", "encoder_self_h5_tp4")
    g = torch.Generator(device=dev).manual_seed(0)
    worst = {}
    timings = {}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        for case, b, h, tq, tk in cases:
            q = torch.randn(b, h, tq, 64, device=dev, generator=g).to(dtype)
            k = torch.randn(b, h, tk, 64, device=dev, generator=g).to(dtype)
            v = torch.randn(b, h, tk, 64, device=dev, generator=g).to(dtype)
            out = flash_attention(q, k, v)
            ref = flash_attention_plain(q, k, v)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ok = bool(torch.isfinite(out).all().item()) and err <= TOLS[dtype_name]
            log({"kernel": "flash_attention", "case": case, "dtype": dtype_name,
                 "q": [b, h, tq, 64], "tk": tk, "max_abs_err": err,
                 "tol": TOLS[dtype_name], "ok": ok})
            if not ok:
                raise AssertionError(f"flash_attention disagrees with its plain "
                                     f"version: {case} {dtype_name} err {err}")
            worst[dtype_name] = max(worst.get(dtype_name, 0.0), err)
            if dtype_name == "bfloat16" and case in timed:
                bound, bound_by = attention_bound(b, h, tq, tk, 64, 2)
                copies = [[t.clone() for t in (q, k, v)] for _ in range(8)]  # > L2
                timings[case] = {
                    "ms": device_ms([lambda c=c: flash_attention(*c) for c in copies]),
                    "plain_ms": device_ms([lambda c=c: flash_attention_plain(*c)
                                           for c in copies]),
                    "library_ms": device_ms([lambda c=c: F.scaled_dot_product_attention(*c)
                                             for c in copies]),
                    "library": "torch.nn.functional.scaled_dot_product_attention",
                    "cuda_ms": cuda_ms(lambda: flash_attention(q, k, v)),
                    "library_cuda_ms": cuda_ms(
                        lambda: F.scaled_dot_product_attention(q, k, v)),
                    "bound_ms": bound, "bound_by": bound_by,
                    "n_splits": plan_splits(b * h, tq, tk), "host_us_per_call":
                        host_us(lambda: flash_attention(q, k, v)),
                    "q": [b, h, tq, 64], "tk": tk, "dtype": dtype_name}
                del copies
                log({"kernel": "flash_attention", "timing": case, **timings[case]})
    return worst, timings


QMM_FORMATS = ("q5_0", "q8_0", "q6_k", "q5_1", "q5_k", "q2_k")
# the skinny path at M = 1..16 (its x tiles of 8 and 16 rows on both sides)
# and the wide path at the prompt buckets and the encoder
# and the wide one at the prompt buckets and the encoder; the batched path's
# step at U*K rows: 4 (4 lanes greedy), 10 (2 lanes beam-5), 20 and 40 (4
# and 8 lanes beam-5: the wide path at small M)
QMM_SHAPES = [(m, n_in, n_out) for n_in, n_out in ((1280, 5120), (5120, 1280), (1280, 1280))
              for m in (1, 2, 3, 4, 5, 8, 9, 10, 16, 20, 40, 70, 232, 1500)]
# (IN, OUT, M) timed for Q5_0 (B2) and Q5_1 (B3): large-v3's three decode
# shapes at M = 1 (greedy), 5 (beam-5) and 8 (the prompt bucket), the
# batched beam-5 step's 20 and 40 rows, and the encoder's three linear shapes
QMM_TIMED = {(n_in, n_out, m) for n_in, n_out in ((1280, 1280), (1280, 5120), (5120, 1280))
             for m in (1, 5, 8, 20, 40, 1500)}
# one rank's shard of large-v3's linears under tensor parallelism: TP = 2
# (QKV / cross-Q 1280 -> 640, the out projections 640 -> 1280, mlp_0
# 1280 -> 2560, mlp_2 2560 -> 1280) and TP = 4 (1280 -> 320, 320 -> 1280),
# checked in Q5_0 (B2) and Q5_1 (B3) at the step (M = 1, and 2: (p)'s two
# lanes), the prompt bucket and the encode (1500; 3000: (p)'s two lanes);
# Q5_0 timed at M = 1 and 1500
TP_SHARDS = ((1280, 640), (640, 1280), (1280, 2560), (2560, 1280), (1280, 320), (320, 1280))
QMM_TP_SHAPES = [(m, n_in, n_out) for n_in, n_out in TP_SHARDS
                 for m in (1, 2, 8, 20, 1500, 3000)]
QMM_TP_TIMED = {(n_in, n_out, m) for n_in, n_out in TP_SHARDS for m in (1, 1500)}
L2_BYTES = 50e6


def quantized_weight(fmt: str, n_in: int, n_out: int, seed: int, dev):
    """A seeded [out, in] weight through the port's quantizer and the
    loader's int8 block repack: q, d, m (None without offset), qblock, on
    `dev`."""
    import numpy as np
    import torch
    from whisper_tpu_torch.checkpoint import loader, quant
    from whisper_tpu_torch.tools.quantize import NAME_TO_TYPE
    ttype = NAME_TO_TYPE[fmt]
    w = np.random.default_rng(seed).standard_normal((n_out, n_in)).astype(np.float32) * 0.03
    leaves = loader.quantized_leaves(quant.quantize(w, ttype), ttype, n_out, n_in)
    return [torch.from_numpy(leaves[k]).to(dev) if k in leaves else None
            for k in "qdm"] + [quant.int8_block_size(ttype)]


def qmm_bound(m_rows, n_in, n_out, qblock, offset):
    """Least time (ms) for y = x @ dequant(q, d[, m]) on the card: q, d, m
    and bf16 x read once, float32 y written once, at the memory rate; or
    2*M*IN*OUT operations at the bf16 tensor-core rate; the larger."""
    nbytes = (n_in * n_out + (2 if offset else 1) * 4 * (n_in // qblock) * n_out
              + 2 * m_rows * n_in + 4 * m_rows * n_out)
    t_bytes, t_ops = nbytes / PEAK_BYTES, 2 * m_rows * n_in * n_out / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def device_kernels(fn, calls: int = 3, tries: int = 8) -> tuple:
    """Names of the device activities (kernels, memsets, copies) that
    `calls` calls of `fn` run, from torch.profiler, and the number of
    windows profiled to get them. A short window sometimes comes back
    with device activity missing: none at all (three empty windows in a
    row happened once, on an H100 80GB HBM3 at 700 W), or two skinny
    kernels for three calls (once, on the same card, in a run where every
    other window of the same calls recorded three). A window with fewer
    activities than calls is profiled again, up to `tries` times; a window
    with `calls` or more is held to the check as it is, and so is the last
    window when every try came back short. Once all eight windows came
    back short (the first Q5_1 skinny call, minutes into a run whose
    earlier windows were all whole). A likely cause: the profiler keeps
    only the device records whose times, converted from the card's clock
    to the host's, fall inside its window, and the conversion drifts as a
    run goes on. So the calls run 50 ms inside each edge of the window,
    which still records every device activity of the calls and nothing
    else."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = []
    for window in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.05)
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if len(names) >= calls:
            break
    return names, window


def qmm_host_breakdown(x, q, d, m, bs) -> dict:
    """Host microseconds per call of quant_matmul and of the steps a host
    path may take per call, each alone: the leaf checks, the stream
    lookup (torch.cuda.current_stream, and the raw handle the wrapper
    takes), a bf16 copy of x, an output allocation with torch.empty, and
    the ctypes call alone (which launches the kernel)."""
    import torch
    from whisper_tpu_torch.ops import quant_matmul as qmm
    IN, OUT = q.shape
    M = x.numel() // IN
    y = torch.empty(M, OUT, dtype=torch.float32, device=x.device)
    launch = qmm._kernel()
    cluster = qmm.plan_skinny(M, IN, OUT, bs) if M <= qmm.SKINNY_ROWS else 0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), q.data_ptr(), d.data_ptr(), None if m is None else m.data_ptr(),
            y.data_ptr(), M, IN, OUT, bs, cluster, x.device.index, stream)
    return {
        "quant_matmul": host_us(lambda: qmm.quant_matmul(x, q, d, m, bs)),
        "leaf_checks": host_us(lambda: qmm._check(x, q, d, m, bs)),
        "current_stream": host_us(lambda: torch.cuda.current_stream(x.device).cuda_stream),
        "raw_stream": host_us(lambda: torch._C._cuda_getCurrentRawStream(x.device.index)),
        "x_to_bf16_contiguous": host_us(
            lambda: x.reshape(-1, IN).to(torch.bfloat16).contiguous()),
        "torch_empty": host_us(
            lambda: torch.empty(M, OUT, dtype=torch.float32, device=x.device)),
        "ctypes_launch": host_us(lambda: launch(*args)),
    }


def qmm_phase(dev):
    """B2 / B3 against their plain version at the main path's shapes, in
    six formats (qblock 32 and 16, with and without offsets). Every skinny
    call (M <= 16) is also called again and must give the same bits. Q5_0
    (B2) and Q5_1 (B3) are timed at QMM_TIMED with cold inputs (device_ms
    over more copies of the weight than the L2 holds), as the main
    path finds its weights; three calls of a timed skinny case are
    profiled and must run exactly one device kernel each, the skinny one,
    and no memset."""
    import torch
    from whisper_tpu_torch.ops.quant_matmul import (
        SKINNY_ROWS, dequant_bf16, plan_skinny, quant_matmul, quant_matmul_plain)

    g = torch.Generator(device=dev).manual_seed(0)
    worst = {"quant_matmul": 0.0, "quant_matmul_offset": 0.0}
    worst_ratio = dict.fromkeys(worst, 0.0)
    timings = {}
    host = {}
    for fmt in QMM_FORMATS:
        kquant = fmt.endswith("_k")
        # K-quant rows must divide 256: the small odd shape takes IN 512
        shapes = QMM_SHAPES + [(3, 512 if kquant else 384, 1536)] + (
            QMM_TP_SHAPES if fmt in ("q5_0", "q5_1") else [])
        weights = {}
        for m_rows, n_in, n_out in shapes:
            if (n_in, n_out) not in weights:
                weights[(n_in, n_out)] = quantized_weight(fmt, n_in, n_out, n_in + n_out, dev)
            q, d, m, bs = weights[(n_in, n_out)]
            name = "quant_matmul" if m is None else "quant_matmul_offset"
            x = torch.randn(m_rows, n_in, device=dev, generator=g).bfloat16()
            y = quant_matmul(x, q, d, m, bs)
            ref = quant_matmul_plain(x, q, d, m, bs)
            torch.cuda.synchronize()
            err = (y - ref).abs().max().item()
            allowed = QMM_TOL * max(1.0, ref.abs().max().item())
            ok = bool(torch.isfinite(y).all().item()) and err <= allowed
            same = m_rows > SKINNY_ROWS or torch.equal(quant_matmul(x, q, d, m, bs), y)
            log({"kernel": name, "format": fmt, "qblock": bs, "m": m_rows, "in": n_in,
                 "out": n_out, "max_abs_err": err, "allowed": allowed, "ok": ok,
                 "bit_identical_repeat": same})
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain version: {fmt} "
                                     f"M={m_rows} {n_in}->{n_out} err {err} > {allowed}")
            if not same:
                raise AssertionError(f"{name}: two skinny calls on the same inputs differ: "
                                     f"{fmt} M={m_rows} {n_in}->{n_out}")
            worst[name] = max(worst[name], err)
            worst_ratio[name] = max(worst_ratio[name], err / allowed)
            if ((fmt in ("q5_0", "q5_1") and (n_in, n_out, m_rows) in QMM_TIMED)
                    or (fmt == "q5_0" and (n_in, n_out, m_rows) in QMM_TP_TIMED)):
                bound, bound_by, nbytes = qmm_bound(m_rows, n_in, n_out, bs, m is not None)
                # more than the L2 in q's copies, more than twice it in the dense ones
                n_copies = max(8, int(2 * L2_BYTES // (q.numel() * 2)) + 1)
                copies = [[None if a is None else a.clone() for a in (q, d, m)]
                          for _ in range(n_copies)]
                dense = [dequant_bf16(*c, bs).t().contiguous() for c in copies]  # [out, in]
                kern = [lambda c=c: quant_matmul(x, *c, bs) for c in copies]
                t = {"format": fmt, "m": m_rows, "in": n_in, "out": n_out,
                     "weight_copies": n_copies,
                     "ms": device_ms(kern),
                     "plain_ms": device_ms([lambda c=c: quant_matmul_plain(x, *c, bs)
                                            for c in copies]),
                     # the dense linear the port runs without keep_quantized:
                     # 2 bytes a weight against the kernel's 1.125 (1.25 with m)
                     "library_ms": device_ms([lambda w=w: torch.mm(x, w.t(),
                                                                   out_dtype=torch.float32)
                                              for w in dense]),
                     "library": "torch.mm bf16 dense (weight dequantized ahead of time)",
                     "bound_ms": bound, "bound_by": bound_by, "bytes": nbytes,
                     "host_us_per_call": host_us(kern[0])}
                if m_rows <= SKINNY_ROWS:
                    ran, windows = device_kernels(kern[0])
                    t["cluster"] = plan_skinny(m_rows, n_in, n_out, bs)
                    t["device_activities_in_3_calls"] = ran
                    t["profiler_windows"] = windows
                    if len(ran) != 3 or any("qmm_skinny_cluster" not in r for r in ran):
                        raise AssertionError(f"{name}: 3 skinny calls ran {ran}, not one "
                                             f"qmm_skinny_cluster kernel each")
                    if (n_in, n_out, m_rows) == (1280, 5120, 1):
                        host[name] = qmm_host_breakdown(x, q, d, m, bs)
                        log({"kernel": name, "host_us_breakdown": f"M=1 {n_in}->{n_out}",
                             **host[name]})
                del copies, dense
                timings[(name, m_rows, n_in, n_out)] = t
                log({"kernel": name, "timing": f"M={m_rows} {n_in}->{n_out}", **t})
    return worst, worst_ratio, timings, host


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


TINY_HP = dict(n_vocab=51864, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2,
               n_audio_layer=2, n_text_ctx=448, n_text_state=128, n_text_head=2,
               n_text_layer=3, n_mels=80)


def ggml_tensors(p):
    """The port's parameter tree -> {ggml tensor name: (float32 array,
    ggml type)}: matmul weights, convolutions and the token embedding as
    F16, the rest F32, as whisper.cpp's converter writes them."""
    from whisper_tpu_torch.checkpoint import quant
    f32, f16 = quant.GGML_TYPE_F32, quant.GGML_TYPE_F16
    t = {}

    def put(name, a, ttype=f32):
        t[name] = (a.detach().float().cpu().numpy(), ttype)

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
    return t


def write_checkpoint(path: pathlib.Path, hp, p, qtype: str = ""):
    """A ggml checkpoint of the parameter tree `p`, written with the
    port's writer; with `qtype` (e.g. "q5_0") every 2-D tensor outside the
    quantizer's skip list is encoded in that format first, by the rule of
    the port's tools/quantize.py (whisper.cpp's quantizer)."""
    import dataclasses
    from whisper_tpu_torch.audio.mel import mel_filterbank
    from whisper_tpu_torch.checkpoint import ggml_io, quant
    from whisper_tpu_torch.tokenizer import synthetic_vocab
    from whisper_tpu_torch.tools import quantize

    tensors = ggml_tensors(p)
    if qtype:
        tensors = quantize.quantize_tensors(tensors, qtype)
        hp = dataclasses.replace(
            hp, ftype=quant.TYPE_TO_FTYPE[quantize.NAME_TO_TYPE[qtype]])
    vocab = synthetic_vocab(hp.n_vocab)
    ggml_io.write_ggml(str(path), hp, mel_filterbank(hp.n_mels),
                       vocab.id_to_token[:50256], tensors)


def tiny_checkpoint(path: pathlib.Path, qtype: str = "", n_vocab: int = 51864):
    """A tiny ggml checkpoint (head dim 64, as the flash kernel requires)
    of the port's random weights; `qtype` as in write_checkpoint; n_vocab
    51865 makes it multilingual."""
    from whisper_tpu_torch.checkpoint.init import random_params
    from whisper_tpu_torch.config import WhisperHParams
    hp = WhisperHParams(**{**TINY_HP, "n_vocab": n_vocab})
    write_checkpoint(path, hp, random_params(hp, seed=1, compute_dtype="float32"), qtype)


def tree_gib(tree) -> float:
    """GiB held by the tensors of a parameter tree."""
    if isinstance(tree, dict):
        return sum(tree_gib(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_gib(v) for v in tree)
    return tree.numel() * tree.element_size() / 2 ** 30


def expected_launches(ctx, windows: int, dec_calls: int, prompt_passes: int,
                      cross_only: int = 0, main=None) -> dict:
    """Kernel launches a full() run must make with the model of `ctx`, from
    counts the run keeps apart from the kernels' counters: every encoder
    self-attention takes B1 (`windows` counts encodes, the language
    detection's included), and so does the cross-attention of every
    decoder call with T > 1 that does not collect the cross-attention
    probabilities (`prompt_passes`: the prompt pass of each attempt, in
    the device loop and in the host loop, and each speculative verify
    chunk of k > 1 rows; not the DTW pass) unless the cross-KV is int8;
    every quantized linear takes B2, or B3 for the offset formats: 6 per
    encoder layer and 2 per decoder layer (the cross K/V) per window, 2
    per decoder layer per `cross_only` window (a draft that shares the
    main encoder projects only its cross K/V), 8 per decoder layer per
    decoder call. A batched call counts once whatever its rows: a batched
    encode of U lanes is one encode (one B1 launch per encoder layer, its
    linears at M = U*1500), a batched prompt pass one decoder call with
    T > 1, a batched step one decoder call (its linears at M = U*K). A
    draft model takes the int8 KV and the flash setting of `main`, the
    context it serves."""
    main = main or ctx
    hp = ctx.hparams
    la, lt = hp.n_audio_layer, hp.n_text_layer
    out = {"flash_attention": 0, "quant_matmul": 0, "quant_matmul_offset": 0}
    if main.use_flash:
        out["flash_attention"] = windows * la + (0 if main.kv_quant else prompt_passes * lt)
    leaf = ctx.params["encoder"]["blocks"][0]["attn_q"]
    if "q" in leaf:
        name = "quant_matmul_offset" if "m" in leaf else "quant_matmul"
        out[name] = (windows * (6 * la + 2 * lt) + cross_only * 2 * lt
                     + dec_calls * 8 * lt)
    return out


def run_full(name, ctx, params, audio, check_launches: bool = True,
             time_calls: bool = False, keep_args: bool = False):
    """One full() through the entry points; reports segments, timings and
    the kernel launches this run made, and holds them to
    expected_launches (a draft model's share included). With time_calls,
    every decoder call is timed (synchronized) by model and kind: a prompt
    pass, a one-token step or a multi-row chunk (a speculative verify).
    With keep_args, each device-loop window's prompt and cross K/V are
    kept (st.smoke["args"])."""
    import torch
    from whisper_tpu_torch.models import whisper as model_mod
    from whisper_tpu_torch.ops.flash_attention import flash_attention
    from whisper_tpu_torch.ops.quant_matmul import quant_matmul

    from whisper_tpu_torch.decoding import device_loop, dtw, host_loop, speculative

    # decoder calls by model (its weights), and those with T > 1 that do
    # not collect the cross-attention probabilities, counted apart from
    # the kernels; with time_calls, seconds and calls by model and kind
    decoder_forward = model_mod.decoder_forward
    per_model, call_ms = {}, {}

    def counted(*a, **k):
        calls = per_model.setdefault(id(a[0]), [0, 0])
        calls[0] += 1
        tokens = a[2] if len(a) > 2 else k["tokens"]
        collect = a[8] if len(a) > 8 else k.get("collect_cross_qk", False)
        calls[1] += int(tokens.shape[1] > 1 and not collect)
        if not time_calls:
            return decoder_forward(*a, **k)
        kind = ("prompt" if k.get("logit_rows") is not None
                else "step" if tokens.shape[1] == 1 else "chunk")
        key = f"{'main' if a[0] is ctx.params else 'draft'}.{kind}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = decoder_forward(*a, **k)
        torch.cuda.synchronize()
        rec = call_ms.setdefault(key, [0.0, 0])
        rec[0] += (time.perf_counter() - t0) * 1e3
        rec[1] += 1
        return out

    # each window decode timed (synchronized) by loop, and kept; each DTW
    # window's bounds and stamped tokens kept
    # seconds, windows, steps (a speculative window's: its emitted tokens)
    loops = {"device": [0.0, 0, 0], "host": [0.0, 0, 0], "spec": [0.0, 0, 0]}
    results, dtw_windows, window_args = [], [], []

    def timed(kind, fn):
        def run(*a, **k):
            if keep_args and kind == "device":
                window_args.append((a[5], a[6], a[3], a[4]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            rec = loops[kind]
            rec[0] += time.perf_counter() - t0
            rec[1] += 1
            rec[2] += int(r.n_tokens)
            results.append(r)
            return r
        return run

    def dtw_kept(state, params, segs, seek, n_frames, *a, **k):
        dtw_fn(state, params, segs, seek, n_frames, *a, **k)
        dtw_windows.append((seek, n_frames, [t for s in segs for t in s.tokens
                                             if t.id < ctx.vocab.token_eot]))

    dtw_fn = dtw.compute_dtw_timestamps
    patches = [(model_mod, "decoder_forward", counted),
               (device_loop, "decode_window", timed("device", device_loop.decode_window)),
               (host_loop, "decode_window_host", timed("host", host_loop.decode_window_host)),
               (speculative, "decode_window_speculative",
                timed("spec", speculative.decode_window_speculative)),
               (dtw, "compute_dtw_timestamps", dtw_kept)]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    st = ctx.create_state()
    for mod, attr, fn in patches:
        setattr(mod, attr, fn)
    try:
        flash_attention.launches = 0
        quant_matmul.launches = quant_matmul.launches_offset = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st.full(params, audio)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_attention": flash_attention.launches,
                    "quant_matmul": quant_matmul.launches,
                    "quant_matmul_offset": quant_matmul.launches_offset}
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    st.smoke = {"results": results, "dtw_windows": dtw_windows, "args": window_args}
    tm = st.get_timings()
    windows = tm["encode"]["calls"]
    # each model's encodes and decoder calls: the main model's, and an
    # attached draft's (a self-draft's in the same count, as the same model)
    draft_windows = tm.get("encode_draft", {"calls": 0})["calls"]
    shares = ctx.cparams.draft_shares_encoder
    models = {id(ctx.params): [ctx, windows, 0]}
    if ctx.draft is not None:
        m = models.setdefault(id(ctx.draft.params), [ctx.draft, 0, 0])
        m[2 if shares else 1] += draft_windows
    expected = {"flash_attention": 0, "quant_matmul": 0, "quant_matmul_offset": 0}
    for key, (m, enc, cross) in models.items():
        dec, multi = per_model.get(key, [0, 0])
        for kernel, n in expected_launches(m, enc, dec, multi, cross, ctx).items():
            expected[kernel] += n
    calls = [sum(c[0] for c in per_model.values()), sum(c[1] for c in per_model.values())]
    cross = [t for kv in (st.cross_k, st.cross_v)
             for t in (kv if isinstance(kv, tuple) else (kv,))]
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in [st.audio_embed] + cross)
    # one prompt pass through the low-level entry point: finite logits
    logits, _ = st.decode([ctx.vocab.token_sot], 0, st.new_kv_cache(1))
    finite = finite and bool(torch.isfinite(logits).all())
    toks = [t for s in st.segments for t in s.tokens]
    finite = finite and all(map(lambda x: x == x and abs(x) != float("inf"),
                                [t.p for t in toks] + [t.plog for t in toks]))
    steps = tm["decode"]["calls"]
    report = {
        "run": name, "device": str(ctx.device), "dtype": str(ctx.dtype),
        "keep_quantized": ctx.cparams.keep_quantized, "kv_int8": ctx.kv_quant,
        "segments": st.full_n_segments(), "tokens": len(toks),
        "mel_ms": tm["mel"]["total_ms"], "encode_ms": tm["encode"]["total_ms"],
        "windows": windows, "decode_ms": tm["decode"]["total_ms"],
        "decode_steps": steps, "ms_per_step": tm["decode"]["total_ms"] / max(1, steps),
        "decoder_calls": calls[0], "prompt_passes": calls[1], "wall_s": wall,
        "draft_windows": draft_windows, "spec_stats": st.spec_stats,
        "decoder_call_ms": {k: {"calls": n, "ms_each": ms / n}
                            for k, (ms, n) in call_ms.items()},
        "audio_s": len(audio) / 16000, "audio_s_per_s": len(audio) / 16000 / wall,
        "flash_launches": launches["flash_attention"], "launches": launches,
        "launches_expected": expected, "finite": finite,
        "loops": {kind: {"windows": n, "steps": steps_k,
                         "ms_per_step": sec * 1e3 / max(1, steps_k)}
                  for kind, (sec, n, steps_k) in loops.items() if n},
        "lang_id": st.full_lang_id(),
        "text_head": st.full_get_all_text()[:60],
    }
    for phase in ("dtw", "energy", "vad"):
        if phase in tm:
            report[f"{phase}_ms"] = tm[phase]["total_ms"]
            report[f"{phase}_calls"] = tm[phase]["calls"]
    log(report)
    if not finite:
        raise AssertionError(f"{name}: non-finite values")
    if st.full_n_segments() == 0:
        raise AssertionError(f"{name}: no segments")
    if check_launches:
        if launches != expected:
            raise AssertionError(f"{name}: kernel launches {launches}, expected {expected}")
        leaf = ctx.params["encoder"]["blocks"][0]["attn_q"]
        path = (["flash_attention"] if ctx.use_flash else []) + (
            [] if "q" not in leaf else
            ["quant_matmul_offset" if "m" in leaf else "quant_matmul"])
        if any(launches[k] == 0 for k in path):
            raise AssertionError(f"{name}: a kernel of the path was never launched: "
                                 f"{launches}")
    return st, report


def run_batch(name, ctx, params, audios, n_lanes=None, parallel: int = 0, mesh=None):
    """One WhisperContext.full_batch over `audios` (or, with `parallel` =
    n, one WhisperState.full_parallel of n chunks over audios[0]) through
    the entry points, over `mesh` when given. Counts the encoder calls
    (each batched encode and each language detection) and the decoder
    calls apart from the kernels' counters, and the tensor-parallel
    all-reduces made inside decoder calls; times each batched encode
    (encoder and cross K/V) and each batched window decode
    (synchronized), and holds the kernel launches to expected_launches
    (under tensor parallelism each rank launches what the unsharded model
    does, at its shard's shapes)."""
    import torch
    from whisper_tpu_torch.decoding import batch_loop
    from whisper_tpu_torch.models import whisper as model_mod
    from whisper_tpu_torch.ops.flash_attention import flash_attention
    from whisper_tpu_torch.ops.quant_matmul import quant_matmul

    calls = {"encodes": 0, "decoder": 0, "multi_row": 0, "decoder_all_reduces": 0}
    times = {"encode_s": 0.0, "decode_s": 0.0, "windows": 0, "steps": 0, "rows": 0}

    def synced(fn, key):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            times[key] += time.perf_counter() - t0
            return r
        return run

    encoder_forward = synced(model_mod.encoder_forward, "encode_s")
    decoder_forward = model_mod.decoder_forward
    windows_batch = synced(batch_loop.decode_windows_batch, "decode_s")

    def counted_encoder(*a, **k):
        calls["encodes"] += 1
        return encoder_forward(*a, **k)

    def counted_decoder(*a, **k):
        calls["decoder"] += 1
        calls["multi_row"] += int(a[2].shape[1] > 1)
        before = model_mod.tp_all_reduce.calls
        r = decoder_forward(*a, **k)
        calls["decoder_all_reduces"] += model_mod.tp_all_reduce.calls - before
        return r

    def counted_windows(*a, **k):
        r = windows_batch(*a, **k)
        times["windows"] += 1
        times["steps"] += int(r.n_tokens)
        times["rows"] = max(times["rows"], r.tokens.shape[0])
        return r

    patches = [(model_mod, "encoder_forward", counted_encoder),
               (model_mod, "cross_attention_kv",
                synced(model_mod.cross_attention_kv, "encode_s")),
               (model_mod, "decoder_forward", counted_decoder),
               (batch_loop, "decode_windows_batch", counted_windows)]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    stats, merged = {}, []
    for mod, attr, fn in patches:
        setattr(mod, attr, fn)
    try:
        flash_attention.launches = 0
        quant_matmul.launches = quant_matmul.launches_offset = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if parallel:
            params.new_segment_callback = lambda c, s, seg: merged.append((seg.t0, seg.t1))
            st = ctx.create_state()
            st.full_parallel(params, audios[0], parallel)
            results = [st.segments]
        else:
            results = ctx.full_batch(params, audios, n_lanes=n_lanes, stats=stats, mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_attention": flash_attention.launches,
                    "quant_matmul": quant_matmul.launches,
                    "quant_matmul_offset": quant_matmul.launches_offset}
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
        params.new_segment_callback = None
    expected = expected_launches(ctx, calls["encodes"], calls["decoder"], calls["multi_row"])
    toks = [t for segs in results for s in segs for t in s.tokens]
    finite = all(x == x and abs(x) != float("inf")
                 for t in toks for x in (t.p, t.plog))
    audio_s = sum(len(a) for a in audios) / 16000
    report = {
        "run": name, "device": str(ctx.device), "dtype": str(ctx.dtype),
        "keep_quantized": ctx.cparams.keep_quantized, "kv_int8": ctx.kv_quant,
        "utterances": len(audios), "full_parallel_chunks": parallel or None,
        **stats, "encodes": calls["encodes"],
        "encode_ms_per_round": times["encode_s"] * 1e3 / max(1, calls["encodes"]),
        "batched_windows": times["windows"], "batched_steps": times["steps"],
        "rows_per_step": times["rows"],
        "ms_per_batched_step": times["decode_s"] * 1e3 / max(1, times["steps"]),
        "decoder_calls": calls["decoder"], "prompt_passes": calls["multi_row"],
        "tp_all_reduces_per_decoder_call":
            calls["decoder_all_reduces"] / max(1, calls["decoder"]),
        "segments": sum(len(r) for r in results), "tokens": len(toks), "wall_s": wall,
        "audio_s": audio_s, "audio_s_per_s": audio_s / wall,
        "launches": launches, "launches_expected": expected, "finite": finite,
    }
    log(report)
    if not finite or not toks:
        raise AssertionError(f"{name}: non-finite values or no token")
    if launches != expected:
        raise AssertionError(f"{name}: kernel launches {launches}, expected {expected}")
    leaf = ctx.params["encoder"]["blocks"][0]["attn_q"]
    path = (["flash_attention"] if ctx.use_flash else []) + (
        [] if "q" not in leaf else ["quant_matmul_offset" if "m" in leaf else "quant_matmul"])
    if any(launches[k] == 0 for k in path):
        raise AssertionError(f"{name}: a kernel of the path was never launched: {launches}")
    return results, report, merged


def spread_vad_model(seed: int = 0):
    """A seeded random VAD model with its final 1x1 conv scaled by 64 (a
    power of two, exact in the file's float16). Random weights give
    probabilities near 0.5 (exactly 0.5 on silence), which no threshold
    splits into speech and silence; the scale spreads them."""
    from whisper_tpu_torch.models import vad
    m = vad.random_vad_model(seed)
    m.params["_model.decoder.decoder.2.weight"] = m.params["_model.decoder.decoder.2.weight"] * 64
    return m


def bursts(seconds: float, seed: int):
    """synthetic_audio with its 1 s gaps (every third second) made silent."""
    import numpy as np
    a = synthetic_audio(seconds, seed)
    return a * (np.arange(len(a)) / 16000 % 3.0 < 2.0).astype(np.float32)


def vad_threshold(probs, percentile: float = 75) -> float:
    """A threshold from the model's own probabilities on the audio: their
    percentile, moved until no probability lies within 1e-4 of it or of
    its hysteresis partner (threshold - 0.15), so that the card's and the
    CPU's probabilities (within 1e-5) classify every window alike."""
    import numpy as np
    thr = float(np.percentile(probs, percentile))
    while (np.abs(probs - thr).min() <= 1e-4
           or np.abs(probs - max(thr - 0.15, 0.01)).min() <= 1e-4):
        thr += 2e-5
    return thr


def phase_j(pt, build, runs, ctx):
    """(j) VAD: a seeded spread VAD model written by the port's writer;
    VadContext on the card (with TF32 switched on around the call: the
    module must not depend on it) against VadContext on the CPU; tiny
    ggml full(vad=True), card against CPU; large-v3 bf16 full(vad=True)
    on 12 s of bursts with silent gaps (`ctx`). Returns the VAD file and
    its threshold for 12 s of bursts."""
    import numpy as np
    import torch
    from whisper_tpu_torch.models import vad

    path = build.BUILD_DIR / "chip_smoke_vad.bin"
    vad.write_vad_ggml(str(path), spread_vad_model(0))
    audio = bursts(12, 11)
    cpu = pt.VadContext.init_from_file_with_params(str(path), pt.VadContextParams(use_gpu=False))
    card = pt.VadContext.init_from_file_with_params(str(path))
    cpu.detect_speech(audio)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        card.detect_speech(audio)                      # warm-up (cuDNN plans)
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card.detect_speech(audio)
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    err = float(np.abs(card.probs - cpu.probs).max())
    thr = vad_threshold(cpu.probs)
    p = pt.VadParams(threshold=thr)
    segs = [[(s.start, s.end) for s in c.segments_from_probs(p)] for c in (card, cpu)]
    ok = err <= 1e-5 and segs[0] == segs[1] and bool(segs[0])
    log({"check": "(j) VadContext on the card (TF32 on) == CPU: probs within 1e-5, "
                  "segments equal", "ok": ok, "max_abs_err": err, "windows": card.n_probs,
         "threshold": thr, "segments": segs[0], "vad_ms_12s": statistics.median(ms),
         "vad_ms_all": ms})
    if not ok:
        raise AssertionError(f"(j) VAD card != CPU: err {err}, {segs}")

    def vad_params(pd):
        pd.vad = True
        pd.vad_model_path = str(path)
        pd.vad_params.threshold = thr
        return pd

    # tiny ggml f32, full(vad=True): card against CPU
    ckpt = build.BUILD_DIR / "chip_smoke_tiny_vad.bin"
    tiny_checkpoint(ckpt)
    got = {}
    for where, use_gpu in (("card", True), ("cpu", False)):
        c = pt.WhisperContext.new_with_params(
            str(ckpt), pt.ContextParams(dtype="float32", use_gpu=use_gpu))
        st = c.create_state()
        st.full(vad_params(decisive_params(pt)), audio)
        got[where] = (segments(st), st.vad_mapping)
    ckpt.unlink()
    same = got["card"] == got["cpu"] and bool(got["card"][0])
    log({"check": "(j) tiny ggml f32 full(vad=True): card segments (remapped times) "
                  "and VAD mapping == CPU's", "ok": same, "segments": len(got["card"][0]),
         "kept_s": got["card"][1][-1][0] / 100})
    if not same:
        raise AssertionError(f"(j) tiny VAD full: card {got['card']} != CPU {got['cpu']}")

    # large-v3 bf16 full(vad=True) on 12 s of bursts
    pg = pt.FullParams.default()
    pg.temperature_inc = 0.0
    pg.print_progress = False
    st, r = run_full("large_v3_vad_greedy", ctx, vad_params(pg), audio)
    r.update(vad_kept_s=st.vad_mapping[-1][0] / 100,
             encode_ms_per_window=r["encode_ms"] / max(1, r["windows"]))
    runs["large_v3_vad_greedy"] = r
    log({"check": "(j) large-v3 bf16 full(vad=True)", "ok": True, "vad_ms": r["vad_ms"],
         "audio_s": 12.0, "kept_s": r["vad_kept_s"],
         "encode_ms_per_window": r["encode_ms_per_window"], "ms_per_step": r["ms_per_step"]})
    return path, thr


def decisive_params(pt, beam: int = 0):
    """The decisive config: greedy (or beam search), temperature ladder
    off, no timestamps, 12 tokens, a suppress_regex that shrinks the
    candidate set, so that float32 summation order cannot flip an argmax."""
    p = pt.FullParams.default(pt.SamplingStrategy.BEAM_SEARCH if beam
                              else pt.SamplingStrategy.GREEDY)
    p.beam_search.beam_size = max(1, beam)
    p.temperature_inc = 0.0
    p.print_progress = False
    p.no_timestamps = True
    p.max_tokens = 12
    p.suppress_regex = r"<syn\d\d\d+>"
    return p


def phase_k_tiny(pt, build, runs):
    """(k) batching on a tiny f32 ggml checkpoint: full_batch on 3
    utterances of different lengths through 2 lanes (a refill), greedy and
    beam-5, card against CPU; and a 1-lane batch of one utterance against
    full() on the card."""
    ckpt = build.BUILD_DIR / "chip_smoke_tiny_batch.bin"
    tiny_checkpoint(ckpt)
    ctxs = {where: pt.WhisperContext.new_with_params(
        str(ckpt), pt.ContextParams(dtype="float32", use_gpu=where == "card"))
        for where in ("card", "cpu")}
    ckpt.unlink()
    audios = [synthetic_audio(s, 20 + i) for i, s in enumerate((4, 9, 2))]
    for beam in (0, 5):
        name = f"tiny_batch_{'beam5' if beam else 'greedy'}_refill"
        res, runs[name], _ = run_batch(name, ctxs["card"], decisive_params(pt, beam), audios,
                                       n_lanes=2)
        stats = {}
        want = ctxs["cpu"].full_batch(decisive_params(pt, beam), audios, n_lanes=2, stats=stats)
        same = ([[seg_tuple(s) for s in u] for u in res]
                == [[seg_tuple(s) for s in u] for u in want])
        refilled = runs[name]["admitted"] == 3 and runs[name]["n_lanes"] == 2
        log({"check": f"(k) {name}: card segments == CPU's, 3 utterances through 2 lanes",
             "ok": same and refilled, "stats": stats})
        if not (same and refilled and stats == {k: runs[name][k] for k in stats}):
            raise AssertionError(f"(k) {name}: card {res} != CPU {want}")
        lane0 = ctxs["card"].full_batch(decisive_params(pt, beam), audios[:1], n_lanes=1)[0]
        st = ctxs["card"].create_state()
        st.full(decisive_params(pt, beam), audios[0])
        same = [seg_tuple(s) for s in lane0] == segments(st)
        log({"check": f"(k) {name}: lane 0 of a 1-lane batch == full() on the card",
             "ok": same})
        if not same:
            raise AssertionError(f"(k) {name}: 1-lane batch != full()")


def seg_tuple(s):
    return (s.text, s.t0, s.t1, [t.id for t in s.tokens])


def phase_k_large(pt, runs, ctx, vad_path, vad_thr):
    """(k) batching on large-v3 bf16: full_batch on 4 x 6 s, greedy, 4
    lanes, beside (b)'s single stream; full_parallel(n_processors=4) with
    VAD on 12 s of bursts: the merged segments (as the merge hands them to
    new_segment_callback, before the VAD remap) are monotone and do not
    overlap: each starts no earlier than the previous one ends (the
    reference's merge clamps t0 only, so a random-weight segment whose t1
    lies before the clamped t0 keeps it, as in whisper.cpp)."""
    pg = pt.FullParams.default()
    pg.temperature_inc = 0.0
    pg.print_progress = False
    audios = [synthetic_audio(6, 30 + i) for i in range(4)]
    _, r, _ = run_batch("large_v3_batch4_greedy", ctx, pg, audios, n_lanes=4)
    single = runs["large_v3_greedy"]
    r["single_stream"] = {"audio_s_per_s": single["audio_s_per_s"],
                          "ms_per_step": single["ms_per_step"],
                          "encode_ms_per_window": single["encode_ms"] / single["windows"]}
    runs["large_v3_batch4_greedy"] = r
    log({"check": "(k) large-v3 bf16 full_batch 4 x 6 s greedy, 4 lanes", "ok": True,
         "rounds": r["rounds"], "lane_occupancy": r["lane_occupancy"],
         "encode_ms_per_round": r["encode_ms_per_round"],
         "ms_per_batched_step": r["ms_per_batched_step"], "rows_per_step": r["rows_per_step"],
         "audio_s_per_s": r["audio_s_per_s"], "single_stream": r["single_stream"]})

    pv = pt.FullParams.default()
    pv.temperature_inc = 0.0
    pv.print_progress = False
    pv.vad = True
    pv.vad_model_path = str(vad_path)
    pv.vad_params.threshold = vad_thr
    res, r, merged = run_batch("large_v3_parallel4_vad", ctx, pv, [bursts(12, 11)],
                               parallel=4)
    runs["large_v3_parallel4_vad"] = r
    final = [(s.t0, s.t1) for s in res[0]]
    starts_after = [b[0] >= a[1] for a, b in zip(merged, merged[1:])]
    ok = bool(merged) and len(merged) == len(final) and all(starts_after)
    log({"check": "(k) large-v3 full_parallel(4) with VAD: each merged segment starts "
                  "no earlier than the previous one ends", "ok": ok,
         "segments": len(final), "distinct_merged": sorted(set(merged))[:24],
         "distinct_remapped": sorted(set(final))[:24],
         "remapped_overlaps": sum(b[0] < a[1] for a, b in zip(final, final[1:]))})
    if not ok:
        raise AssertionError(f"(k) full_parallel: merged segments {sorted(set(merged))}")


def encode_profile(st) -> dict:
    """Where an encode's time goes: host wall ms per encode of the state's
    first window (after a warm-up encode, without the profiler), then the
    same encodes under torch.profiler. From that one profiled run: the
    device's busy ms per encode (the union of its kernels' intervals), the
    span from the first kernel's start to the last one's end, the idle
    share of that span, and the kernels that took the most device time.
    "not measured" where the profiler records no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reps = 3
    st.encode(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        st.encode(0)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            st.encode(0)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {"wall_ms": wall, "device_busy_ms": "not measured"}
    busy, start, end, by_name = 0.0, float("inf"), float("-inf"), {}
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        a, b = e.time_range.start, e.time_range.end
        start = min(start, a)
        if b > end:
            busy += b - max(a, end)
            end = b
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall, "device_busy_ms": busy / 1e3 / reps,
            "profiled_span_ms": (end - start) / 1e3 / reps, "idle_share": 1 - busy / (end - start),
            "kernels_per_encode": len(kernels) / reps,
            "top_kernels_ms": {name: us / 1e3 / reps for name, us in top}}


def segments(st):
    return [(s.text, s.t0, s.t1, [t.id for t in s.tokens]) for s in st.segments]


def token_segments(st):
    """Segments with every token's id, t0, t1 and t_dtw."""
    return [(s.text, s.t0, s.t1, [(t.id, t.t0, t.t1, t.t_dtw) for t in s.tokens])
            for s in st.segments]


# a grammar that compiles to the token DFA, and one over the DFA's budget
# (center recursion: unbounded stack depth), which runs the host loop
SMALL_GBNF = """\
root ::= item (ws item)*
ws   ::= " "
item ::= word | num
word ::= "the" | "and" | "ask" | "é"
num  ::= [0-9] [0-9]?
"""
RECURSIVE_GBNF = 'root ::= "(" root ")" | [a-z ]*\n'


def wav_roundtrip(audio, path: pathlib.Path):
    """`audio` (16 kHz mono float32) written as a 44.1 kHz stereo int16 WAV
    (the right channel at 0.8 of the left) and read back through the
    port's audio/io.read_wav, which downmixes it and resamples it to 16 kHz."""
    import wave
    import numpy as np
    from whisper_tpu_torch.audio import io
    x = io.resample_linear(audio, 16000, 44100)
    pcm = (np.clip(np.stack([x, 0.8 * x], 1), -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(44100)
        w.writeframes(pcm.tobytes())
    got, sr = io.read_wav(str(path))
    path.unlink()
    if sr != 16000 or abs(len(got) - len(audio)) > 2 or not np.isfinite(got).all():
        raise AssertionError(f"WAV round trip: {sr} Hz, {len(got)} samples of {len(audio)}")
    return got


def grammar_dfa_seconds(parsed, vocab):
    """Seconds to compile (or give up on) the token DFA of `parsed` for
    `vocab`, cached on `parsed` for the run that follows; and the DFA."""
    from whisper_tpu_torch.decoding.grammar_dfa import cached_dfa
    t0 = time.perf_counter()
    dfa = cached_dfa(parsed, vocab)
    return time.perf_counter() - t0, dfa


def phase_g(pt, build, runs):
    """(g) a tiny multilingual f32 ggml checkpoint, card against CPU, on
    12 s read back from a 44.1 kHz stereo WAV: language auto-detection,
    energy token timestamps and DTW (N_TOP_MOST), first with a grammar on
    the token DFA (device loop), then with a logits_filter_callback and a
    grammar over the DFA's budget (host loop on the card)."""
    from whisper_tpu_torch.config import AlignmentHeadsPreset, DtwParams
    from whisper_tpu_torch.decoding.grammar import parse_gbnf

    ckpt = build.BUILD_DIR / "chip_smoke_tiny_ml.bin"
    tiny_checkpoint(ckpt, n_vocab=51865)
    audio = wav_roundtrip(synthetic_audio(12, seed=5), build.BUILD_DIR / "chip_smoke.wav")
    cp = dict(dtype="float32", dtw_token_timestamps=True,
              dtw=DtwParams(mode=AlignmentHeadsPreset.N_TOP_MOST))
    ctxs = {"card": pt.WhisperContext.new_with_params(str(ckpt), pt.ContextParams(**cp)),
            "cpu": pt.WhisperContext.new_with_params(
                str(ckpt), pt.ContextParams(**cp, use_gpu=False))}
    ckpt.unlink()
    if not ctxs["card"].hparams.is_multilingual:
        raise AssertionError("(g): the tiny checkpoint is not multilingual")
    calls = {"card": 0, "cpu": 0}

    def banning(where):
        def cb(ctx, state, tokens, logits):      # the raw logits, float32 (n_vocab,)
            calls[where] += 1
            logits[ord("x")] = float("-inf")
        return cb

    out = {}
    for run, text, host in (("tiny_ml_auto_dtw_grammar_dfa", SMALL_GBNF, False),
                            ("tiny_ml_auto_dtw_callback_host", RECURSIVE_GBNF, True)):
        got = {}
        for where, ctx in ctxs.items():
            p = pt.FullParams.default()
            p.temperature_inc = 0.0
            p.print_progress = False
            p.max_tokens = 12                    # the decisive config
            p.no_timestamps = True
            p.suppress_regex = r"<syn\d\d\d+>"
            p.language = "auto"
            p.token_timestamps = True
            p.grammar_rules = parse_gbnf(text)
            compile_s, dfa = grammar_dfa_seconds(p.grammar_rules, ctx.vocab)
            if (dfa is None) != host:
                raise AssertionError(f"{run}: DFA {'none' if dfa is None else dfa.n_states}")
            if host:
                p.logits_filter_callback = banning(where)
            if where == "card":
                st, runs[run] = run_full(run, ctx, p, audio)
                loops = runs[run]["loops"]
                if set(loops) != {"host" if host else "device"}:
                    raise AssertionError(f"{run}: windows decoded by {loops}")
                runs[run]["dfa_compile_s"] = compile_s
                runs[run]["dfa_states"] = None if dfa is None else dfa.n_states
            else:
                st = ctx.create_state()
                st.full(p, audio)
            got[where] = (st.full_lang_id(), token_segments(st))
        same = got["card"] == got["cpu"]
        stamped = sum(t[3] >= 0 for s in got["card"][1] for t in s[3])
        out[run] = same
        log({"check": f"(g) {run}: card segments, token t0/t1/t_dtw and lang id "
                      f"== CPU's", "ok": same, "lang_id": got["card"][0],
             "dtw_stamped_tokens": stamped, "dfa_compile_s": runs[run]["dfa_compile_s"],
             "callback_calls": dict(calls)})
        if not same or not stamped:
            raise AssertionError(f"(g) {run}: card {got['card']} != CPU {got['cpu']}")
    if not calls["card"] or calls["card"] != calls["cpu"]:
        raise AssertionError(f"(g): callback calls {calls}")
    return out


def check_dtw_windows(name, dtw_windows):
    """Every window's stamped t_dtw are non-decreasing and inside the
    window [seek, seek + n_frames)."""
    n = 0
    for seek, n_frames, toks in dtw_windows:
        stamps = [t.t_dtw for t in toks]
        if (any(b < a for a, b in zip(stamps, stamps[1:]))
                or any(not seek <= d < seek + n_frames for d in stamps)):
            raise AssertionError(f"{name}: t_dtw {stamps} in window {seek}+{n_frames}")
        n += len(stamps)
    if not dtw_windows or not n:
        raise AssertionError(f"{name}: no DTW window or no stamped token")
    return n


def phase_h(pt, ctx, runs):
    """(h) large-v3 bf16: lang_detect() timed, then greedy full() on 6 s
    with language auto-detection, the energy timestamps and DTW with the
    LARGE_V3 alignment heads."""
    import statistics as stats
    import torch
    from whisper_tpu_torch.config import AlignmentHeadsPreset, DtwParams

    audio = synthetic_audio(6, 6)
    st = ctx.create_state()
    st.pcm_to_mel(audio)
    st.lang_detect(0)                               # warm-up
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lang_id, probs = st.lang_detect(0)
        times.append((time.perf_counter() - t0) * 1e3)
    log({"lang_detect": "large_v3", "ms": stats.median(times), "ms_all": times,
         "lang_id": lang_id, "p_max": float(probs.max())})
    ctx.cparams.dtw_token_timestamps = True
    ctx.cparams.dtw = DtwParams(mode=AlignmentHeadsPreset.LARGE_V3)
    try:
        p = pt.FullParams.default()
        p.temperature_inc = 0.0
        p.print_progress = False
        p.language = "auto"
        p.token_timestamps = True
        st, runs["large_v3_auto_dtw"] = run_full("large_v3_auto_dtw", ctx, p, audio)
    finally:
        ctx.cparams.dtw_token_timestamps = False
        ctx.cparams.dtw = DtwParams()
    r = runs["large_v3_auto_dtw"]
    stamped = check_dtw_windows("(h)", st.smoke["dtw_windows"])
    r.update(lang_detect_ms=stats.median(times), dtw_stamped_tokens=stamped,
             dtw_ms_per_window=r["dtw_ms"] / r["dtw_calls"],
             energy_ms_per_run=r["energy_ms"])
    log({"check": "(h) t_dtw non-decreasing inside each window", "ok": True,
         "dtw_windows": r["dtw_calls"], "stamped": stamped,
         "dtw_ms_per_window": r["dtw_ms_per_window"], "energy_ms": r["energy_ms"],
         "lang_detect_ms": r["lang_detect_ms"]})


def phase_i(pt, ctx, runs):
    """(i) large-v3 bf16, greedy, max_tokens 32 on 6 s: the device loop
    alone, with a grammar on the token DFA, and with a
    logits_filter_callback on the host loop; the Python grammar machine
    must accept every text token the grammar run emitted."""
    from whisper_tpu_torch.decoding.grammar import parse_gbnf

    audio = synthetic_audio(6, 7)

    def params():
        p = pt.FullParams.default()
        p.temperature_inc = 0.0
        p.print_progress = False
        p.max_tokens = 32
        # one window of 32 steps: no timestamps, and end-of-text suppressed
        # (the grammar penalizes text tokens only, so the random weights
        # would otherwise end the window early)
        p.no_timestamps = True
        p.suppress_regex = r"\[_EOT_\]"
        return p

    _, runs["large_v3_greedy_32"] = run_full("large_v3_greedy_32", ctx, params(), audio)
    p = params()
    p.grammar_rules = parse_gbnf(SMALL_GBNF)
    compile_s, dfa = grammar_dfa_seconds(p.grammar_rules, ctx.vocab)
    if dfa is None:
        raise AssertionError("(i): the small grammar did not compile to a DFA")
    st, runs["large_v3_grammar_dfa"] = run_full("large_v3_grammar_dfa", ctx, p, audio)
    runs["large_v3_grammar_dfa"].update(dfa_compile_s=compile_s, dfa_states=dfa.n_states)
    eot, n_checked = ctx.vocab.token_eot, 0
    for r in st.smoke["results"]:
        g = p.grammar_rules.instance()
        for tok in r.tokens[0, : r.result_len[0]]:
            if tok < eot:
                if int(tok) in set(g.rejected_tokens(ctx.vocab)):
                    raise AssertionError(f"(i): grammar rejects emitted token {tok}")
                n_checked += 1
            g.accept_token(ctx.vocab, int(tok))
    if not n_checked:
        raise AssertionError("(i): the grammar run emitted no text token")
    p = params()
    seen = [0]

    def callback(ctx_, state, tokens, logits):
        seen[0] += 1

    p.logits_filter_callback = callback
    _, runs["large_v3_callback_host"] = run_full("large_v3_callback_host", ctx, p, audio)
    dev = runs["large_v3_greedy_32"]["loops"]["device"]
    host = runs["large_v3_callback_host"]["loops"]["host"]
    log({"check": "(i) grammar machine accepts every emitted text token", "ok": True,
         "tokens_checked": n_checked, "dfa_compile_s": compile_s, "dfa_states": dfa.n_states,
         "callback_calls": seen[0],
         "host_loop_ms_per_step": host["ms_per_step"],
         "device_loop_ms_per_step": dev["ms_per_step"],
         "grammar_dfa_ms_per_step": runs["large_v3_grammar_dfa"]["loops"]["device"][
             "ms_per_step"]})
    if not seen[0]:
        raise AssertionError("(i): the callback was never called")


def sharpened(ctx, scale: float = 8.0):
    """Scale ctx's decoder token embedding (input and output projection)
    by `scale`, on a copy, so that argmaxes are decisive between the T = 1
    and T = k forwards; returns the original to restore."""
    dec = ctx.params["decoder"]
    orig = dec["token_embed"]
    dec["token_embed"] = orig * scale
    return orig


def spec_summary(name, r, vanilla=None):
    """The speculative figures of a run_full report: tokens, rounds,
    tokens per round, ms per emitted token (beside the vanilla run's ms
    per step), ms per draft step and per verify chunk, kernel launches."""
    stats = r["spec_stats"] or {"rounds": 0, "tokens": 0}
    spec = r["loops"].get("spec", {})
    calls = r["decoder_call_ms"]
    step = calls.get("draft.step") or calls.get("main.step") or {}
    out = {"spec_run": name, "tokens": stats["tokens"], "rounds": stats["rounds"],
           "tokens_per_round": stats["tokens"] / max(1, stats["rounds"]),
           "ms_per_emitted_token": spec.get("ms_per_step"),
           "ms_per_draft_step": step.get("ms_each"),
           "ms_per_verify": calls.get("main.chunk", {}).get("ms_each"),
           "launches": r["launches"], "launches_expected": r["launches_expected"]}
    if vanilla is not None:
        out["vanilla_ms_per_step"] = vanilla["loops"]["device"]["ms_per_step"]
        out["vanilla_tokens"] = vanilla["loops"]["device"]["steps"]
    log(out)
    r["spec"] = out
    return out


def window_streams(st):
    """Every window decode's emitted tokens, in order."""
    return [r.tokens[0, : int(r.n_tokens)].tolist() for r in st.smoke["results"]]


def phase_l_tiny(pt, runs):
    """(l1) speculative full() on a tiny f32 model (token embedding
    sharpened x 8) with another seed's draft, k = 1, 4 and 8: the card's
    segments equal the same model's vanilla full() on the card and the
    speculative full() on the CPU."""
    from whisper_tpu_torch.config import WhisperHParams
    hp = WhisperHParams(**TINY_HP)
    audio = synthetic_audio(8, 11)
    p = pt.FullParams.default()
    p.temperature_inc = 0.0
    p.print_progress = False
    p.no_timestamps = True
    p.max_tokens = 24
    ctxs = {}
    for where in ("card", "cpu"):
        cp = pt.ContextParams(dtype="float32", use_gpu=where == "card")
        main, draft = (pt.WhisperContext.random(hp=hp, seed=s, params=cp) for s in (0, 123))
        for c in (main, draft):
            sharpened(c)
        ctxs[where] = main, draft
    main, draft = ctxs["card"]
    st, runs["tiny_f32_sharp_vanilla"] = run_full("tiny_f32_sharp_vanilla", main, p, audio)
    base = segments(st)
    for k in (1, 4, 8):
        got = {}
        for where, (m, d) in ctxs.items():
            m.cparams.spec_k = k
            m.attach_draft(d)
            try:
                if where == "card":
                    name = f"tiny_f32_sharp_spec_k{k}"
                    st, runs[name] = run_full(name, m, p, audio, time_calls=True)
                    spec_summary(name, runs[name])
                else:
                    st = m.create_state()
                    st.full(p, audio)
            finally:
                m.draft = None
            got[where] = segments(st)
        ok = got["card"] == base == got["cpu"]
        log({"check": f"(l1) tiny spec k={k}: card == card vanilla == CPU spec", "ok": ok})
        if not ok:
            raise AssertionError(f"(l1) k={k}: card {got['card']} vanilla {base} "
                                 f"CPU {got['cpu']}")


def first_divergence(ctx, van_st, spec_st):
    """The first (window, step) where two runs' streams differ, and the
    top-2 margin of the main model's raw logits there (the vanilla window's
    prompt and tokens up to that step in one prompt pass)."""
    import torch
    from whisper_tpu_torch.models import whisper as model_mod
    for w, (a, b) in enumerate(zip(window_streams(van_st), window_streams(spec_st))):
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None and len(a) != len(b):
            j = min(len(a), len(b))
        if j is None:
            continue
        prompt, plen, ck, cv = van_st.smoke["args"][w]
        toks = torch.tensor([list(prompt[:plen]) + a[:j]], device=ctx.device)
        kv = model_mod.KVCache.zeros(ctx.hparams, 1, ctx.dtype, ctx.device, quant=ctx.kv_quant)
        logits, _, _ = model_mod.decoder_forward(ctx.params, ctx.hparams, toks, 0, kv, ck, cv,
                                                 ctx.dtype, logit_rows=toks.shape[1] - 1)
        top = logits[0, 0].float().topk(2).values
        return {"window": w, "step": j, "vanilla_token": a[j] if j < len(a) else None,
                "spec_token": b[j] if j < len(b) else None,
                "top2_logit_margin": float(top[0] - top[1])}
    return None


def phase_l_large(pt, runs, ctx):
    """(l2) large-v3 bf16 with its token embedding sharpened x 8 (restored
    after): vanilla greedy on 6 s without timestamps (one window of at most
    97 tokens), a self-draft (the context as its own
    draft, its encoder run again as the draft's) at k = 8, and a
    distil-large-v3-shaped draft (large-v3's encoder, shared, and 2
    decoder layers copied from the main model's first and last, as
    distil-whisper initialises its student). The self-draft's streams
    must equal vanilla's; where bf16 rounding between the T = 1 and T = k
    forwards flips a token, the first divergence and its top-2 logit
    margin are printed and the equality is checked in float32."""
    from whisper_tpu_torch.checkpoint.loader import LoadedModel
    audio = synthetic_audio(6, 1)
    p = pt.FullParams.default()
    p.temperature_inc = 0.0
    p.print_progress = False
    p.no_timestamps = True           # one window, one segment of up to 97 tokens
    p.max_tokens = 96                # (the random weights never end a window)
    orig = sharpened(ctx)
    try:
        ok, runs_l = check_self_draft(pt, ctx, p, audio, runs, "large_v3_sharp")
        if not ok:
            ctx32 = pt.WhisperContext(LoadedModel(ctx.hparams, ctx.params, ctx.mel_filters,
                                                  ctx.vocab, ctx.n_loaded),
                                      pt.ContextParams(dtype="float32"))
            ok, _ = check_self_draft(pt, ctx32, p, audio, runs, "large_v3_sharp_f32")
            del ctx32
            if not ok:
                raise AssertionError("(l2) the self-draft's stream differs from vanilla's "
                                     "in float32 too")
        vanilla = runs_l[0]
        hp_d = dataclasses.replace(ctx.hparams, n_text_layer=2)
        dec = ctx.params["decoder"]
        params_d = {"encoder": ctx.params["encoder"],
                    "decoder": {**dec, "blocks": [dec["blocks"][0], dec["blocks"][-1]]}}
        distil = pt.WhisperContext(LoadedModel(hp_d, params_d, ctx.mel_filters, ctx.vocab,
                                               ctx.n_loaded), pt.ContextParams())
        ctx.cparams.draft_shares_encoder = True
        ctx.attach_draft(distil)
        try:
            st, runs["large_v3_sharp_spec_distil"] = run_full(
                "large_v3_sharp_spec_distil", ctx, p, audio, time_calls=True)
        finally:
            ctx.draft = None
            ctx.cparams.draft_shares_encoder = False
        spec_summary("large_v3_sharp_spec_distil", runs["large_v3_sharp_spec_distil"], vanilla)
        if st.draft_mel is not None or not runs["large_v3_sharp_spec_distil"]["spec_stats"]:
            raise AssertionError("(l2) distil draft: a draft mel, or no speculation")
    finally:
        ctx.params["decoder"]["token_embed"] = orig


def check_self_draft(pt, ctx, p, audio, runs, prefix):
    """Vanilla greedy and a self-draft at k = 8 on ctx; (equal, (vanilla
    report, self-draft report)), the first divergence printed if any."""
    st_v, r_v = run_full(f"{prefix}_vanilla", ctx, p, audio, time_calls=True, keep_args=True)
    ctx.attach_draft(ctx)
    try:
        st_s, r_s = run_full(f"{prefix}_spec_self", ctx, p, audio, time_calls=True)
    finally:
        ctx.draft = None
    runs[f"{prefix}_vanilla"], runs[f"{prefix}_spec_self"] = r_v, r_s
    spec_summary(f"{prefix}_spec_self", r_s, r_v)
    ok = window_streams(st_v) == window_streams(st_s) and segments(st_v) == segments(st_s)
    log({"check": f"(l2) {prefix}: self-draft stream == vanilla stream", "ok": ok,
         "first_divergence": None if ok else first_divergence(ctx, st_v, st_s)})
    return ok, (r_v, r_s)


def phase_l_q5_0(pt, runs, ctx, audio):
    """(l3) the Q5_0 + int8 KV context of (e), on (e)'s audio, one window
    of 33 tokens (no timestamps, max_tokens 32): vanilla, then as its own
    draft at k = 8, whose verify chunk runs B2's skinny path at M = 8 and
    the plain cross-attention (int8 cross K/V). The streams' equality is
    reported: the weights are not sharpened."""
    p = pt.FullParams.default()
    p.temperature_inc = 0.0
    p.print_progress = False
    p.no_timestamps = True
    p.max_tokens = 32
    st_v, r_v = run_full("large_v3_q5_0_int8kv_vanilla_32", ctx, p, audio, time_calls=True)
    runs["large_v3_q5_0_int8kv_vanilla_32"] = r_v
    ctx.attach_draft(ctx)
    try:
        st, runs["large_v3_q5_0_int8kv_spec_self"] = run_full(
            "large_v3_q5_0_int8kv_spec_self", ctx, p, audio, time_calls=True)
    finally:
        ctx.draft = None
    r = runs["large_v3_q5_0_int8kv_spec_self"]
    spec_summary("large_v3_q5_0_int8kv_spec_self", r, r_v)
    log({"check": "(l3) q5_0 + int8 KV self-draft stream == vanilla stream (reported)",
         "equal": window_streams(st) == window_streams(st_v)})
    if not r["spec_stats"] or r["launches"]["quant_matmul"] == 0:
        raise AssertionError("(l3): no speculation or no B2 launch")


def phase_n(pt):
    """(n) the host C++ runtime: it must have built and loaded; the DTW
    path at three sizes, the signal energy on 30 s, the dequantization of
    a 1280 x 5120 Q5_0 tensor and the token-DFA compile of (g)'s grammar,
    each native against the Python path (equal paths, equal bits; the
    energy within 1e-6 relative: float64 prefix sums against numpy's
    float32 convolution)."""
    import contextlib
    import numpy as np
    from whisper_tpu_torch.checkpoint import quant
    from whisper_tpu_torch.decoding import dtw, timestamps
    from whisper_tpu_torch.decoding.grammar import parse_gbnf
    from whisper_tpu_torch.decoding.grammar_dfa import compile_token_dfa
    from whisper_tpu_torch.runtime import native
    from whisper_tpu_torch.tokenizer import synthetic_vocab

    if not native.available():
        raise AssertionError("(n): the host runtime did not build or load")

    @contextlib.contextmanager
    def python_path():
        saved = native.get_lib
        native.get_lib = lambda: None
        try:
            yield
        finally:
            native.get_lib = saved

    def timed(fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        return out, (time.perf_counter() - t0) * 1e3

    rng = np.random.default_rng(0)
    report = {"native_available": True, "dtw": {}}
    for n, m in ((40, 85), (200, 750), (448, 1500)):
        x = rng.standard_normal((n, m)).astype(np.float32)
        nat, ms_n = timed(dtw.dtw_path, x)
        with python_path():
            py, ms_p = timed(dtw.dtw_path, x.astype(np.float64))
        if not all(np.array_equal(a, b) for a, b in zip(nat, py)):
            raise AssertionError(f"(n): DTW paths differ at {n} x {m}")
        report["dtw"][f"{n}x{m}"] = {"native_ms": ms_n, "python_ms": ms_p}
    x = rng.standard_normal(30 * 16000).astype(np.float32)
    nat, ms_n = timed(timestamps.get_signal_energy, x, 32)
    with python_path():
        py, ms_p = timed(timestamps.get_signal_energy, x, 32)
    rel = float(np.max(np.abs(nat - py) / np.maximum(np.abs(py), 1e-30)))
    if rel > 1e-6:
        raise AssertionError(f"(n): signal energy differs by {rel} relative")
    report["energy_30s"] = {"native_ms": ms_n, "python_ms": ms_p, "max_rel_diff": rel,
                            "bit_equal": nat.tobytes() == py.tobytes()}
    w = (rng.standard_normal(1280 * 5120) * 0.02).astype(np.float32)
    raw = quant.quantize(w, quant.GGML_TYPE_Q5_0)
    nat, ms_n = timed(quant.dequantize, raw, quant.GGML_TYPE_Q5_0, w.size)
    with python_path():
        py, ms_p = timed(quant.dequantize, raw, quant.GGML_TYPE_Q5_0, w.size)
    if nat.tobytes() != py.tobytes():
        raise AssertionError("(n): Q5_0 dequantization differs")
    report["dequantize_q5_0_1280x5120"] = {"native_ms": ms_n, "python_ms": ms_p}
    vocab = synthetic_vocab(51866)
    dfa_n, s_n = timed(compile_token_dfa, parse_gbnf(SMALL_GBNF), vocab)
    with python_path():
        dfa_p, s_p = timed(compile_token_dfa, parse_gbnf(SMALL_GBNF), vocab)
    if not (np.array_equal(dfa_n.reject, dfa_p.reject)
            and np.array_equal(dfa_n.trans, dfa_p.trans)):
        raise AssertionError("(n): the token DFA differs between the two engines")
    report["dfa_compile"] = {"native_s": s_n / 1e3, "python_s": s_p / 1e3,
                             "states": dfa_n.n_states}
    log({"phase_n": report})
    return report


# ---- (o) serving: the HTTP server, the CLI and its writers, stream, LSP


def multipart(fields) -> tuple:
    """A multipart/form-data body (bytes values as they are) and its
    content type."""
    boundary = "chipsmokeboundary"
    body = b""
    for name, value in fields.items():
        body += (f"--{boundary}\r\nContent-Disposition: form-data; "
                 f'name="{name}"\r\n\r\n').encode()
        body += value if isinstance(value, bytes) else str(value).encode()
        body += b"\r\n"
    return body + f"--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


def http(url, data=None, ctype=None) -> tuple:
    """(status, content type, body) of one request to a served URL."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": ctype} if ctype else {})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


class Served:
    """serve() on a free local port, answering on a thread until close()."""

    def __init__(self, server_mod, path, cparams, **kw):
        import threading
        self.httpd = server_mod.serve(str(path) if path else None, "127.0.0.1", 0,
                                      cparams=cparams, **kw)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=60)


def same_response(want, got) -> bool:
    """Equal status, content type and body; verbose_json's no_speech_prob
    within 1e-4 (float32 reductions in another order on the card)."""
    if want[:2] != got[:2]:
        return False
    if b'"no_speech_prob"' not in want[2]:
        return want[2] == got[2]
    jd, gd = json.loads(want[2]), json.loads(got[2])
    jp = [s.pop("no_speech_prob") for s in jd["segments"]]
    gp = [s.pop("no_speech_prob") for s in gd["segments"]]
    return jd == gd and all(abs(a - b) <= 1e-4 for a, b in zip(jp, gp))


class launch_counts:
    """The kernels' launches inside a with block, as a dict: flash
    attention (B1), quant_matmul (B2), quant_matmul_offset (B3), and B2/B3
    split by path: qmm_skinny (M <= 16; the wrapper plans each skinny
    launch once, with plan_skinny) and qmm_wide (the rest)."""

    def __enter__(self):
        import torch
        from whisper_tpu_torch.ops import quant_matmul as qmm_mod
        from whisper_tpu_torch.ops.flash_attention import flash_attention
        self.mod, self.fa, self.plan, self.skinny = qmm_mod, flash_attention, \
            qmm_mod.plan_skinny, 0

        def counted(*a, **k):
            self.skinny += 1
            return self.plan(*a, **k)
        torch.cuda.synchronize()
        flash_attention.launches = 0
        qmm_mod.quant_matmul.launches = qmm_mod.quant_matmul.launches_offset = 0
        qmm_mod.plan_skinny = counted
        self.counts = {}
        return self.counts

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self.mod.plan_skinny = self.plan
        qmm = self.mod.quant_matmul
        self.counts.update({"flash_attention": self.fa.launches,
                            "quant_matmul": qmm.launches,
                            "quant_matmul_offset": qmm.launches_offset,
                            "qmm_skinny": self.skinny,
                            "qmm_wide": qmm.launches + qmm.launches_offset - self.skinny})


def phase_o_tiny(pt, build, runs):
    """(o1) the served path on a tiny f32 checkpoint, card against CPU: serve() twice, the same /inference requests (each
    response format, greedy and beam-5), /health and /load to both; the
    bodies equal (verbose_json's no_speech_prob within 1e-4). cli.main
    with -otxt -osrt -ovtt -oj -ocsv on the card and with -ng (both in
    float32, the CLI's default bf16 replaced for the comparison): equal
    files. A StreamTranscriber (sliding window) and LspServer.handle on
    the card's and the CPU's context: equal events and responses. Then
    cli.main --profile-dir in the CLI's default bf16: the Chrome trace
    names attn_tc."""
    import base64
    import dataclasses
    from whisper_tpu_torch.audio.io import write_wav
    from whisper_tpu_torch.checkpoint.init import random_params
    from whisper_tpu_torch.config import WhisperHParams
    from whisper_tpu_torch.serving import cli, lsp, server, stream

    hp = WhisperHParams(**TINY_HP)
    params = random_params(hp, seed=1, compute_dtype="float32")
    work = build.BUILD_DIR / "chip_smoke_served"
    shutil.rmtree(work, ignore_errors=True)        # nothing of an earlier run
    work.mkdir()
    ckpt = work / "tiny.bin"
    write_checkpoint(ckpt, hp, params)
    wavs = []
    for i, sec in enumerate((2, 3, 4)):
        wavs.append(work / f"o{i}.wav")
        write_wav(str(wavs[-1]), synthetic_audio(sec, 60 + i))
    wav_bytes = wavs[1].read_bytes()
    requests = [("/inference", *multipart({"file": wav_bytes, "temperature_inc": "0.0",
                                           "response_format": fmt}))
                for fmt in ("json", "text", "srt", "vtt", "verbose_json")]
    requests += [("/inference", *multipart({"file": wav_bytes, "temperature_inc": "0.0",
                                            "beam_size": "5"})),
                 ("/health", None, None),
                 ("/load", json.dumps({"model": str(ckpt)}).encode(), "application/json"),
                 ("/inference", *multipart({"file": wav_bytes, "temperature_inc": "0.0",
                                            "response_format": "verbose_json"}))]
    served = {where: Served(server, ckpt, pt.ContextParams(dtype="float32",
                                                           use_gpu=where == "card"))
              for where in ("card", "cpu")}
    try:
        out = {}
        for where, s in served.items():
            t0 = time.perf_counter()
            with launch_counts() as counts:
                out[where] = [http(s.url + path, data, ctype) for path, data, ctype in requests]
            out[where + "_s"] = time.perf_counter() - t0
            out[where + "_launches"] = counts
        same = [same_response(w, g) for w, g in zip(out["cpu"], out["card"])]
        ok = all(same) and all(r[0] == 200 for r in out["cpu"]) and \
            json.loads(out["cpu"][0][2])["text"] != ""
        runs["served_tiny_f32"] = {"launches": out["card_launches"], "wall_s": out["card_s"],
                                   "requests": len(requests)}
        log({"check": "(o1) tiny f32 served: card bodies == CPU bodies (each format, "
                      "greedy and beam-5, /health, /load)", "ok": ok, "same": same,
             "card_s": out["card_s"], "cpu_s": out["cpu_s"],
             "launches": out["card_launches"],
             "json_body": out["card"][0][2].decode()[:80]})
        if not ok or out["card_launches"]["flash_attention"] == 0:
            raise AssertionError(f"(o1) served bodies differ: {same}")

        ctxs = {where: s.httpd.whisper_state.ctx for where, s in served.items()}
        pcm = (synthetic_audio(1.5, 64) * 32767).astype("<i2")
        b64 = base64.b64encode(pcm.tobytes()).decode()
        lsp_reqs = [{"jsonrpc": "2.0", "id": 1, "method": "registerCommandset",
                     "params": {"commands": ["lights on", "lights off"]}},
                    {"jsonrpc": "2.0", "id": 2, "method": "unguided",
                     "params": {"pcm_base64": b64}},
                    {"jsonrpc": "2.0", "id": 3, "method": "unguided",
                     "params": {"wav_path": str(wavs[0]), "no_timestamps": False}},
                    {"jsonrpc": "2.0", "id": 4, "method": "guided",
                     "params": {"pcm_base64": b64, "commandset_index": 0}}]
        audio = synthetic_audio(4, 65)
        got = {}
        for where, ctx in ctxs.items():
            events = []
            st = stream.StreamTranscriber(
                ctx, stream.StreamParams(step_ms=1000, length_ms=3000, keep_ms=200),
                on_segment=lambda t, c, events=events: events.append((t, c)))
            with launch_counts() as counts:
                for i in range(0, len(audio), 8000):
                    st.feed(audio[i:i + 8000])
                st.flush()
                srv = lsp.LspServer(ctx)
                answers = [srv.handle(r) for r in lsp_reqs]
            got[where] = (events, st.committed, answers, counts)
        ok = got["card"][:3] == got["cpu"][:3] and bool(got["card"][0])
        ok = ok and not any("error" in a for a in got["card"][2])
        runs["served_tiny_stream_lsp"] = {"launches": got["card"][3]}
        log({"check": "(o1) tiny f32 StreamTranscriber events and LspServer answers: "
                      "card == CPU", "ok": ok, "events": len(got["card"][0]),
             "committed": got["card"][1][:4], "launches": got["card"][3]})
        if not ok:
            raise AssertionError(f"(o1) stream / LSP: card {got['card'][:3]} "
                                 f"!= CPU {got['cpu'][:3]}")
    finally:
        for s in served.values():
            s.close()

    # the CLI: card against -ng in float32, then profiled in its default bf16
    orig = pt.WhisperContext.new_with_params.__func__

    def float32(cls, path, params=None):
        return orig(cls, path, dataclasses.replace(params or pt.ContextParams(),
                                                   dtype="float32"))
    exts = ("txt", "srt", "vtt", "json", "csv")
    files = {}
    pt.WhisperContext.new_with_params = classmethod(float32)
    try:
        for where, ng in (("card", []), ("cpu", ["-ng"])):
            base = work / f"cli_{where}"
            with launch_counts() as counts:
                rc = cli.main(["-m", str(ckpt), "-f", str(wavs[2]), "-otxt", "-osrt", "-ovtt",
                               "-oj", "-ocsv", "-nf", "-np", "-of", str(base), *ng])
            if rc != 0:
                raise AssertionError(f"(o1) cli.main on the {where}: exit code {rc}")
            files[where] = {e: pathlib.Path(f"{base}.{e}").read_bytes() for e in exts}
            if where == "card":
                runs["served_cli_f32"] = {"launches": counts}
    finally:
        pt.WhisperContext.new_with_params = classmethod(orig)
    same = {e: files["card"][e] == files["cpu"][e] for e in exts}
    ok = all(same.values()) and bool(files["card"]["txt"])
    log({"check": "(o1) cli.main -otxt -osrt -ovtt -oj -ocsv: card files == -ng files",
         "ok": ok, "same": same, "launches": runs["served_cli_f32"]["launches"],
         "txt": files["card"]["txt"].decode()[:80]})
    if not ok:
        raise AssertionError(f"(o1) CLI files differ: {same}")

    prof = work / "profile"
    t0 = time.perf_counter()
    with launch_counts() as counts:
        rc = cli.main(["-m", str(ckpt), "-f", str(wavs[2]), "-otxt", "-nf", "-np",
                       "-of", str(work / "cli_profiled"), "--profile-dir", str(prof)])
    traces = sorted(prof.glob("*.json"))
    named = [t.name for t in traces if "attn_tc" in t.read_text()]
    ok = rc == 0 and len(traces) == 1 and bool(named) and counts["flash_attention"] > 0
    runs["served_cli_profiled_bf16"] = {"launches": counts}
    log({"check": "(o1) cli.main --profile-dir (bf16): the Chrome trace names attn_tc",
         "ok": ok, "traces": [t.name for t in traces],
         "trace_mb": sum(t.stat().st_size for t in traces) / 2 ** 20,
         "seconds": time.perf_counter() - t0, "launches": counts})
    if not ok:
        raise AssertionError(f"(o1) profiled CLI: rc {rc}, traces {traces}, named {named}")
    shutil.rmtree(work)


def phase_o_large(pt, runs, ckpt, seconds: float = 1.0):
    """(o2) the served path at full width: serve() on large-v3 Q5_0 with
    keep_quantized and the int8 KV cache (the file of (e)). One request
    alone takes the lock path (no dispatcher yet): its text equals
    state.full on the server's own context with the FullParams that
    _params_from_fields makes from the same fields. Then the dispatcher
    (batch window 2 s, max_batch 4) takes 4 concurrent requests, staggered
    so their order is known: /health shows one batch of 4 rows, and each
    text equals ctx.full_batch of the same audios in that order at
    n_lanes = 4. Per request: wall, audio-s per s through HTTP; per run:
    each kernel's launches, B1 and B2's wide and skinny paths each at
    least once."""
    import concurrent.futures
    from whisper_tpu_torch.audio.io import read_wav, write_wav
    from whisper_tpu_torch.serving import server

    work = ckpt.parent / "chip_smoke_served_large"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    wavs = []
    for i in range(5):
        wavs.append(work / f"r{i}.wav")
        write_wav(str(wavs[-1]), synthetic_audio(seconds, 70 + i))
    fields = {"temperature_inc": "0.0", "response_format": "json"}

    def params():
        p = server._params_from_fields({k: v.encode() for k, v in fields.items()})
        p.token_timestamps = False            # as the handler sets it for "json"
        return p

    def post(url, path):
        body, ctype = multipart({"file": path.read_bytes(), **fields})
        t0 = time.perf_counter()
        res = http(url + "/inference", body, ctype)
        return res, time.perf_counter() - t0

    def check_kernels(name, counts):
        if min(counts["flash_attention"], counts["qmm_wide"], counts["qmm_skinny"]) == 0:
            raise AssertionError(f"(o2) {name}: B1 or a B2 path was never launched: {counts}")

    t0 = time.perf_counter()
    s = Served(server, ckpt, pt.ContextParams(keep_quantized=True, kv_dtype="int8"))
    load_s = time.perf_counter() - t0
    try:
        ctx = s.httpd.whisper_state.ctx
        with launch_counts() as counts:
            res, wall = post(s.url, wavs[0])
        text = json.loads(res[2])["text"] if res[0] == 200 else None
        st = ctx.create_state()
        st.full(params(), read_wav(str(wavs[0]))[0])
        want = "".join(seg.text for seg in st.segments)
        runs["served_large_v3_q5_0_lock"] = {"launches": counts, "wall_s": wall,
                                             "audio_s_per_s": seconds / wall}
        log({"check": "(o2) large-v3 q5_0 + int8 KV served, lock path: text == state.full "
                      "on the server's context", "ok": text == want, "load_s": load_s,
             "wall_s": wall, "audio_s": seconds, "audio_s_per_s": seconds / wall,
             "launches": counts, "text_head": (text or "")[:60]})
        if text != want:
            raise AssertionError(f"(o2) lock path: {res} != state.full {want!r}")
        check_kernels("lock path", counts)

        state = s.httpd.whisper_state
        state.dispatcher = server.BatchingDispatcher(state, 2000, max_batch=4)

        def staggered(i):
            time.sleep(0.2 * i)
            return post(s.url, wavs[1 + i])
        t0 = time.perf_counter()
        with launch_counts() as counts:
            with concurrent.futures.ThreadPoolExecutor(4) as ex:
                results = list(ex.map(staggered, range(4)))
        wall = time.perf_counter() - t0
        health = json.loads(http(s.url + "/health")[2])
        texts = [json.loads(r[2])["text"] if r[0] == 200 else None for r, _ in results]
        batched = ctx.full_batch(params(), [read_wav(str(w))[0] for w in wavs[1:]], n_lanes=4)
        want = ["".join(seg.text for seg in segs) for segs in batched]
        b = health.get("batching", {})
        one_batch = (b.get("batches"), b.get("rows"), b.get("max_rows")) == (1, 4, 4)
        runs["served_large_v3_q5_0_batch4"] = {"launches": counts, "wall_s": wall,
                                               "audio_s_per_s": 4 * seconds / wall}
        log({"check": "(o2) large-v3 q5_0 + int8 KV served, 4 concurrent requests: one "
                      "batch of 4 rows, texts == full_batch(n_lanes=4)",
             "ok": texts == want and one_batch, "health": health,
             "requests": [{"wall_s": w, "audio_s_per_s": seconds / w} for _, w in results],
             "wall_s": wall, "audio_s_per_s": 4 * seconds / wall, "launches": counts,
             "texts_head": [(t or "")[:40] for t in texts]})
        if texts != want or not one_batch:
            raise AssertionError(f"(o2) batched: {texts} != {want} or health {health}")
        check_kernels("batched", counts)
    finally:
        s.close()
        # the dispatcher's thread lives as long as the process and holds the
        # server's state: drop its context, so later phases find the card's
        # memory free
        s.httpd.whisper_state.ctx = None
        shutil.rmtree(work)


# ---- (p) the checkpoint tools and the mesh on the card


def trees_equal(a, b) -> bool:
    """Two parameter trees with the same structure and bit-equal leaves."""
    import torch
    if isinstance(a, dict):
        return set(a) == set(b) and all(trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(trees_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)


def phase_p_f16(pt, build, runs, ctx, audio):
    """(p1) the large-v3 random weights of (b) written as F16 to a ggml
    .bin (checkpoint/ggml_io.py) and to a GGUF (checkpoint/gguf.py): the two
    files load onto the card to bit-equal params, and their contexts give
    equal greedy streams on `audio` (decisive config)."""
    import dataclasses
    import torch
    from whisper_tpu_torch.audio.mel import mel_filterbank
    from whisper_tpu_torch.checkpoint import ggml_io, gguf, loader
    from whisper_tpu_torch.tokenizer import synthetic_vocab

    hp = dataclasses.replace(ctx.hparams, ftype=1)
    paths = {"bin": build.BUILD_DIR / "chip_smoke_large_v3_f16.bin",
             "gguf": build.BUILD_DIR / "chip_smoke_large_v3_f16.gguf"}
    t0 = time.perf_counter()
    tensors = ggml_tensors(ctx.params)
    args = (hp, mel_filterbank(hp.n_mels), synthetic_vocab(hp.n_vocab).id_to_token[:50256],
            tensors)
    ggml_io.write_ggml(str(paths["bin"]), *args)
    gguf.write_gguf(str(paths["gguf"]), *args)
    t_write = time.perf_counter() - t0
    del tensors, args
    models, load_s = {}, {}
    for kind, fn in (("bin", loader.load_model), ("gguf", gguf.load_model_gguf)):
        t0 = time.perf_counter()
        models[kind] = fn(str(paths[kind]), "bfloat16", False, ctx.device)
        torch.cuda.synchronize()
        load_s[kind] = time.perf_counter() - t0
    same_params = trees_equal(models["bin"].params, models["gguf"].params)
    p = decisive_params(pt)
    streams = {}
    for kind, model in models.items():
        c = pt.WhisperContext(model, pt.ContextParams())
        st, runs[f"large_v3_f16_{kind}"] = run_full(f"large_v3_f16_{kind}", c, p, audio)
        streams[kind] = segments(st)
        del c, st
    log({"check": "(p1) large-v3 F16 .bin == .gguf: params bit-equal, streams equal",
         "params_equal": same_params, "streams_equal": streams["bin"] == streams["gguf"],
         "write_s": t_write, "load_s": load_s,
         "file_gib": {k: v.stat().st_size / 2 ** 30 for k, v in paths.items()}})
    for path in paths.values():
        path.unlink()
    if not same_params or streams["bin"] != streams["gguf"]:
        raise AssertionError("(p1) the F16 .bin and .gguf disagree")


def phase_p_cache(pt, build, runs, ckpt, audio):
    """(p1) the native cache of (e)'s large-v3 Q5_0 file: the first
    load_model_cached parses the .bin and writes the cache, the second reads
    the cache (both timed); the params must be bit-equal, and keep_quantized
    + int8 KV contexts of the two give the same greedy stream on `audio`
    (bounded_params).
    Returns the cached context and the cache directory."""
    import torch
    from whisper_tpu_torch.checkpoint import native_cache

    cache = build.BUILD_DIR / "chip_smoke_large_v3_q5_0.cache"
    shutil.rmtree(cache, ignore_errors=True)
    loads, models = {}, {}
    for kind in ("parsed", "cached"):
        t0 = time.perf_counter()
        models[kind] = native_cache.load_model_cached(str(ckpt), "bfloat16", True, str(cache),
                                                      device="cuda:0")
        torch.cuda.synchronize()
        loads[kind] = time.perf_counter() - t0
    same = trees_equal(models["parsed"].params, models["cached"].params)
    cp = pt.ContextParams(keep_quantized=True, kv_dtype="int8")
    pg = bounded_params(pt)
    streams, ctxs = {}, {}
    for kind, model in models.items():
        ctxs[kind] = pt.WhisperContext(model, cp)
        st, runs[f"large_v3_q5_0_int8kv_{kind}"] = run_full(
            f"large_v3_q5_0_int8kv_{kind}", ctxs[kind], pg, audio)
        streams[kind] = segments(st)
    log({"check": "(p1) large-v3 q5_0 native cache: params bit-equal to the parsed .bin, "
                  "streams equal", "params_equal": same,
         "streams_equal": streams["parsed"] == streams["cached"],
         "parse_and_write_s": loads["parsed"], "cached_load_s": loads["cached"],
         "cache_gib": sum(f.stat().st_size for f in cache.iterdir()) / 2 ** 30})
    if not same or streams["parsed"] != streams["cached"]:
        raise AssertionError("(p1) the native cache disagrees with the parsed .bin")
    return ctxs["cached"], cache


def phase_p_tiny_gguf(pt, build, runs, audio):
    """(p1) a tiny f32 GGUF, loaded on the card and on the CPU: equal
    segments."""
    from whisper_tpu_torch.audio.mel import mel_filterbank
    from whisper_tpu_torch.checkpoint import gguf
    from whisper_tpu_torch.checkpoint.init import random_params
    from whisper_tpu_torch.config import WhisperHParams
    from whisper_tpu_torch.tokenizer import synthetic_vocab

    hp = WhisperHParams(**TINY_HP)
    path = build.BUILD_DIR / "chip_smoke_tiny.gguf"
    gguf.write_gguf(str(path), hp, mel_filterbank(hp.n_mels),
                    synthetic_vocab(hp.n_vocab).id_to_token[:50256],
                    ggml_tensors(random_params(hp, seed=1, compute_dtype="float32")))
    p = decisive_params(pt)
    segs = {}
    for where, use_gpu in (("card", True), ("cpu", False)):
        ctx = pt.WhisperContext(gguf.load_model_gguf(str(path), "float32", False,
                                                     "cuda:0" if use_gpu else "cpu"),
                                pt.ContextParams(dtype="float32", use_gpu=use_gpu))
        if use_gpu:
            st, runs["tiny_gguf_f32"] = run_full("tiny_gguf_f32", ctx, p, audio)
        else:
            st = ctx.create_state()
            st.full(p, audio)
        segs[where] = segments(st)
    path.unlink()
    log({"check": "(p1) tiny f32 GGUF: card segments == CPU segments",
         "ok": segs["card"] == segs["cpu"]})
    if segs["card"] != segs["cpu"]:
        raise AssertionError("(p1) tiny GGUF: card and CPU segments differ")


def ranks(cmd, n: int, timeout: float, tag: str):
    """Start n processes of `cmd`, "{rank}" in it replaced by each rank,
    from the repository root, and wait for all; each must exit 0 within
    `timeout`. Returns their outputs."""
    import os
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([c.replace("{rank}", str(r)) for c in cmd], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for r, (proc, out) in enumerate(zip(procs, outs)):
        if proc.returncode != 0:
            print(out[-6000:], flush=True)
            raise AssertionError(f"({tag}) rank {r} exited {proc.returncode}")
    return outs


def phase_p_dist_check(pt, build):
    """(p2) tools/dist_check.py on the card: its reference (un-meshed)
    decode, then 4 ranks sharing cuda:0 over gloo run the tp, dp and tp4
    topologies, each rank's tokens equal to the reference's."""
    from whisper_tpu_torch.tools import dist_check
    ref = build.BUILD_DIR / "chip_smoke_dist_ref.npz"
    rdv = build.BUILD_DIR / "chip_smoke_dist_rdv"
    rdv.unlink(missing_ok=True)
    t0 = time.perf_counter()
    dist_check.run_reference(str(ref), use_gpu=True)
    outs = ranks([sys.executable, "-m", "whisper_tpu_torch.tools.dist_check", "worker",
                  f"file://{rdv}", "4", "{rank}", str(ref), "tp,dp,tp4"],
                 4, 300, "p2 dist_check")
    oks = [line for out in outs for line in out.splitlines() if line.startswith("TP_DIST_OK")]
    log({"check": "(p2) dist_check tp, dp, tp4 on cuda:0, 4 gloo ranks: tokens == "
                  "reference", "ok": len(oks) == 12, "lines": oks,
         "seconds": time.perf_counter() - t0})
    ref.unlink()
    rdv.unlink(missing_ok=True)
    if len(oks) != 12:
        raise AssertionError("(p2) dist_check: a topology did not report")


def phase_p_nccl(build):
    """(p2) one NCCL process group of world size 1 on the card: init, an
    all-reduce, the tensor-parallel gather (models/whisper.py), a mesh
    (1, 1) and all_gather_object, then destroyed."""
    import torch
    import torch.distributed as dist
    from whisper_tpu_torch.models import whisper as model_mod
    from whisper_tpu_torch.parallel import distributed, mesh as mesh_mod
    rdv = build.BUILD_DIR / "chip_smoke_nccl_rdv"
    rdv.unlink(missing_ok=True)
    info = distributed.init_distributed(f"file://{rdv}", 1, 0)
    try:
        x = torch.arange(8.0, device="cuda:0")
        dist.all_reduce(x)
        g = model_mod.tp_all_gather(x, dist.group.WORLD, 0)
        mesh = mesh_mod.make_mesh(1, 1, "cuda")
        objs = [None]
        dist.all_gather_object(objs, {"rank": 0}, group=mesh.get_group("data"))
        torch.cuda.synchronize()
        ok = (info["backend"] == "nccl" and torch.equal(x.cpu(), torch.arange(8.0))
              and torch.equal(g, x) and objs == [{"rank": 0}])
    finally:
        dist.destroy_process_group()
        rdv.unlink(missing_ok=True)
    log({"check": "(p2) NCCL world of 1: init, all_reduce, gather, mesh, all_gather_object",
         "ok": ok, "info": info})
    if not ok:
        raise AssertionError("(p2) NCCL world of 1 failed")


TP_AUDIO = [(1.0, 60), (1.0, 61)]     # (seconds, seed) of the TP = 2 batch


def bounded_params(pt):
    """(p)'s large-v3 decode: greedy, ladder off, no timestamps, end of
    text suppressed, so every window decodes exactly 16 tokens."""
    p = pt.FullParams.default()
    p.temperature_inc = 0.0
    p.print_progress = False
    p.no_timestamps = True
    p.max_tokens = 16
    p.suppress_regex = r"\[_EOT_\]"
    return p


def tp_rank_main(argv) -> int:
    """One rank of (p2)'s TP = 2 run (`chip_smoke.py --tp-rank rank
    init_method checkpoint cache_dir dtype out.json`): the cached large-v3
    Q5_0, loaded to the host, in a context built with mesh_shape (1, 2),
    so only this rank's shard reaches cuda:0 (both ranks share it, over
    gloo); keep_quantized + int8 KV in `dtype`, the token embedding
    sharpened x 8, full_batch over the context's mesh; segments, the
    shard's GiB and run_batch's report to out.json."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    import whisper_tpu_torch as pt
    from whisper_tpu_torch.checkpoint import native_cache
    from whisper_tpu_torch.parallel import distributed

    rank, init, ckpt, cache, dtype, out = int(argv[0]), *argv[1:6]
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.init_distributed(init, 2, rank, backend="gloo")
    model = native_cache.load_model_cached(ckpt, "bfloat16", True, cache, device="cpu")
    ctx = pt.WhisperContext(model, pt.ContextParams(keep_quantized=True, kv_dtype="int8",
                                                    dtype=dtype, mesh_shape=(1, 2)))
    del model
    torch.cuda.synchronize()
    on_card = {"params_gib": tree_gib(ctx.params),
               "allocated_gib": torch.cuda.memory_allocated() / 2 ** 30}
    sharpened(ctx)
    results, report, _ = run_batch(f"large_v3_q5_0_int8kv_tp2_rank{rank}_{dtype}", ctx,
                                   bounded_params(pt), [synthetic_audio(*a) for a in TP_AUDIO],
                                   n_lanes=2, mesh=ctx.mesh)
    with open(out, "w") as f:
        json.dump({"segs": [[seg_tuple(s) for s in u] for u in results], "report": report,
                   "on_card": on_card}, f)
    dist.destroy_process_group()
    return 0


def first_token_divergence(want, got):
    """(utterance, segment, token index, want token, got token) of the first
    difference between two full_batch results (seg_tuple lists), or None."""
    for u, (a, b) in enumerate(zip(want, got)):
        ta = [t for s in a for t in s[3]]
        tb = [t for s in b for t in s[3]]
        j = next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y), None)
        if j is None and len(ta) != len(tb):
            j = min(len(ta), len(tb))
        if j is not None:
            return {"utterance": u, "token": j, "unmeshed": ta[j] if j < len(ta) else None,
                    "tp2": tb[j] if j < len(tb) else None}
    return None


def phase_p_tp2(pt, build, runs, ctx, ckpt, cache):
    """(p2) large-v3 Q5_0 + int8 KV at TP = 2: two gloo ranks on cuda:0
    load (p1)'s cache, sharpen the token embedding x 8 as in (l), and run
    full_batch over the mesh (1, 2) on 2 x 1 s; each rank's segments must
    equal the un-meshed full_batch of `ctx` (the cached context, sharpened
    alike) on the card. On a divergence the first differing token is
    printed and both sides run again in float32. Each rank's B1 and B2
    launches are held to expected_launches inside run_batch."""
    import dataclasses
    from whisper_tpu_torch.checkpoint.loader import LoadedModel

    audios = [synthetic_audio(*a) for a in TP_AUDIO]
    rdv = build.BUILD_DIR / "chip_smoke_tp2_rdv"
    result = {}
    for dtype in ("bfloat16", "float32"):
        c = ctx if dtype == "bfloat16" else pt.WhisperContext(
            LoadedModel(ctx.hparams, ctx.params, ctx.mel_filters, ctx.vocab, ctx.n_loaded),
            dataclasses.replace(ctx.cparams, dtype="float32"))
        orig = sharpened(c)
        try:
            want, r_un, _ = run_batch(f"large_v3_q5_0_int8kv_batch2_unmeshed_{dtype}", c,
                                      bounded_params(pt), audios, n_lanes=2)
        finally:
            c.params["decoder"]["token_embed"] = orig
        want = json.loads(json.dumps([[seg_tuple(s) for s in u] for u in want]))
        rdv.unlink(missing_ok=True)
        outs = [build.BUILD_DIR / f"chip_smoke_tp2_{dtype}_{r}.json" for r in range(2)]
        t0 = time.perf_counter()
        ranks([sys.executable, str(ROOT / "chip_smoke.py"), "--tp-rank", "{rank}",
               f"file://{rdv}", str(ckpt), str(cache), dtype,
               str(build.BUILD_DIR / f"chip_smoke_tp2_{dtype}_{{rank}}.json")],
              2, 600, "p2 tp2")
        wall = time.perf_counter() - t0
        got = [json.load(open(o)) for o in outs]
        for o in outs:
            o.unlink()
        rdv.unlink(missing_ok=True)
        same = all(g["segs"] == want for g in got)
        reports = [g["report"] for g in got]
        result = {
            "check": f"(p2) large-v3 q5_0 + int8 KV {dtype}, TP = 2 (2 gloo ranks on "
                     f"cuda:0): full_batch segments == un-meshed", "ok": same,
            "first_divergence": None if same else [first_token_divergence(want, g["segs"])
                                                   for g in got],
            "ranks_wall_s": wall,
            "ms_per_batched_step": {"unmeshed": r_un["ms_per_batched_step"],
                                    **{f"rank{r}": rep["ms_per_batched_step"]
                                       for r, rep in enumerate(reports)}},
            "encode_ms_per_round": {"unmeshed": r_un["encode_ms_per_round"],
                                    **{f"rank{r}": rep["encode_ms_per_round"]
                                       for r, rep in enumerate(reports)}},
            "all_reduces_per_decoder_call": [rep["tp_all_reduces_per_decoder_call"]
                                             for rep in reports],
            "params_gib": {"unmeshed": tree_gib(c.params),
                           **{f"rank{r}": g["on_card"]["params_gib"]
                              for r, g in enumerate(got)}},
            "rank_allocated_gib_after_load": [g["on_card"]["allocated_gib"] for g in got],
            "launches_per_rank": [rep["launches"] for rep in reports],
            "launches_expected_per_rank": [rep["launches_expected"] for rep in reports],
            "launches_unmeshed": r_un["launches"]}
        log(result)
        runs[f"large_v3_q5_0_int8kv_tp2_{dtype}"] = {**reports[0], "tp2": result}
        if same:
            break
    if not result["ok"]:
        raise AssertionError("(p2) TP = 2 segments differ from the un-meshed run, in "
                             "float32 too")
    # half of every linear, the head-sharded embedding, replicated norms and
    # positions: each rank holds little more than half the model
    gib = result["params_gib"]
    if any(gib[f"rank{r}"] > 0.6 * gib["unmeshed"] for r in range(2)):
        raise AssertionError(f"(p2) a TP = 2 rank holds more than 0.6 of the model: {gib}")
    # 3 a layer, and the lookup where the vocab is sharded (it divides by 2)
    expect = 3 * ctx.hparams.n_text_layer + int(ctx.hparams.n_vocab % 2 == 0)
    if any(n != expect for n in result["all_reduces_per_decoder_call"]):
        raise AssertionError(f"(p2) all-reduces per decoder call "
                             f"{result['all_reduces_per_decoder_call']}, expected {expect}")


def phase_p_micro_bench():
    """(p3) tools/micro_bench.main on the card (copy bandwidth, bf16 GEMM
    and the B2 kernel with Q8_0 weights at M = s)."""
    import contextlib
    import io
    from whisper_tpu_torch.tools import micro_bench
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = micro_bench.main([])
    out = json.loads(buf.getvalue())
    log({"micro_bench": out})
    if rc != 0 or out["card"] is None or any(
            not v > 0 for r in out["mul_mat"].values() for v in r.values()):
        raise AssertionError(f"(p3) micro_bench: {out}")
    return out


# ---- (q) the evidence tools at large-v3 width: memory, traffic, TP, selfcheck


def phase_q(runs) -> None:
    """(q) tools/programs.py, hbm_audit.py, tp_evidence.py and
    utils/selfcheck.py on the card at large-v3 width (random weights, seed
    0, capped decodes of programs.N_STEPS steps): the selfcheck; each
    program's memory_summary and the utterances the card holds, a linear
    extrapolation from the batched program's peaks; one decode step's
    tally against the analytic bytes, with its ms; tensor parallelism at
    TP = 1, 2 and 4, speculation at TP = 2 (its stream equal to the
    un-meshed one, else again in float32) and the 2 x 2 capacity mesh,
    each in gloo ranks sharing cuda:0. The parent's programs and audits
    run with the launch counts set to 0 before them and are held to the
    launches their decoder calls imply; the ranks are processes of their
    own."""
    import torch
    from whisper_tpu_torch.ops.flash_attention import flash_attention
    from whisper_tpu_torch.ops.quant_matmul import quant_matmul
    from whisper_tpu_torch.tools import hbm_audit, programs, tp_evidence
    from whisper_tpu_torch.utils import selfcheck

    dev = torch.device("cuda", 0)
    ok, err = selfcheck.flash_attention_ab_check()
    log({"check": "(q) utils/selfcheck flash_attention_ab_check on the card", "ok": ok,
         "max_abs_err": err, "tol": 2e-2})
    if ok is not True:
        raise AssertionError(f"(q) selfcheck: {ok}, {err}")

    a = programs.lv3_abstract("large-v3")
    hp, n = a.hp, programs.N_STEPS
    la, lt = hp.n_audio_layer, hp.n_text_layer
    q5_calls = 8 * lt * (n + 1)          # B2 per q5 decode: 8 linears a layer, n + 1 calls
    flash_attention.launches = quant_matmul.launches = quant_matmul.launches_offset = 0
    want = {"flash_attention": 0, "quant_matmul": 0, "quant_matmul_offset": 0}
    mem = {}
    plan = [(programs.encoder(a, 1), la, 0), (programs.encoder(a, 4), la, 0),
            (programs.decode_window(a, False, 5), lt, 0),
            (programs.decode_window(a, True, 5), lt, q5_calls)]
    plan += [(programs.batch_decode(a, u, "q5", kv_quant=True), 0, q5_calls)
             for u in (1, 4, 8, 16)]
    for prog, b1, b2 in plan:
        t0 = time.perf_counter()
        r = programs.memory_summary(prog, dev)
        torch.cuda.empty_cache()
        mem[prog.name] = r
        want["flash_attention"] += b1
        want["quant_matmul"] += b2
        log({"memory_summary": r, "seconds": time.perf_counter() - t0})
    # the batched q5 + int8 KV program's peak against its utterances: a
    # least-squares line, extrapolated to the card's memory
    us = [1, 4, 8, 16]
    peaks = [mem[f"batch_decode_u{u}_k5_q5_kv8"]["hbm_peak_gb"] for u in us]
    mu, mp = sum(us) / 4, sum(peaks) / 4
    slope = sum((u - mu) * (p - mp) for u, p in zip(us, peaks)) / sum((u - mu) ** 2 for u in us)
    base = mp - slope * mu
    card_gib = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
    log({"capacity": {"program": "batch_decode q5_0 + int8 KV, beam-5 rows",
                      "peak_gib_by_utterances": dict(zip(map(str, us), peaks)),
                      "gib_per_added_utterance": slope, "gib_at_zero": base,
                      "card_gib": card_gib,
                      "utterances_the_card_holds": int((card_gib - base) // slope),
                      "method": "linear extrapolation of the four peaks, not measured there"}})
    if not all(p > 0 for p in peaks) or not slope > 0:
        raise AssertionError(f"(q) batched peaks {peaks}")

    audits = {}
    for name, kw in (("greedy_bf16", dict(beam=1)), ("beam5_bf16", dict(beam=5)),
                     ("greedy_q5_0_int8kv", dict(weights="q5", kv="int8", beam=1, n_utt=1))):
        t0 = time.perf_counter()
        r = hbm_audit.audit_decode_step(device=dev, **kw)
        torch.cuda.empty_cache()
        audits[name] = r
        # two runs (timed, tallied): a bf16 cross-KV's prompt pass takes B1
        want["flash_attention"] += 2 * lt * (kw.get("kv", "bf16") == "bf16")
        want["quant_matmul"] += 2 * q5_calls * (kw.get("weights") == "q5")
        layers = r.pop("layers_gb")
        log({"hbm_audit": name, **r, "layers_gb_min_max": [min(layers), max(layers)],
             "seconds": time.perf_counter() - t0})
        if abs(r["per_token_gb"] - r["step_total_gb"]) > 0.01 * r["step_total_gb"]:
            raise AssertionError(f"(q) hbm_audit {name}: the split misses the step's total")
    if not audits["greedy_q5_0_int8kv"]["by_class_gb"].get("B2", 0) > 0:
        raise AssertionError("(q) hbm_audit: the q5_0 step tallied no B2 bytes")
    got = {"flash_attention": flash_attention.launches, "quant_matmul": quant_matmul.launches,
           "quant_matmul_offset": quant_matmul.launches_offset}
    runs["evidence_programs"] = {"launches": got, "launches_expected": want}
    log({"check": "(q) programs and audits: launches == expected", "ok": got == want,
         "launches": got, "expected": want})
    if got != want or not (got["flash_attention"] and got["quant_matmul"]):
        raise AssertionError(f"(q) launches {got}, expected {want}")

    def rank_lines(rep, phases):
        return [{"rank": rk["rank"], **{ph: {k: rk[ph].get(k) for k in (
            "args_gb", "temp_gb", "hbm_peak_gb", "collectives", "collective_bytes",
            "collectives_per_decoder_call")} for ph in phases}} for rk in rep["ranks"]]

    t0 = time.perf_counter()
    kw = dict(preset="large-v3", seed=0, hp=None)
    tps = tp_evidence.run_reports([("tp", d, dict(kw, tp=d, beam=5)) for d in (1, 2, 4)],
                                  "cuda")
    for rep in tps:
        log({"tp_evidence": rep["tp"], "backend": rep["backend"],
             "params_gib": [rk["params_gb"] for rk in rep["ranks"]],
             "per_rank": rank_lines(rep, ("encoder", "decode_beam5"))})
    log({"phase": "(q) tp_evidence 1, 2, 4", "seconds": time.perf_counter() - t0})
    r1, r2, r4 = tps
    # 2 a layer per encode, 3 a decoder layer per call, the vocab-sharded
    # lookup and the logits gather where 51866 divides (TP = 2, not 4)
    expect = {1: ({}, {}), 2: ({"all-reduce": 2 * la}, {"all-reduce": 3 * lt + 1,
                                                          "all-gather": 1}),
              4: ({"all-reduce": 2 * la}, {"all-reduce": 3 * lt})}
    for rep in tps:
        enc_c, call_c = expect[rep["tp"]]
        for rk in rep["ranks"]:
            if (rk["encoder"]["collectives"] != enc_c
                    or rk["decode_beam5"]["collectives_per_decoder_call"] != call_c):
                raise AssertionError(f"(q) TP = {rep['tp']} rank {rk['rank']} collectives "
                                     f"{rk['encoder']['collectives']} / "
                                     f"{rk['decode_beam5']['collectives_per_decoder_call']}, "
                                     f"expected {enc_c} / {call_c}")
    for ph in ("encoder", "decode_beam5"):
        if not r2[ph]["args_gb"] < 0.7 * r1[ph]["args_gb"] or \
                not r4[ph]["args_gb"] < r2[ph]["args_gb"]:
            raise AssertionError(f"(q) {ph} args per rank {r1[ph]['args_gb']}, "
                                 f"{r2[ph]['args_gb']}, {r4[ph]['args_gb']}")

    t0 = time.perf_counter()
    spec, cap = tp_evidence.run_reports(
        [("spec", 2, dict(kw, tp=2, k_spec=8, dtype="bfloat16")),
         ("capacity", 4, dict(kw, dp=2, tp=2, n_utt=8))], "cuda")
    specs = [spec]
    if not spec["stream_equal"]:
        log({"spec_tp_evidence": "bf16 stream differs from the un-meshed one; again in "
             "float32", "unmeshed": spec["unmeshed_stream"],
             "ranks": [rk["stream"] for rk in spec["ranks"]]})
        specs.append(tp_evidence.spec_tp_evidence(2, "large-v3", 8, "cuda", dtype="float32"))
    for sp in specs:
        log({"spec_tp_evidence": 2, "dtype": sp["dtype"], "stream_equal": sp["stream_equal"],
             "unmeshed_stream": sp["unmeshed_stream"], "unmeshed_rounds": sp["unmeshed_rounds"],
             "rounds": [rk["rounds"] for rk in sp["ranks"]],
             "main_params_gib": [rk["main_params_gb"] for rk in sp["ranks"]],
             "main_params_gib_unsharded": sp["main_params_gb_unsharded"],
             "draft_params_gib": [rk["draft_params_gb"] for rk in sp["ranks"]],
             "per_rank": rank_lines(sp, ("decode_speculative",))})
    log({"capacity_tp_evidence": "2 x 2", "n_utt": cap["n_utt"],
         "params_gib": [rk["params_gb"] for rk in cap["ranks"]],
         "cross_kv_gib": [rk["cross_kv_gb"] for rk in cap["ranks"]],
         "cross_kv_gib_unsharded": cap["cross_kv_gb_unsharded"],
         "per_rank": rank_lines(cap, ("decode_beam5_capacity",))})
    log({"phase": "(q) spec + capacity tp_evidence", "seconds": time.perf_counter() - t0})
    if not specs[-1]["stream_equal"]:
        raise AssertionError("(q) speculative stream at TP = 2 differs from the un-meshed one, "
                             "in float32 too")
    if any(rk["main_params_gb"] > 0.6 * spec["main_params_gb_unsharded"]
           or rk["draft_params_gb"] != spec["draft_params_gb"] for rk in spec["ranks"]):
        raise AssertionError("(q) speculative TP: the main model must halve, the draft stay whole")
    if any(abs(rk["cross_kv_gb"] * 4 - rk["cross_kv_gb_unsharded"]) > 1e-9
           for rk in cap["ranks"]):
        raise AssertionError("(q) capacity: a rank's cross-KV is not 1 / (dp x tp) of it")


# ---- (r) the benchmark harness at large-v3 width; bench_all at tiny

# the capacity sweep's labels in this script (the CLI sweeps all three)
R_LABELS = ("q5_kv8",)


def phase_r(runs) -> None:
    """(r) tools/bench.py at large-v3 in this process: the probe, the six
    timed phases (random bf16 weights, seed 0), the beam-5 memory check and
    the capacity sweep on R_LABELS, with the launch counts set to 0 before
    it and read after; then tools/bench_all.py tiny --no-lv3 --no-batch
    as a process of its own, its table held to one row without an error."""
    import gc
    import math
    import torch
    from whisper_tpu_torch.ops.flash_attention import flash_attention
    from whisper_tpu_torch.ops.quant_matmul import quant_matmul
    from whisper_tpu_torch.tools import bench

    dev = torch.device("cuda", 0)
    gc.collect()
    torch.cuda.empty_cache()
    log({"phase": "(r) start", "memory_allocated_gib": torch.cuda.memory_allocated(dev) / 2 ** 30,
         "memory_reserved_gib": torch.cuda.memory_reserved(dev) / 2 ** 30})
    t0 = time.perf_counter()
    flash_attention.launches = quant_matmul.launches = quant_matmul.launches_offset = 0
    line, detail = bench.run("large-v3", dev, labels=R_LABELS)
    got = {"flash_attention": flash_attention.launches, "quant_matmul": quant_matmul.launches,
           "quant_matmul_offset": quant_matmul.launches_offset}
    runs["bench_large_v3"] = {"launches": got}
    ph, bc = detail["phases"], detail["batch_capacity"]
    log({"bench_phases": ph, "seconds": time.perf_counter() - t0})
    log({"bench_largev3_beam5": detail["largev3_beam5"]})
    log({"bench_batch_capacity": bc})
    log(json.dumps(line))
    bad = {k: v for k, v in ph["ms"].items() if not (math.isfinite(v) and v > 0)}
    if bad or not ph["audio_s_per_s"] > 0:
        raise AssertionError(f"(r) phase times not finite and positive: {bad}")
    if not 0 < detail["probe_tflops"] <= bench.PROBE_LIMIT * 989:
        raise AssertionError(f"(r) probe {detail['probe_tflops']} TFLOP/s")
    enc_b1 = ph["launches"]["encode"]["B1"]
    want_b1 = ph["calls"]["encode"] * ph["encoder_layers"]
    log({"check": "(r) B1 launches in the timed encodes == encodes x layers",
         "ok": enc_b1 == want_b1, "launches": enc_b1, "expected": want_b1})
    if enc_b1 != want_b1:
        raise AssertionError(f"(r) encode phase: B1 launched {enc_b1}, expected {want_b1}")
    for label in R_LABELS:
        if label.startswith("q5") and not bc["launches"][label]["B2"] > 0:
            raise AssertionError(f"(r) capacity {label}: no B2 launch in its cells")
    if not (bc["max_exact_q5_kv8"] and bc["max_utt_card"]["q5_kv8"] > 0):
        raise AssertionError(f"(r) q5_kv8 capacity not exact: {bc['max_utt_card']}")
    if not (got["flash_attention"] and got["quant_matmul"]):
        raise AssertionError(f"(r) launches {got}")
    log({"phase": "(r) bench large-v3", "seconds": time.perf_counter() - t0,
         "launches": got})

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "whisper_tpu_torch.tools.bench_all", "tiny",
                           "--no-lv3", "--no-batch"], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    print(proc.stdout, end="", flush=True)
    rows = [ln for ln in proc.stdout.splitlines() if ln.split("|")[0].strip() == "tiny"]
    log({"phase": "(r) bench_all tiny", "seconds": time.perf_counter() - t0,
         "rc": proc.returncode})
    if proc.returncode or len(rows) != 1 or "ERROR" in rows[0] or "nan" in rows[0]:
        raise AssertionError(f"(r) bench_all tiny: rc {proc.returncode}, rows {rows}, "
                             f"stderr {proc.stderr[-2000:]}")


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import whisper_tpu_torch as pt
    from whisper_tpu_torch.ops import build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    log(card)
    log({"device_info": {"count": pt.device_count(), "description": pt.device_description(0),
                         "total_memory_bytes": pt.device_total_memory(0)}})
    log({"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
         "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: off for matmul and cuDNN (float32 results are full float32)")

    # ---- 2. build
    t0 = time.perf_counter()
    built = build.build(build.KERNEL_SOURCES + build.HOST_SOURCES, ptxas_verbose=True)
    for name, info in built.items():
        log({"build": name, "seconds": info["seconds"]})
    log({"build_total_s": time.perf_counter() - t0})
    resources = kernel_resources({k: v for k, v in built.items() if k in build.KERNEL_SOURCES})
    for name, funcs in resources.items():
        for fn, res in funcs.items():
            log({"kernel_function": fn, "library": name, **res})
    # the redesigned kernels must run on the tensor cores: each has at least
    # one function (its name matched mangled or not) and each such function
    # has tensor-core instructions in its SASS
    for lib, stem in (("flash_attention", "attn_tc"), ("quant_matmul", "qmm_wide"),
                      ("quant_matmul", "qmm_skinny_cluster")):
        found = {fn: res for fn, res in resources[lib].items() if stem in fn}
        if not found:
            raise AssertionError(f"{lib}: no kernel function named {stem}")
        for fn, res in found.items():
            if not res.get("tensor_core_instructions"):
                raise AssertionError(f"{fn}: no tensor-core instruction counted in "
                                     f"its SASS: {res}")

    # ---- 3. kernels against their plain versions
    worst, timings = kernel_phase(dev)
    t0 = time.perf_counter()
    qworst, qratio, qtimings, qhost = qmm_phase(dev)
    log({"phase": "3b quant_matmul", "seconds": time.perf_counter() - t0})

    # ---- 4n. the host C++ runtime against the Python paths
    t0 = time.perf_counter()
    phase_n(pt)
    log({"phase": "4n host runtime", "seconds": time.perf_counter() - t0})

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
    same = segments(st_gpu) == segments(st_cpu)
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

    # ---- 4d. the tiny checkpoint as Q5_0, keep_quantized + int8 KV, card against CPU
    tiny_checkpoint(ckpt, "q5_0")
    cq = dict(keep_quantized=True, kv_dtype="int8", dtype="float32")
    gpu_q = pt.WhisperContext.new_with_params(str(ckpt), pt.ContextParams(**cq))
    cpu_q = pt.WhisperContext.new_with_params(str(ckpt), pt.ContextParams(**cq, use_gpu=False))
    st_gpu, runs["tiny_q5_0_int8kv"] = run_full("tiny_q5_0_int8kv", gpu_q, p, audio)
    st_cpu = cpu_q.create_state()
    st_cpu.full(p, audio)
    same = segments(st_gpu) == segments(st_cpu)
    log({"check": "tiny q5_0 + int8 KV f32: card segments == CPU segments", "ok": same})
    if not same:
        raise AssertionError("tiny q5_0 model: card and CPU transcriptions differ")
    del gpu_q, cpu_q, st_gpu, st_cpu
    ckpt.unlink()

    # ---- 4g. tiny multilingual f32: auto language, timestamps, DTW, grammar, callback
    t0 = time.perf_counter()
    phase_g(pt, build, runs)
    log({"phase": "4g tiny multilingual", "seconds": time.perf_counter() - t0})

    # ---- 4k. batching on the tiny checkpoint: card against CPU, refill, 1 lane vs full()
    t0 = time.perf_counter()
    phase_k_tiny(pt, build, runs)
    log({"phase": "4k tiny batching", "seconds": time.perf_counter() - t0})

    # ---- 4l. speculative decoding on a tiny f32 model: k = 1, 4, 8, card against CPU
    t0 = time.perf_counter()
    phase_l_tiny(pt, runs)
    log({"phase": "4l tiny speculative", "seconds": time.perf_counter() - t0})

    # ---- 4o. serving on the tiny checkpoint: server, CLI, stream, LSP, card against CPU
    t0 = time.perf_counter()
    phase_o_tiny(pt, build, runs)
    log({"phase": "4o tiny served", "seconds": time.perf_counter() - t0})

    # ---- 4p. a tiny f32 GGUF, card against CPU
    t0 = time.perf_counter()
    phase_p_tiny_gguf(pt, build, runs, audio)
    p_seconds = {"tiny_gguf": time.perf_counter() - t0}

    # ---- 4b. large-v3, random weights, greedy
    t0 = time.perf_counter()
    ctx = pt.WhisperContext.random("large-v3", seed=0)
    torch.cuda.synchronize()
    bf16_gib = tree_gib(ctx.params)
    log({"context": "large-v3 random bf16", "build_s": time.perf_counter() - t0,
         "weights_gib": bf16_gib})
    pg = pt.FullParams.default()
    pg.temperature_inc = 0.0
    pg.print_progress = False
    st, runs["large_v3_greedy"] = run_full("large_v3_greedy", ctx, pg, synthetic_audio(6, 1))
    log({"encode_profile": "large_v3_greedy", **encode_profile(st)})
    del st

    # ---- 4c. beam 5
    pb = pt.FullParams.default(pt.SamplingStrategy.BEAM_SEARCH)
    pb.beam_search.beam_size = 5
    pb.temperature_inc = 0.0
    pb.print_progress = False
    _, runs["large_v3_beam5"] = run_full("large_v3_beam5", ctx, pb, synthetic_audio(15, 2))

    # ---- 4h. language detection, energy timestamps and DTW on large-v3
    t0 = time.perf_counter()
    phase_h(pt, ctx, runs)
    log({"phase": "4h large-v3 auto language + DTW", "seconds": time.perf_counter() - t0})

    # ---- 4i. grammar (token DFA) and logits callback (host loop) on large-v3
    t0 = time.perf_counter()
    phase_i(pt, ctx, runs)
    log({"phase": "4i large-v3 grammar + callback", "seconds": time.perf_counter() - t0})

    # ---- 4j. VAD: card against CPU, tiny full(vad=True), large-v3 full(vad=True)
    t0 = time.perf_counter()
    vad_path, vad_thr = phase_j(pt, build, runs, ctx)
    log({"phase": "4j VAD", "seconds": time.perf_counter() - t0})

    # ---- 4k. batching on large-v3 bf16: full_batch 4 x 6 s, full_parallel(4) with VAD
    t0 = time.perf_counter()
    phase_k_large(pt, runs, ctx, vad_path, vad_thr)
    vad_path.unlink()
    log({"phase": "4k large-v3 batching", "seconds": time.perf_counter() - t0})

    # ---- 4l. speculative decoding on large-v3 bf16: vanilla, self-draft, distil-shaped
    t0 = time.perf_counter()
    phase_l_large(pt, runs, ctx)
    log({"phase": "4l large-v3 speculative", "seconds": time.perf_counter() - t0})

    # ---- 4p. the same weights as F16 in a .bin and a .gguf
    t0 = time.perf_counter()
    phase_p_f16(pt, build, runs, ctx, synthetic_audio(1, 62))
    p_seconds["f16_bin_gguf"] = time.perf_counter() - t0

    # ---- 4e. large-v3 as Q5_0 (the same weights), keep_quantized + int8 KV, greedy
    ckpt = build.BUILD_DIR / "chip_smoke_large_v3_q5_0.bin"
    t0 = time.perf_counter()
    write_checkpoint(ckpt, ctx.hparams, ctx.params, "q5_0")
    t_write = time.perf_counter() - t0
    del ctx
    t0 = time.perf_counter()
    ctx = pt.WhisperContext.new_with_params(
        str(ckpt), pt.ContextParams(keep_quantized=True, kv_dtype="int8"))
    torch.cuda.synchronize()
    log({"context": "large-v3 q5_0 keep_quantized, int8 KV, bf16",
         "file_gib": ckpt.stat().st_size / 2 ** 30, "write_s": t_write,
         "load_s": time.perf_counter() - t0, "weights_gib": tree_gib(ctx.params),
         "weights_gib_bf16_context": bf16_gib})
    audio_e = synthetic_audio(3, 3)
    st, runs["large_v3_q5_0_int8kv_greedy"] = run_full(
        "large_v3_q5_0_int8kv_greedy", ctx, pg, audio_e)
    log({"encode_profile": "large_v3_q5_0_int8kv_greedy", **encode_profile(st)})
    # (l) the same context as its own draft: B2's skinny path at M = 8
    t0 = time.perf_counter()
    phase_l_q5_0(pt, runs, ctx, audio_e)
    log({"phase": "4l large-v3 q5_0 speculative", "seconds": time.perf_counter() - t0})
    del st
    # (k) the batched beam-5 step at 4 lanes x 5 rows: B2's wide path at M = 20
    t0 = time.perf_counter()
    pb5 = pt.FullParams.default(pt.SamplingStrategy.BEAM_SEARCH)
    pb5.beam_search.beam_size = 5
    pb5.temperature_inc = 0.0
    pb5.print_progress = False
    _, r, _ = run_batch("large_v3_q5_0_int8kv_batch4_beam5", ctx, pb5,
                        [synthetic_audio(3, 40 + i) for i in range(4)], n_lanes=4)
    runs["large_v3_q5_0_int8kv_batch4_beam5"] = r
    if r["rows_per_step"] != 20:
        raise AssertionError(f"(k) q5_0 batch: {r['rows_per_step']} rows per step, not 20")
    log({"phase": "4k large-v3 q5_0 batched beam-5", "seconds": time.perf_counter() - t0})
    del ctx
    # (o) the same file served: the lock path, then 4 requests batched by the dispatcher
    t0 = time.perf_counter()
    phase_o_large(pt, runs, ckpt)
    log({"phase": "4o large-v3 q5_0 served", "seconds": time.perf_counter() - t0})

    # ---- 4p. (e)'s file through the native cache; dist_check, NCCL and
    # TP = 2 on the cached model; micro_bench
    t0 = time.perf_counter()
    ctx, cache = phase_p_cache(pt, build, runs, ckpt, synthetic_audio(1, 63))
    p_seconds["native_cache"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_p_dist_check(pt, build)
    p_seconds["dist_check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_p_nccl(build)
    p_seconds["nccl"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_p_tp2(pt, build, runs, ctx, ckpt, cache)
    p_seconds["tp2"] = time.perf_counter() - t0
    del ctx
    shutil.rmtree(cache)
    ckpt.unlink()
    t0 = time.perf_counter()
    phase_p_micro_bench()
    p_seconds["micro_bench"] = time.perf_counter() - t0
    log({"phase": "4p checkpoint tools + mesh", "seconds": p_seconds,
         "total_s": sum(p_seconds.values())})

    # ---- 4f. small as Q5_1 (ggml-small-q5_1.bin's layout), keep_quantized, beam 5
    from whisper_tpu_torch.checkpoint.init import random_params
    from whisper_tpu_torch.config import PRESET_HPARAMS
    ckpt = build.BUILD_DIR / "chip_smoke_small_q5_1.bin"
    hp_small = PRESET_HPARAMS["small"]
    t0 = time.perf_counter()
    write_checkpoint(ckpt, hp_small, random_params(hp_small, seed=0, compute_dtype="float32"),
                     "q5_1")
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctx = pt.WhisperContext.new_with_params(str(ckpt), pt.ContextParams(keep_quantized=True))
    torch.cuda.synchronize()
    log({"context": "small q5_1 keep_quantized, bf16 KV", "write_s": t_write,
         "load_s": time.perf_counter() - t0, "weights_gib": tree_gib(ctx.params)})
    ckpt.unlink()
    ps = pt.FullParams.default(pt.SamplingStrategy.BEAM_SEARCH)
    ps.beam_search.beam_size = 5
    ps.temperature_inc = 0.0
    ps.print_progress = False
    ps.no_timestamps = True
    ps.suppress_regex = r"\[_EOT_\]"
    ps.max_tokens = 200
    st, runs["small_q5_1_beam5"] = run_full("small_q5_1_beam5", ctx, ps, synthetic_audio(8, 4))
    if runs["small_q5_1_beam5"]["decoder_calls"] != ps.max_tokens + 1:
        raise AssertionError(f"small q5_1: {runs['small_q5_1_beam5']['decoder_calls']} "
                             f"decoder calls, expected the prompt pass and "
                             f"{ps.max_tokens} steps")
    del ctx, st
    log({"peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})

    # ---- 4q. the evidence tools at large-v3 width
    t0 = time.perf_counter()
    phase_q(runs)
    log({"phase": "4q evidence tools", "seconds": time.perf_counter() - t0})

    # ---- 4r. the benchmark harness at large-v3, bench_all at tiny
    t0 = time.perf_counter()
    phase_r(runs)
    log({"phase": "4r benchmark harness", "seconds": time.perf_counter() - t0})

    # ---- 5. results
    enc = timings["encoder_self"]

    def by_run(kernel):
        return {k: r["launches"][kernel] for k, r in runs.items()}

    def tp2_launches(kernel):
        tp2 = next(r for k, r in runs.items() if k.startswith("large_v3_q5_0_int8kv_tp2_"))
        return [n[kernel] for n in tp2["tp2"]["launches_per_rank"]]

    def sass(lib, prefix):
        return {fn: res for fn, res in resources[lib].items() if fn.startswith(prefix)}

    def qmm_entry(name, tpu_line, tpu_fn, main_run):
        t1 = qtimings[(name, 1, 1280, 5120)]
        return {
            "name": name, "route": "cuda",
            "source": "whisper_tpu_torch/csrc/quant_matmul.cu",
            "replaces": f"whisper_tpu/ops/quant_matmul.py:{tpu_line}",
            "tpu_kernel": f"whisper_tpu/ops/quant_matmul.py::{tpu_fn}",
            "launches": runs[main_run]["launches"][name],
            "launches_by_run": by_run(name),
            "max_abs_err": qworst[name], "max_err_over_allowed": qratio[name],
            "tol": f"{QMM_TOL} * max(1, max|plain|)",
            "ms": t1["ms"], "plain_ms": t1["plain_ms"], "bound_ms": t1["bound_ms"],
            "bound_by": t1["bound_by"], "library_ms": t1["library_ms"],
            "library": t1["library"],
            "shape": {"m": 1, "in": 1280, "out": 5120, "format": t1["format"]},
            "timings": {f"M={m} {i}->{o}": t for (n, m, i, o), t in qtimings.items()
                        if n == name},
            "host_us_breakdown": qhost[name],
            "launches_tp2_per_rank": tp2_launches(name),
            "sass": sass("quant_matmul", "qmm_"),
        }

    log({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "whisper_tpu_torch/csrc/flash_attention.cu",
        "replaces": "whisper_tpu/ops/flash_attention.py:25",
        "tpu_kernel": "whisper_tpu/ops/flash_attention.py::_attn_kernel",
        "launches": runs["large_v3_greedy"]["flash_launches"],
        "launches_by_run": by_run("flash_attention"),
        "max_abs_err": worst["bfloat16"], "max_err": worst["bfloat16"],
        "tol": TOLS["bfloat16"], "max_abs_err_f32": worst["float32"],
        "tol_f32": TOLS["float32"],
        "ms": enc["ms"], "kernel_ms": enc["ms"], "plain_ms": enc["plain_ms"],
        "bound_ms": enc["bound_ms"], "bound_by": enc["bound_by"],
        "library_ms": enc["library_ms"], "library": enc["library"],
        "shape": {"q": enc["q"], "tk": enc["tk"], "dtype": enc["dtype"]},
        "prompt_pass": timings["prompt_cross_8"],
        "prompt_pass_beam5": timings["beam5_folded_8"],
        "batched_encode_4_lanes": timings["encoder_self_b4"],
        "batched_prompt_pass_4_lanes": timings["prompt_cross_b4_8"],
        "tp2_encode_10_heads": timings["encoder_self_h10_tp2"],
        "tp4_encode_5_heads": timings["encoder_self_h5_tp4"],
        "launches_tp2_per_rank": tp2_launches("flash_attention"),
        "sass": sass("flash_attention", "attn_"),
    }, qmm_entry("quant_matmul", 31, "_qmm_kernel", "large_v3_q5_0_int8kv_greedy"),
       qmm_entry("quant_matmul_offset", 45, "_qmm_kernel_offset", "small_q5_1_beam5")]})
    log({"wall_s": time.perf_counter() - t_start})
    log(card)
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(tp_rank_main(sys.argv[2:]) if sys.argv[1:2] == ["--tp-rank"] else main())
