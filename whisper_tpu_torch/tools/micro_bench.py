"""Roofline micro-benchmarks: device copy bandwidth and matmul throughput.

Counterpart of the JAX package's tools/micro_bench.py, the analogue of
the reference's `whisper_bench_memcpy` and `whisper_bench_ggml_mul_mat`
(include/whisper.h:722-725, driven by examples/bench/bench.cpp): in place
of host memcpy and per-quant-type CPU GEMMs, it measures what bounds the
port on a card: memory bandwidth (a decode step is bandwidth-bound) and
matmul rate, in bf16 (`x @ x`, PyTorch's own GEMM) and through the port's
int8 block-dequant kernel (ops/quant_matmul.py, B2) with Q8_0 weights at
M = s rows, its wide path.

On a card the times come from CUDA events around a run of calls, after a
warm-up. `--cpu` (or a CPU `device`) times the same calls on the host
clock, where quant_matmul computes its plain version: a functional check,
whose rates are the CPU's and no device's.

    python -m whisper_tpu_torch.tools.micro_bench [--mib 256] [--sizes ...] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core rate, HBM3 bandwidth
H100_BF16_TFLOPS = 989.0
H100_HBM_GBPS = 3350.0
MIN_TIMED_S = 0.02          # each timed run lasts at least this long


def _device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("micro_bench: no CUDA device (pass device='cpu' or --cpu)")
        return torch.device("cuda", 0)
    return torch.device(device)


def _seconds_per_call(fn, dev: torch.device) -> float:
    """Seconds per call of fn: CUDA events on a card, the host clock on
    the CPU; the run is grown until it lasts MIN_TIMED_S."""
    fn()                                         # warm-up (and first-use costs)
    n = 1
    while True:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            t = time.perf_counter() - t0
        if t >= MIN_TIMED_S or n >= 1 << 16:
            return t / n
        n *= 2


def bench_membw(mib: int = 256, device=None) -> float:
    """Copy bandwidth in GB/s: `mib` MiB read and written per call."""
    dev = _device(device)
    src = torch.ones(mib << 20, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    t = _seconds_per_call(lambda: dst.copy_(src), dev)
    return 2 * src.numel() / t / 1e9


def q8_0_weight(s: int, dev: torch.device):
    """A seeded (s, s) weight as Q8_0 blocks in quant_matmul's layout."""
    from whisper_tpu_torch.checkpoint import loader, quant
    w = np.random.default_rng(0).standard_normal((s, s)).astype(np.float32)
    leaves = loader.quantized_leaves(quant.quantize(w, quant.GGML_TYPE_Q8_0),
                                     quant.GGML_TYPE_Q8_0, s, s)
    return torch.from_numpy(leaves["q"]).to(dev), torch.from_numpy(leaves["d"]).to(dev)


def bench_mul_mat(sizes=(512, 1024, 2048, 4096), device=None) -> dict:
    """TFLOP/s of an (s, s) @ (s, s) product per size: bf16 through
    PyTorch's GEMM, and bf16 x against Q8_0 weights through the port's
    quant_matmul (the kernel on a card: a failure there raises)."""
    from whisper_tpu_torch.ops.quant_matmul import quant_matmul
    dev = _device(device)
    out = {}
    for s in sizes:
        x = torch.randn(s, s, generator=torch.Generator().manual_seed(s)).to(dev, torch.bfloat16)
        flops = 2 * s ** 3
        res = {"bf16_tflops": flops / _seconds_per_call(lambda: x @ x, dev) / 1e12}
        q, d = q8_0_weight(s, dev)
        res["q8_tflops"] = flops / _seconds_per_call(lambda: quant_matmul(x, q, d), dev) / 1e12
        out[s] = res
    return out


def card() -> Optional[str]:
    """`nvidia-smi --query-gpu=name,power.limit` of card 0, or None where
    there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="micro-bench")
    p.add_argument("--mib", type=int, default=256, help="copy buffer MiB")
    p.add_argument("--sizes", type=int, nargs="*", default=[512, 1024, 2048, 4096])
    p.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = p.parse_args(argv)

    dev = _device("cpu" if args.cpu else None)
    result = {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "card": card() if dev.type == "cuda" else None,
        "membw_gbps": bench_membw(args.mib, dev),
        "membw_peak_gbps": H100_HBM_GBPS,
        "mul_mat": bench_mul_mat(tuple(args.sizes), dev),
        "bf16_peak_tflops": H100_BF16_TFLOPS,
    }
    print(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
