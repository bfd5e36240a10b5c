"""The port's benchmark harness: whisper.cpp's bench phases on one card,
the large-v3 beam-5 memory check and the batch-capacity sweep, summed up
in one JSON line on stdout.

Counterpart of the root bench.py, the JAX package's harness. Its method
is the reference's bench tool (examples/bench/bench.cpp: a zero mel of
3000 frames through the encoder; sequential single-token decodes), and
it derives the per-window throughput in audio-seconds per second:

    rtf = 30 s / (t_mel + t_enc + t_cross + N_TOK * t_dec)

with N_TOK = 220 (the per-window token budget, n_text_ctx/2 - 4).
vs_baseline compares it with the reference fork's published GPU real-time
factors (BASELINE_RTF).

The timed phases run the port's own functions (audio/mel.py's device
body, models/whisper.py's encoder_forward, cross_attention_kv,
decoder_forward and KVCache) on random bf16 weights
(checkpoint/init.random_model, seed 0), the encoder's self-attention
through the flash-attention kernel on the card (tools/programs.py's
_flash, as api.py runs it):

- mel: 30 s of silence, padded, already on the device;
- encode, cross-kv: one 30 s window;
- decode: ms per token, one row; bch5: ms per step of 5 rows;
- pp: ms per token of a 64-token chunk (the prompt pass, logit_rows=63).

Each phase's time is the slope between two chain lengths of warmed calls
(enc and cross-kv 1 / 41, decode and bch5 32 / 256, pp 4 / 36, mel 1 / 5):
the fixed cost of a chain cancels. On the card a chain is timed with
CUDA events, on the CPU (`--cpu`) with the host clock. A probe first
times chained 4096^3 bf16 products: a rate above 1.05x the card's peak
(989 TFLOP/s dense bf16, H100 SXM) means the timing is broken, and the
run stops there.

Then, unless switched off: the large-v3 beam-5 check (tools/programs.py's
decode_window in bf16 and int8 blocks, the encoder at batch 1 and the
speculative window, each under memory_summary, and tools/hbm_audit's
tally of one beam-5 step against its analytic bytes), and the capacity
sweep: the batched beam-5 program (programs.batch_decode, 5 rows an
utterance) in bf16, q5 (int8-block weights) and q5_kv8 (and an int8 KV),
doubled from 4 utterances until a cell overflows the card's memory, then
bisected to the exact boundary; a cell whose peak, extrapolated from the
last two that ran, passes 1.25x the card's memory is skipped as a
predicted overflow. The throughput at capacity is modelled on the
analytic bytes (decode at 70 % of 3.35 TB/s, encode at 50 % of 989
TFLOP/s) and, from the tallied step at the largest batch, on its bytes.

stdout carries one compact JSON line (well under 1 KB); the whole
evidence goes to the detail file (--detail, by default
chiprun_out/bench_detail_<preset>.json under the repository) and the
phase times to stderr, one `name: value ms` line each.

    python -m whisper_tpu_torch.tools.bench [--preset P] [--cpu] [--no-lv3]
        [--no-batch] [--detail PATH]

`--preset tiny-test` is checkpoint/init.tiny_test_hparams, the tests'
micro model. Without a card and without --cpu it raises InitError.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import pathlib
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from whisper_tpu_torch.config import PRESET_HPARAMS, WhisperHParams
from whisper_tpu_torch.errors import InitError
from whisper_tpu_torch.tools.hbm_audit import (H100_BF16_FLOPS, H100_HBM_BYTES_PER_S,
                                               analytic, launch_counts)

ROOT = pathlib.Path(__file__).resolve().parents[2]
N_TOK = 220
# reference RTF claims per model (the reference fork's README.md:204-209,
# GPU column)
BASELINE_RTF = {"tiny": 50.0, "base": 40.0, "small": 25.0, "medium": 10.0,
                "large-v1": 4.0, "large-v2": 4.0, "large-v3": 4.0,
                "large-v3-turbo": 8.0}
# (d, L_enc, L_dec): width and encoder/decoder layer counts (equal for the
# classic family; large-v3-turbo keeps the 32-layer encoder but distils
# the decoder to 4 layers)
PRESET_DIMS = {
    "tiny": (384, 4, 4), "base": (512, 6, 6), "small": (768, 12, 12),
    "medium": (1024, 24, 24), "large-v3": (1280, 32, 32),
    "large-v3-turbo": (1280, 32, 4),
}
# V100 CUDA FA=0 measured baselines: Enc ms, Dec ms/tok, Bch5 ms/tok·row
# (the reference's scripts/bench-all-gg.txt:256-264; the large-v2 row
# stands in for large-v3 — identical dims, v3 only widens the mel bank
# to 128)
V100_MS = {
    "tiny": (6.15, 1.02, 0.30), "base": (10.60, 1.43, 0.43),
    "small": (31.83, 2.82, 0.87), "medium": (81.30, 6.02, 1.81),
    "large-v3": (134.81, 8.64, 2.69),
    "large-v3-turbo": (124.42, 1.37, None),   # bench-all-gg.txt:266
}
# modelled efficiencies of the "expected" rows: encode at 50 % of the
# bf16 peak, decode at 70 % of the memory rate
ENC_EFF, DEC_EFF = 0.5, 0.7
PROBE_LIMIT = 1.05          # probe rate over the bf16 peak that stops the run
K_ROWS = 5                  # beam-5 rows per utterance in the sweep
SKIP_FACTOR = 1.25          # predicted peak over the card's memory: skip the cell
U_CEILING = 1024            # the sweep's largest batch
LABELS = {"bf16": ("bf16", False), "q5": ("q5", False), "q5_kv8": ("q5", True)}


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def preset_hparams(preset: str) -> WhisperHParams:
    """A preset's dimensions; "tiny-test" is the tests' micro model."""
    if preset == "tiny-test":
        from whisper_tpu_torch.checkpoint.init import tiny_test_hparams
        return tiny_test_hparams()
    return PRESET_HPARAMS[preset]


def analytic_roofline() -> dict:
    """Per-preset bounds from the shapes (tools/hbm_audit.analytic, on
    H100 SXM constants): the encoder bound by its FLOPs at 989 TFLOP/s,
    a decode step by the bytes it must move at 3.35 TB/s. `sol_ms` is the
    least time, `expected_ms` a modelled one (50 % of the FLOP rate, 70 %
    of the memory rate); vs_v100_* divides the reference's measured V100
    times by them. spec_dec_sol_ms: speculative greedy with a 2-layer
    draft, k = 8 proposals a round and 4 tokens accepted a round."""
    k_spec, m_bar = 8, 4.0
    out = {}
    for preset, (d, le, ld) in PRESET_DIMS.items():
        hp = PRESET_HPARAMS[preset]
        if (hp.n_text_state, hp.n_audio_layer, hp.n_text_layer) != (d, le, ld):
            raise ValueError(f"{preset}: PRESET_DIMS {d, le, ld} differ from its hparams")
        one, five = analytic(hp), analytic(hp, rows=5)
        draft = analytic(dataclasses.replace(hp, n_text_layer=2))
        enc_sol, dec_sol = one["enc_bound_ms"], one["step_bound_ms"]
        bch5_sol = five["step_bound_ms"] / 5
        # prompt processing: the batched products per token, bound by FLOPs
        pp_flops = 2 * (14 * ld * d * d + 2 * ld * hp.n_audio_ctx * d)
        pp_sol = pp_flops / H100_BF16_FLOPS * 1e3
        enc_exp, dec_exp, bch5_exp = enc_sol / ENC_EFF, dec_sol / DEC_EFF, bch5_sol / DEC_EFF
        # a speculative round reads the main step's bytes once and the
        # draft's weights and cross-KV k times
        spec_gb = one["step_gb"] + k_spec * (draft["weights_gb"] + draft["cross_kv_gb"])
        row = {
            "enc_gflops": one["enc_gflops"],
            "dec_gb_per_tok": one["step_gb"],
            "bch5_step_gb": five["step_gb"],
            "pp_gflops": pp_flops / 1e9,
            "spec_dec_sol_ms": spec_gb * 1e9 / m_bar / H100_HBM_BYTES_PER_S * 1e3,
            "sol_ms": {"enc": enc_sol, "dec": dec_sol, "bch5": bch5_sol, "pp": pp_sol},
            "expected_ms": {"enc": enc_exp, "dec": dec_exp, "bch5": bch5_exp,
                            "modelled": f"{ENC_EFF:.0%} of the FLOP rate, "
                                        f"{DEC_EFF:.0%} of the memory rate"},
            "rtf_sol": 30.0 / ((enc_sol + N_TOK * dec_sol) / 1e3),
            "rtf_expected": 30.0 / ((enc_exp + N_TOK * dec_exp) / 1e3),
        }
        if preset in V100_MS:
            e, dec, b5 = V100_MS[preset]
            row["vs_v100_sol"] = {"enc": e / enc_sol, "dec": dec / dec_sol}
            row["vs_v100_expected"] = {"enc": e / enc_exp, "dec": dec / dec_exp}
            if b5 is not None:
                row["vs_v100_sol"]["bch5"] = b5 / bch5_sol
                row["vs_v100_expected"]["bch5"] = b5 / bch5_exp
        out[preset] = row
    return out


# ------------------------------------------------------------------ timing


def _seconds(fn: Callable[[], object], dev: torch.device) -> float:
    """Seconds of one call of fn: CUDA events around it on the card, the
    host clock on the CPU."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def slope_seconds(run: Callable[[int], object], n1: int, n2: int,
                  dev: torch.device) -> float:
    """Seconds per link of the chain run(n): (t(n2) - t(n1)) / (n2 - n1)
    after one warm call of run(1), so a chain's fixed cost cancels."""
    run(1)
    t1 = _seconds(lambda: run(n1), dev)
    t2 = _seconds(lambda: run(n2), dev)
    return (t2 - t1) / (n2 - n1)


def timing_probe(dev: torch.device) -> float:
    """The rate, in TFLOP/s, of chained size^3 bf16 products (4096 on the
    card, 256 on the CPU). Raises RuntimeError if it is not positive or
    passes PROBE_LIMIT times the card's bf16 peak: the timing is broken."""
    size = 4096 if dev.type == "cuda" else 256
    x = torch.ones((size, size), dtype=torch.bfloat16, device=dev)

    def run(n):
        a = x
        for _ in range(n):
            a = a @ a * (1.0 / size)
        return a

    t = slope_seconds(run, 2, 22, dev)
    tflops = 2 * size ** 3 / t / 1e12 if t > 0 else math.inf
    peak = H100_BF16_FLOPS / 1e12
    log(f"probe: {t * 1e3:.4f} ms/matmul -> {tflops:.1f} TFLOPs (peak {peak:.0f})")
    if not tflops <= PROBE_LIMIT * peak:
        raise RuntimeError(f"timing probe: {tflops} TFLOP/s from {t} s a product, above "
                           f"{PROBE_LIMIT} x the {peak} TFLOP/s peak: the timing is broken")
    return tflops


def mel_chain(x, fb, window, n_len: int, n: int):
    """n chained log-mels (audio/mel.py's device body) of the padded
    samples x: returns (x, the last log-mel)."""
    from whisper_tpu_torch.audio.mel import log_mel_padded
    out = None
    for _ in range(n):
        out = log_mel_padded(x, fb, window, n_len)
        x = x + out.max() * 1e-12          # chain dependency
    return x, out


def encode_chain(params, hp: WhisperHParams, mel, n: int, dtype=torch.bfloat16,
                 attn_fn=None):
    """n chained encodes of mel: returns (mel, the last encoder output)."""
    from whisper_tpu_torch.models.whisper import encoder_forward
    embed = None
    for _ in range(n):
        embed = encoder_forward(params, hp, mel, dtype, attn_fn)
        mel = mel + (embed.mean() * 1e-9).to(mel.dtype)
    return mel, embed


def cross_chain(params, hp: WhisperHParams, embed, n: int):
    """n chained cross-KV projections of embed: returns (embed, the last
    (cross_k, cross_v))."""
    from whisper_tpu_torch.models.whisper import cross_attention_kv
    kv = None
    for _ in range(n):
        kv = cross_attention_kv(params, hp, embed)
        embed = embed + (kv[1].mean() * 1e-9).to(embed.dtype)
    return embed, kv


def decode_chain(params, hp: WhisperHParams, kv, tok, cross_k, cross_v, n: int,
                 dtype=torch.bfloat16):
    """n single-token decoder steps from the (B, 1) tokens `tok` at
    positions 0..n-1, each step's argmax fed to the next, the cache `kv`
    written in place: returns the n (B, 1) tokens."""
    from whisper_tpu_torch.models.whisper import decoder_forward
    toks = []
    for i in range(n):
        logits, _, _ = decoder_forward(params, hp, tok, i, kv, cross_k, cross_v, dtype)
        tok = logits[:, -1:].argmax(-1)
        toks.append(tok)
    return toks


def pp_chain(params, hp: WhisperHParams, kv, toks, cross_k, cross_v, n: int,
             dtype=torch.bfloat16):
    """n prompt passes of the (1, T) chunk `toks` at position 0, the
    logits of its last row only: returns (toks, the last logits)."""
    from whisper_tpu_torch.models.whisper import decoder_forward
    logits = None
    for _ in range(n):
        logits, _, _ = decoder_forward(params, hp, toks, 0, kv, cross_k, cross_v, dtype,
                                       logit_rows=toks.shape[1] - 1)
        toks = torch.where(logits[0, 0, 0] > 1e30, toks + 1, toks)   # chain dependency
    return toks, logits


def timed_phases(preset: str, dev: torch.device, seed: int = 0,
                 dtype=torch.bfloat16) -> dict:
    """The six timed phases (module docstring) at a preset on `dev`: ms of
    each, the calls each chain made (warm call included), the kernel
    launches (B1, B2, B3) each made, and the audio-s per s they imply."""
    from whisper_tpu_torch.audio import mel as mel_mod
    from whisper_tpu_torch.checkpoint.init import random_model
    from whisper_tpu_torch.models.whisper import KVCache
    from whisper_tpu_torch.tools.programs import _flash

    hp = preset_hparams(preset)
    t0 = time.perf_counter()
    model = random_model(preset, seed=seed, hp=hp, device=dev)
    params = model.params
    res = {"weights_s": time.perf_counter() - t0, "ms": {}, "calls": {}, "launches": {}}
    attn = _flash(dev)

    def phase(name, run, n1, n2, per=1, fmt="{:.2f} ms"):
        before = launch_counts()
        res["ms"][name] = slope_seconds(run, n1, n2, dev) / per * 1e3
        res["calls"][name] = 1 + n1 + n2
        res["launches"][name] = {k: n - before[k] for k, n in launch_counts().items()}
        log(f"{name}: " + fmt.format(res["ms"][name]))

    padded, n_len, _ = mel_mod.padded_frames_input(np.zeros(30 * 16000, np.float32))
    x0 = torch.from_numpy(padded).to(dev)
    fb = torch.from_numpy(np.ascontiguousarray(model.mel_filters, np.float32)).to(dev)
    window = torch.from_numpy(mel_mod.hann_window()).to(dev)
    phase("mel", lambda n: mel_chain(x0, fb, window, n_len, n), 1, 5)

    mel_in = torch.zeros((1, hp.n_mels, 2 * hp.n_audio_ctx), dtype=dtype, device=dev)
    phase("encode", lambda n: encode_chain(params, hp, mel_in, n, dtype, attn), 1, 41)
    embed0 = encode_chain(params, hp, mel_in, 1, dtype, attn)[1]
    phase("cross-kv", lambda n: cross_chain(params, hp, embed0, n), 1, 41)
    ck0, cv0 = cross_chain(params, hp, embed0, 1)[1]

    for name, batch, fmt in (("decode", 1, "{:.3f} ms/token"), ("bch5", 5, "{:.3f} ms/step")):
        kv = KVCache.zeros(hp, batch, dtype, device=dev)
        tok = torch.zeros((batch, 1), dtype=torch.long, device=dev)
        phase(name, lambda n: decode_chain(params, hp, kv, tok, ck0, cv0, n, dtype),
              32, 256, fmt=fmt)

    pp_len = 64
    kv_pp = KVCache.zeros(hp, 1, dtype, device=dev)
    prompt = torch.zeros((1, pp_len), dtype=torch.long, device=dev)
    phase("pp", lambda n: pp_chain(params, hp, kv_pp, prompt, ck0, cv0, n, dtype),
          4, 36, per=pp_len, fmt="{:.4f} ms/token")
    ms = res["ms"]
    res["audio_s_per_s"] = 30.0 / ((ms["mel"] + ms["encode"] + ms["cross-kv"]
                                    + N_TOK * ms["decode"]) / 1e3)
    res["encoder_layers"] = hp.n_audio_layer
    return res


# -------------------------------------------------------- memory and capacity


def _free_cached(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def largev3_beam5_check(dev: torch.device, hp: Optional[WhisperHParams] = None) -> dict:
    """The beam-5 window in bf16 and int8 blocks, the encoder at batch 1
    and the speculative window (k = 8, a 2-layer draft) at large-v3's
    width (or hp's) under programs.memory_summary, and tools/hbm_audit's
    tally of one beam-5 bf16 step against the analytic bytes
    (hbm_step_gb)."""
    from whisper_tpu_torch.tools import hbm_audit, programs

    a = programs.lv3_abstract(hp=hp)
    out = {}
    for key, prog in (("decode_window_beam5", programs.decode_window(a, beam_size=5)),
                      ("decode_window_beam5_q5",
                       programs.decode_window(a, quantized=True, beam_size=5)),
                      ("encoder", programs.encoder(a, 1)),
                      ("decode_window_speculative_k8", programs.speculative(a, k_spec=8))):
        t0 = time.perf_counter()
        out[key] = programs.memory_summary(prog, dev)
        out[key]["seconds"] = time.perf_counter() - t0
        _free_cached(dev)
    aud = hbm_audit.audit_decode_step(beam=5, device=dev, hp=hp)
    _free_cached(dev)
    out["decode_window_beam5"]["hbm_audit"] = {
        k: aud[k] for k in ("per_token_gb", "step_total_gb", "ratio_to_analytic", "step_ms",
                            "gb_per_s", "by_class_gb", "launches_tallied_run")}
    out["decode_window_beam5"]["hbm_audit"]["outer_gb"] = aud["token_body"]["gb"]
    out["decode_window_beam5"]["hbm_audit"]["layer_gb"] = aud["layer_body"]["gb"]
    model_gb = aud["analytic"]["step_gb"]
    out["hbm_step_gb"] = {"tally": aud["per_token_gb"], "model": model_gb,
                          "ratio": aud["per_token_gb"] / model_gb}
    out["hbm_peak_gb"] = out["decode_window_beam5"]["hbm_peak_gb"]
    dw = out["decode_window_beam5"]
    log(f"large-v3 beam-5 decode_window: args {dw['args_gb']:.3f} GiB, peak "
        f"{dw['hbm_peak_gb']} GiB; step tallied {aud['per_token_gb']:.3f} GB against "
        f"{model_gb:.3f} GB modelled")
    return out


def capacity_search(cell: Callable[[int], Optional[dict]], card_gib: float,
                    ceiling: int = U_CEILING) -> dict:
    """The largest batch U whose cell fits in card_gib: cell(U) runs the
    program at U and returns its row (hbm_peak_gb in GiB), or None where
    it ran out of memory; it fits when it ran and its peak is within
    card_gib. U doubles from 4 until a cell does not fit (at most
    `ceiling`), then a bisection pins the boundary. A cell whose peak,
    extrapolated from the last two that ran, passes SKIP_FACTOR x card_gib
    is not run (skipped_predicted_oom). Returns max_utt, exact (the cell
    just above max_utt did not fit: overflowed, ran out of memory or was
    skipped by prediction), stopped_at_ceiling and the rows by U."""
    rows: Dict[int, dict] = {}
    peaks: Dict[int, float] = {}

    def predict(u):
        if len(peaks) < 2:
            return None
        u1, u2 = sorted(peaks)[-2:]
        return peaks[u2] + (peaks[u2] - peaks[u1]) / (u2 - u1) * (u - u2)

    def probe(u):
        if u in rows:
            return rows[u]
        est = predict(u)
        if est is not None and est > SKIP_FACTOR * card_gib:
            row = {"skipped_predicted_oom": True, "hbm_predicted_gb": est, "fits": False}
            log(f"capacity u{u}: skipped (predicted {est:.1f} GiB > {SKIP_FACTOR} x "
                f"{card_gib:.1f})")
        else:
            got = cell(u)
            if got is None:
                row = {"out_of_memory": True, "hbm_predicted_gb": est, "fits": False}
            else:
                row = dict(got, fits=got["hbm_peak_gb"] <= card_gib)
                peaks[u] = got["hbm_peak_gb"]
            log(f"capacity u{u}: " + ("out of memory" if got is None else
                                      f"peak {got['hbm_peak_gb']:.2f} GiB, fits "
                                      f"{row['fits']}"))
        rows[u] = row
        return row

    u, lo, hi = 4, 0, None
    while hi is None and u <= ceiling:
        if probe(u)["fits"]:
            lo, u = u, u * 2
        else:
            hi = u
    while hi is not None and hi - lo > 1:
        mid = (lo + hi) // 2
        if probe(mid)["fits"]:
            lo = mid
        else:
            hi = mid
    return {"max_utt": lo, "exact": hi == lo + 1, "stopped_at_ceiling": hi is None,
            "cells": rows}


def batch_capacity_check(dev: torch.device, labels=tuple(LABELS)) -> dict:
    """The capacity sweep (module docstring) on the card: per label the
    largest batch of beam-5 utterances the card holds (max_utt_card), its
    exactness, its cells, the kernel launches of its cells, the modelled
    throughput there (rtf_chip_at_max_<label>) and the one from the
    tallied step at that batch (rtf_chip_tally_at_max_<label>); then the
    batched encoder at the largest batch found. At large-v3's width."""
    from whisper_tpu_torch.tools import hbm_audit, programs

    if dev.type != "cuda":
        raise InitError("the capacity sweep measures a card's memory: it needs a card")
    a = programs.lv3_abstract()
    hp = a.hp
    card_gib = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
    enc_exp_s = analytic(hp)["enc_gflops"] * 1e9 / (ENC_EFF * H100_BF16_FLOPS)

    def rtf_chip(u, step_gb):
        step_s = step_gb * 1e9 / (DEC_EFF * H100_HBM_BYTES_PER_S)
        return u * 30.0 / (u * enc_exp_s + N_TOK * step_s)

    out = {"rows_per_utt": K_ROWS, "card_gib": card_gib, "sweep": {}, "launches": {},
           "max_utt_card": {}}
    for label in labels:
        weights, kvq = LABELS[label]
        kv = "int8" if kvq else "bf16"

        def cell(u):
            prog = programs.batch_decode(a, u, weights, kv_quant=kvq, n_per_utt=K_ROWS)
            t0 = time.perf_counter()
            try:
                row = programs.memory_summary(prog, dev)
            except torch.cuda.OutOfMemoryError:
                row = None      # the exception and its frames go with this block
            _free_cached(dev)
            if row is not None:
                row["seconds"] = time.perf_counter() - t0
            return row

        before = launch_counts()
        t0 = time.perf_counter()
        found = capacity_search(cell, card_gib)
        out["launches"][label] = {k: n - before[k] for k, n in launch_counts().items()}
        out["sweep"][label] = {f"u{u}": r for u, r in sorted(found["cells"].items())}
        u_max = found["max_utt"]
        out["max_utt_card"][label] = u_max
        out[f"max_exact_{label}"] = found["exact"]
        out[f"stopped_at_ceiling_{label}"] = found["stopped_at_ceiling"]
        out[f"sweep_s_{label}"] = time.perf_counter() - t0
        if u_max:
            ana = analytic(hp, weights, kv, rows=u_max * K_ROWS, n_utt=u_max)
            out[f"rtf_chip_at_max_{label}"] = rtf_chip(u_max, ana["step_gb"])
            aud = hbm_audit.audit_decode_step("large-v3", weights, kv, beam=K_ROWS,
                                              n_utt=u_max, device=dev)
            _free_cached(dev)
            out[f"step_gb_tally_at_max_{label}"] = aud["per_token_gb"]
            out[f"step_gb_model_at_max_{label}"] = ana["step_gb"]
            out[f"step_ms_at_max_{label}"] = aud["step_ms"]
            out[f"rtf_chip_tally_at_max_{label}"] = rtf_chip(u_max, aud["per_token_gb"])
        log(f"capacity {label}: {u_max} utterances of {K_ROWS} rows in {card_gib:.2f} GiB "
            f"(exact {found['exact']})")

    # the batched encoder at the largest capacity found
    u_enc = max(out["max_utt_card"].values(), default=0) or 16
    t0 = time.perf_counter()
    out[f"encoder_b{u_enc}"] = programs.memory_summary(programs.encoder(a, u_enc), dev)
    out[f"encoder_b{u_enc}"]["seconds"] = time.perf_counter() - t0
    _free_cached(dev)
    return out


# -------------------------------------------------------------------- the run


def run(preset: str, dev: torch.device, lv3: bool = True, batch: bool = True,
        labels=tuple(LABELS), detail_path: Optional[pathlib.Path] = None):
    """The whole harness at `preset` on `dev`: returns (line, detail),
    the JSON line's dict and the detail's, and writes the detail to
    detail_path (default chiprun_out/bench_detail_<preset>.json)."""
    from whisper_tpu_torch.tools.micro_bench import card as card_line
    cuda = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    card = card_line() if cuda else None
    log(f"bench: device={name} ({card}), preset={preset}")
    probe = timing_probe(dev)
    phases = timed_phases(preset, dev)
    rtf = phases["audio_s_per_s"]
    baseline = BASELINE_RTF.get(preset, 1.0)
    log(f"RTF (audio-s/s/chip): {rtf:.2f}  baseline({preset} GPU): {baseline}")
    line = {
        "metric": f"audio_s_per_s_chip_{preset}_greedy",
        "value": round(rtf, 3),
        "unit": "audio-seconds/s/chip",
        "vs_baseline": round(rtf / baseline, 4),
        "device": name, "card": card,
        "probe_tflops": round(probe, 1),
        "ms": {k: round(v, 4) for k, v in phases["ms"].items()},
    }
    detail = {"primary": dict(line), "probe_tflops": probe, "phases": phases,
              "analytic": analytic_roofline()}
    if lv3:
        lv = detail["largev3_beam5"] = largev3_beam5_check(dev)
        line["largev3_beam5_hbm_gb"] = (None if lv["hbm_peak_gb"] is None
                                        else round(lv["hbm_peak_gb"], 3))
        line["hbm_step_gb"] = {k: round(v, 4) for k, v in lv["hbm_step_gb"].items()}
    if batch:
        if cuda:
            bc = detail["batch_capacity"] = batch_capacity_check(dev, labels)

            def r(key):
                return None if bc.get(key) is None else round(bc[key], 2)

            line["batch_capacity"] = {
                "max_utt_card": bc["max_utt_card"], "card_gib": round(bc["card_gib"], 2),
                "exact": {lb: bc[f"max_exact_{lb}"] for lb in labels},
                **{f"rtf_chip_{lb}": r(f"rtf_chip_at_max_{lb}") for lb in labels},
                **{f"rtf_tally_{lb}": r(f"rtf_chip_tally_at_max_{lb}") for lb in labels}}
        else:
            detail["batch_capacity"] = {"skipped": "the sweep measures a card's memory; "
                                                   "the CPU has none to measure"}
    line["analytic_rtf_expected_large_v3_beam5"] = round(
        detail["analytic"]["large-v3"]["rtf_expected"], 1)
    path = pathlib.Path(detail_path or ROOT / "chiprun_out" / f"bench_detail_{preset}.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(detail, indent=1))
    line["detail_file"] = str(path)
    log("detail -> " + str(path))
    return line, detail


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m whisper_tpu_torch.tools.bench")
    ap.add_argument("--preset", default="tiny",
                    help="a model preset, or tiny-test (the tests' micro model)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (not the card's times)")
    ap.add_argument("--no-lv3", action="store_true", help="skip the large-v3 beam-5 check")
    ap.add_argument("--no-batch", action="store_true", help="skip the capacity sweep")
    ap.add_argument("--detail", type=pathlib.Path, default=None,
                    help="where the detail goes (default chiprun_out/bench_detail_<P>.json)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise InitError("no CUDA device; pass --cpu to run on the CPU")
    dev = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    line, _ = run(args.preset, dev, lv3=not args.no_lv3, batch=not args.no_batch,
                  detail_path=args.detail)
    text = json.dumps(line)
    log(f"stdout line: {len(text)} bytes")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
