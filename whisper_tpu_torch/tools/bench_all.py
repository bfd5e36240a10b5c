"""Run the port's harness (tools/bench.py) across model presets and print a
whisper.cpp-style table.

Counterpart of whisper_tpu/tools/bench_all.py: the reference's
scripts/bench-all.sh + scripts/bench.py (the output format of
bench-all-gg.txt: model | Enc. | Dec. | Bch5 | PP columns). Each preset
runs `python -m whisper_tpu_torch.tools.bench --preset P` in a process of
its own from the repository's root; --no-lv3, --no-batch and --cpu are
passed on to it.

    python -m whisper_tpu_torch.tools.bench_all [presets ...] [--no-lv3]
        [--no-batch] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys

DEFAULT_PRESETS = ["tiny", "base", "small"]
ROOT = pathlib.Path(__file__).resolve().parents[2]


def run_one(preset: str, timeout: int = 900, flags=()) -> dict:
    proc = subprocess.run(
        [sys.executable, "-m", "whisper_tpu_torch.tools.bench", "--preset", preset, *flags],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    out = {"preset": preset}
    if proc.returncode != 0:
        out["error"] = (f"exit {proc.returncode}: "
                        + proc.stderr.strip().splitlines()[-1][:200]
                        if proc.stderr.strip() else f"exit {proc.returncode}")
    for line in proc.stderr.splitlines():
        m = re.match(r"(mel|encode|cross-kv|decode|bch5|pp): ([0-9.]+) ms", line)
        if m:
            out[m.group(1)] = float(m.group(2))
    for line in proc.stdout.splitlines():
        try:
            doc = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(doc, dict):   # stray scalar JSON lines are not rows
            out.update(doc)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="whisper-tpu-torch-bench-all")
    ap.add_argument("presets", nargs="*", default=DEFAULT_PRESETS)
    ap.add_argument("--no-lv3", action="store_true", help="passed on to tools/bench.py")
    ap.add_argument("--no-batch", action="store_true", help="passed on to tools/bench.py")
    ap.add_argument("--cpu", action="store_true", help="passed on to tools/bench.py")
    args = ap.parse_args(argv)
    presets = args.presets or DEFAULT_PRESETS
    flags = [f for f, on in (("--no-lv3", args.no_lv3), ("--no-batch", args.no_batch),
                             ("--cpu", args.cpu)) if on]

    rows = []
    for p in presets:
        print(f"benchmarking {p}...", file=sys.stderr, flush=True)
        try:
            rows.append(run_one(p, flags=flags))
        except subprocess.TimeoutExpired:
            rows.append({"preset": p, "error": "timeout"})

    print(f"{'model':>16} | {'Enc. ms':>8} | {'Dec. ms':>8} | {'Bch5 ms':>8} | "
          f"{'PP ms':>8} | {'Mel ms':>8} | {'RTF':>8}")
    print("-" * 84)
    for r in rows:
        print(f"{r['preset']:>16} | {r.get('encode', float('nan')):8.2f} | "
              f"{r.get('decode', float('nan')):8.3f} | "
              f"{r.get('bch5', float('nan')):8.3f} | "
              f"{r.get('pp', float('nan')):8.4f} | "
              f"{r.get('mel', float('nan')):8.2f} | "
              f"{r.get('value', float('nan')):8.1f}"
              + (f"  ERROR: {r['error']}" if r.get("error") else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
