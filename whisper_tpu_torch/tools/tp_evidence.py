"""Tensor-parallel evidence at a preset's width: per-rank memory and
collectives.

Counterpart of whisper_tpu/tools/tp_evidence.py. The JAX package compiles
the sharded programs from shapes and reads XLA's per-device memory
analysis and the collectives in the HLO. The port runs them: each report
starts its ranks under torch.distributed (gloo on the CPU; gloo on one
shared card, where NCCL refuses two ranks; one NCCL rank per card where
there are cards for them), each rank builds the program's random weights
from the seed (tools/programs.py), cuts its shard with
parallel/mesh.py's shard_params and runs the program on it, and reports
with the keys of the JAX `_report`:

- args_gb: the rank's weights and inputs; on the card temp_gb, the most
  allocated above them during the run, and hbm_peak_gb, the most
  allocated (torch.cuda.max_memory_allocated; the rank holds nothing
  else);
- collectives: the count of each kind, counted at the port's two funnels
  (models/whisper.py tp_all_reduce and tp_all_gather, where every
  tensor-parallel collective goes), with their bytes, and per decoder
  call (the marked decoder blocks of tools/hbm_audit.py count the calls).

The reports:

- `tp_evidence(tp, preset, beam)`: the (1, tp) mesh, bf16; one encode
  (encoder + cross-KV) of one window, then the batched beam-`beam`
  window decode of that utterance (decoding/batch_loop.py), capped at
  one step after the prompt pass;
- `spec_tp_evidence(tp, preset, k_spec)`: speculative greedy
  (decoding/speculative.py) with the main model over the (1, tp) mesh and
  a 2-layer distil-shaped draft replicated, capped at k_spec - 1 tokens
  (one round when every proposal is accepted). The main model's token
  embedding is sharpened x 8 (random weights then give decisive argmaxes)
  and the draft is its first and last decoder layers over that embedding,
  so it proposes what the main model picks, as a distilled draft would.
  Rank 0 first runs the same window un-meshed, and each rank's stream
  must equal it. Random cross-KV stands in for the encode (the JAX
  program takes it as an argument too);
- `capacity_tp_evidence(dp, tp, n_utt, preset)`: the (dp, tp) mesh with
  int8-block weights over "model", the n_utt utterances over "data"
  (each data coordinate decodes its local_batch_slice), int8 self- and
  cross-KV, beam 5, random cross-KV.

Under gloo on one card every collective goes through the host: counts and
bytes are the evidence there, not times.

    python -m whisper_tpu_torch.tools.tp_evidence [--preset P] [--cpu]

prints the reports as one JSON list (TP = 1, 2, 4 where the heads
divide, the speculative report at TP = 2, the capacity report at 2 x 2),
in the shape of the JAX package's MULTICHIP_TP files, and writes no file
into the repository. Without --cpu it runs on the card and raises
InitError without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import tempfile
from typing import List, Optional

import torch
import torch.distributed as dist

from whisper_tpu_torch.config import PRESET_HPARAMS, WhisperHParams
from whisper_tpu_torch.models import whisper as model_mod
from whisper_tpu_torch.parallel import distributed
from whisper_tpu_torch.parallel import mesh as mesh_mod
from whisper_tpu_torch.tools import programs
from whisper_tpu_torch.tools.hbm_audit import LayerMarks

ROOT = pathlib.Path(__file__).resolve().parents[2]
RANK_TIMEOUT = 900          # seconds for a report's ranks
SHARPEN = 8.0


# ---- the parent: start a report's ranks, gather their outputs ----------------


def _start(report: str, world: int, kw: dict, device: str, tmp: pathlib.Path) -> dict:
    """Start the ranks of one report (each a `python -m` of this module)."""
    job = {"report": report, "outs": [], "procs": []}
    rdv = tmp / f"{report}_{world}_{len(list(tmp.iterdir()))}.rdv"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
        "OMP_NUM_THREADS": "1"}
    for r in range(world):
        out = rdv.with_suffix(f".rank{r}.json")
        job["outs"].append(out)
        job["procs"].append(subprocess.Popen(
            [sys.executable, "-m", "whisper_tpu_torch.tools.tp_evidence", "--worker", report,
             f"file://{rdv}", str(world), str(r), device, json.dumps(kw), str(out)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return job


def _finish(job: dict) -> List[dict]:
    """Wait for a report's ranks (each must exit 0 in RANK_TIMEOUT) and
    return their outputs in rank order."""
    logs = []
    try:
        for p in job["procs"]:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in job["procs"]:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(job["procs"], logs)):
        if p.returncode != 0:
            raise RuntimeError(f"{job['report']} rank {r} exited {p.returncode}:\n{log[-4000:]}")
    return [json.loads(o.read_text()) for o in job["outs"]]


def _hp_kw(hp) -> Optional[dict]:
    return None if hp is None else dataclasses.asdict(hp)


def run_reports(specs: List[tuple], device: str = "cuda") -> List[dict]:
    """Run several reports at once: `specs` is a list of (report, world,
    kwargs); returns each report's result (its ranks' outputs merged) in
    order. Their ranks run side by side, each report over its own
    rendezvous."""
    with tempfile.TemporaryDirectory(prefix="tp_evidence_") as tmp:
        jobs = [_start(rep, world, kw, device, pathlib.Path(tmp)) for rep, world, kw in specs]
        return [_merge(job["report"], _finish(job)) for job in jobs]


def _merge(report: str, ranks: List[dict]) -> dict:
    """Rank 0's report at the top (the JAX keys), every rank's under
    "ranks"; the speculative report's stream check over all ranks."""
    out = dict(ranks[0])
    out["ranks"] = ranks
    if report == "spec":
        ref = ranks[0]["unmeshed_stream"]
        out["stream_equal"] = all(r["stream"] == ref for r in ranks)
    return out


def tp_evidence(tp: int, preset: str = "large-v3", beam: int = 5, device: str = "cuda",
                hp=None, seed: int = 0) -> dict:
    """The encoder and the batched beam-`beam` window decode over the
    (1, tp) mesh (module docstring)."""
    return run_reports([("tp", tp, dict(tp=tp, preset=preset, beam=beam, seed=seed,
                                        hp=_hp_kw(hp)))], device)[0]


def spec_tp_evidence(tp: int = 2, preset: str = "large-v3", k_spec: int = 8,
                     device: str = "cuda", hp=None, seed: int = 0,
                     dtype: str = "bfloat16") -> dict:
    """Speculative greedy with the main model over the (1, tp) mesh and
    the draft replicated (module docstring)."""
    return run_reports([("spec", tp, dict(tp=tp, preset=preset, k_spec=k_spec, seed=seed,
                                          dtype=dtype, hp=_hp_kw(hp)))], device)[0]


def capacity_tp_evidence(dp: int = 2, tp: int = 2, n_utt: int = 8, preset: str = "large-v3",
                         device: str = "cuda", hp=None, seed: int = 0) -> dict:
    """int8-block weights over "model", the utterances over "data", int8
    self- and cross-KV (module docstring)."""
    return run_reports([("capacity", dp * tp, dict(dp=dp, tp=tp, n_utt=n_utt, preset=preset,
                                                   seed=seed, hp=_hp_kw(hp)))], device)[0]


# ---- a rank ------------------------------------------------------------------


class _Run:
    """One phase of a rank: its memory on the card and its collectives."""

    def __init__(self, dev: torch.device):
        self.dev = dev

    def __enter__(self):
        self.c0 = self._coll()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            self.base = torch.cuda.memory_allocated(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
        return self

    @staticmethod
    def _coll():
        return {"all-reduce": (model_mod.tp_all_reduce.calls, model_mod.tp_all_reduce.bytes),
                "all-gather": (model_mod.tp_all_gather.calls, model_mod.tp_all_gather.bytes)}

    def __exit__(self, *exc):
        c1 = self._coll()
        self.counts = {k: c1[k][0] - self.c0[k][0] for k in c1 if c1[k][0] > self.c0[k][0]}
        self.bytes = {k: c1[k][1] - self.c0[k][1] for k in c1 if c1[k][0] > self.c0[k][0]}
        self.temp_gb = self.peak_gb = None
        if self.dev.type == "cuda" and exc[0] is None:
            torch.cuda.synchronize(self.dev)
            peak = torch.cuda.max_memory_allocated(self.dev)
            self.temp_gb = (peak - self.base) / 2 ** 30
            self.peak_gb = peak / 2 ** 30

    def report(self, args_b: int, out_b: int, calls: int = 0) -> dict:
        r = {"args_gb": args_b / 2 ** 30, "temp_gb": self.temp_gb, "out_mb": out_b / 2 ** 20,
             "hbm_peak_gb": self.peak_gb, "collectives": self.counts,
             "collective_bytes": self.bytes}
        if calls:
            r["decoder_calls"] = calls
            r["collectives_per_decoder_call"] = {k: n / calls for k, n in self.counts.items()}
        return r


def _cut(t, dim: int, n: int, i: int):
    """Part i of n of a tensor (or of each tensor of an int8 KV tuple)
    along dim."""
    if isinstance(t, tuple):
        return tuple(_cut(x, dim, n, i) for x in t)
    return t.chunk(n, dim)[i].clone(memory_format=torch.contiguous_format) if n > 1 else t


def _free(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _rank_tp(kw, a, mesh, group, dev) -> dict:
    hp = a.hp
    enc = programs.encoder(a, 1)
    dec = programs.batch_decode(a, 1, "bf16", n_per_utt=kw["beam"], n_steps=1)
    eargs = enc.args(dev, kw["seed"])
    params = mesh_mod.shard_params(eargs.pop("params"), mesh, hp)
    _free(dev)
    params_b = programs.tree_bytes(params)
    with _Run(dev) as r_enc:
        embed, ck, cv = enc.run(dict(eargs, params=params, tp=group))
    out = {"params_gb": params_b / 2 ** 30,
           "encoder": r_enc.report(params_b + programs.tree_bytes(eargs),
                                   programs.tree_bytes((embed, ck, cv)))}
    del embed
    dargs = dict(dec.inputs(dev, kw["seed"]), cross_k=ck, cross_v=cv)
    marks = LayerMarks()
    with _Run(dev) as r_dec:
        res = dec.run(dict(dargs, params=marks.blocks(params), tp=group))
    out["decode_beam%d" % kw["beam"]] = r_dec.report(
        params_b + programs.tree_bytes(dargs), programs.tree_bytes(res), marks.calls)
    return out


def _draft_of(params) -> dict:
    """The draft: the main model's first and last decoder layers over its
    embedding (their cross-KV the main model's of those layers). It holds
    no reference to the other layers, which the shard then frees."""
    dec = params["decoder"]
    return {"decoder": dict(dec, blocks=[dec["blocks"][0], dec["blocks"][-1]])}


def _rank_spec(kw, a, mesh, group, dev, rank) -> dict:
    hp, k, n_model = a.hp, kw["k_spec"], mesh.size(1)
    dtype = a.abs_params["decoder"]["token_embed"].dtype
    prog = programs.speculative(a, k_spec=k, n_steps=k - 1, dtype=dtype)
    args = {"params": programs.materialize(a.abs_params, dev, kw["seed"]),
            **prog.inputs(dev, kw["seed"])}
    args["params"]["decoder"]["token_embed"].mul_(SHARPEN)
    args["params_draft"] = _draft_of(args["params"])
    args["draft_ck"], args["draft_cv"] = (t[[0, -1]] for t in (args["cross_k"], args["cross_v"]))

    def stream(res):
        return [int(t) for t in res.tokens[0][: res.n_tokens]]

    out = {}
    if rank == 0:
        ref = prog.run(args)
        out["unmeshed_stream"] = stream(ref)
        out["unmeshed_rounds"] = ref.n_rounds
    full_b = programs.tree_bytes(args["params"])
    args["params"] = mesh_mod.shard_params(args["params"], mesh, hp)
    i = mesh.get_local_rank("model")
    args["cross_k"], args["cross_v"] = (_cut(t, 2, n_model, i)
                                        for t in (args["cross_k"], args["cross_v"]))
    _free(dev)
    main_b = programs.tree_bytes(args["params"])
    draft_b = programs.tree_bytes(args["params_draft"])
    marks = LayerMarks()
    with _Run(dev) as run:
        res = prog.run(dict(args, params=marks.blocks(args["params"]), tp=group))
    out.update({
        "main_params_gb": main_b / 2 ** 30, "main_params_gb_unsharded": full_b / 2 ** 30,
        "draft_params_gb": draft_b / 2 ** 30, "stream": stream(res), "rounds": res.n_rounds,
        "decode_speculative": run.report(programs.tree_bytes(args), programs.tree_bytes(res),
                                         marks.calls)})
    return out


def _rank_capacity(kw, a, mesh, group, dev) -> dict:
    hp, dp, n_model = a.hp, mesh.size(0), mesh.size(1)
    part = distributed.local_batch_slice(kw["n_utt"], dp, mesh.get_coordinate()[0])
    n_local = part.stop - part.start
    prog = programs.batch_decode(a, n_local, "q5", kv_quant=True, n_per_utt=5, n_steps=1)
    args = prog.args(dev, kw["seed"])
    args["params"] = mesh_mod.shard_params(args["params"], mesh, hp)
    i = mesh.get_local_rank("model")
    args["cross_k"], args["cross_v"] = (_cut(t, 2, n_model, i)
                                        for t in (args["cross_k"], args["cross_v"]))
    _free(dev)
    H, dh = hp.n_text_head, hp.n_text_state // hp.n_text_head
    ck_full = 2 * hp.n_text_layer * kw["n_utt"] * H * hp.n_audio_ctx * (dh + 4)
    marks = LayerMarks()
    with _Run(dev) as run:
        res = prog.run(dict(args, params=marks.blocks(args["params"]), tp=group))
    return {"n_local": n_local, "params_gb": programs.tree_bytes(args["params"]) / 2 ** 30,
            "cross_kv_gb": programs.tree_bytes((args["cross_k"], args["cross_v"])) / 2 ** 30,
            "cross_kv_gb_unsharded": ck_full / 2 ** 30,
            "decode_beam5_capacity": run.report(programs.tree_bytes(args),
                                                programs.tree_bytes(res), marks.calls)}


def rank_main(report: str, init: str, world: int, rank: int, device: str, kw: dict,
              out_path: str) -> None:
    """One rank of a report: its output to out_path as JSON."""
    cuda = device == "cuda"
    nccl = cuda and torch.cuda.device_count() >= world
    dev = torch.device("cuda", rank if nccl else 0) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    distributed.init_distributed(init, world, rank, backend="nccl" if nccl else "gloo")
    hp = WhisperHParams(**kw["hp"]) if kw.get("hp") else PRESET_HPARAMS[kw["preset"]]
    dtype = torch.float32 if kw.get("dtype") == "float32" else torch.bfloat16
    a = programs.lv3_abstract(hp=hp, dtype=dtype)
    dp, tp = kw.get("dp", 1), kw["tp"]
    mesh = mesh_mod.make_mesh(dp, tp, device_type=dev.type)
    group = mesh_mod.model_group(mesh)
    head = {"preset": kw["preset"], "tp": tp, "rank": rank, "backend": dist.get_backend(),
            "device": str(dev),
            "device_name": torch.cuda.get_device_name(dev) if cuda else "cpu"}
    if report == "tp":
        body = _rank_tp(kw, a, mesh, group, dev)
    elif report == "spec":
        head["spec_k"] = kw["k_spec"]
        head["dtype"] = str(dtype).replace("torch.", "")
        body = _rank_spec(kw, a, mesh, group, dev, rank)
    elif report == "capacity":
        head.update(dp=dp, n_utt=kw["n_utt"], weights="q5", kv="int8")
        body = _rank_capacity(kw, a, mesh, group, dev)
    else:
        raise ValueError(f"unknown report {report!r}")
    pathlib.Path(out_path).write_text(json.dumps({**head, **body}))
    dist.destroy_process_group()


def run_all(preset: str = "large-v3", device: str = "cuda", hp=None, seed: int = 0) -> list:
    """Every report, in the JAX tool's order: TP = 1, 2, 4 (where the heads
    divide), then the speculative report at TP = 2 and the capacity report
    at DP = 2 x TP = 2 (run side by side)."""
    heads = (hp or PRESET_HPARAMS[preset]).n_text_head
    kw = dict(preset=preset, seed=seed, hp=_hp_kw(hp))
    degrees = [d for d in (1, 2, 4) if heads % d == 0]
    out = run_reports([("tp", d, dict(kw, tp=d, beam=5)) for d in degrees], device)
    if 2 in degrees:
        out += run_reports([("spec", 2, dict(kw, tp=2, k_spec=8, dtype="bfloat16")),
                            ("capacity", 4, dict(kw, dp=2, tp=2, n_utt=8))], device)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        report, init, world, rank, device, kw, out = argv[1:8]
        rank_main(report, init, int(world), int(rank), device, json.loads(kw), out)
        return 0
    ap = argparse.ArgumentParser(prog="python -m whisper_tpu_torch.tools.tp_evidence")
    ap.add_argument("--preset", default="large-v3")
    ap.add_argument("--cpu", action="store_true", help="run the ranks on the CPU")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        from whisper_tpu_torch.errors import InitError
        raise InitError("no CUDA device; pass --cpu to run the ranks on the CPU")
    print(json.dumps(run_all(args.preset, "cpu" if args.cpu else "cuda"), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
