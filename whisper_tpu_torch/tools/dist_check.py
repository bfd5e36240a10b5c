"""Cross-process checks of the batched decode under a mesh.

Counterpart of the JAX package's tools/dist_check.py. It runs the real
batched window decode (encoder, cross K/V, decoding/batch_loop.py's
decode_windows_batch) of 4 utterances on a seeded model, with the params
cut by parallel/mesh.py and the utterances split by
parallel/distributed.local_batch_slice, in 4 ranks over gloo (sharing the
first card, or on the CPU with -ng), in three topologies:

  tp   — the (2, 2) cross-host grid (make_cross_host_mesh): with ranks
         numbered host by host, 2 a host, every model group spans both
         hosts, so every tensor-parallel all-reduce crosses them;
  dp   — the (2, 2) production grid (make_mesh): model groups within a
         host, the data dim across hosts;
  tp4  — (1, 4): one model group of all four ranks.

Each rank's tokens and result lengths must equal those of the un-meshed
decode of the same inputs (`reference`). The decode runs the decisive
config (a suppress_regex that shrinks the candidates, no timestamps,
max_tokens = 8), under which the argmax gaps are far above the rounding
that a different summation order gives, so exact token equality is the
criterion. TP = 4 needs 4 heads, and the flash-attention kernel takes
head dim 64 only: the model is 2 + 3 layers at width 256 with 4 heads of
64, seeded.

    python -m whisper_tpu_torch.tools.dist_check reference <out.npz> [-ng]
    python -m whisper_tpu_torch.tools.dist_check worker <init_method> \\
        <n_procs> <rank> <expected.npz> [tp|dp|tp4[,...]] [-ng]

`init_method` is a torch.distributed URL (`file:///tmp/x` or
`tcp://localhost:<port>`); a comma-separated list of topologies runs each
in turn in the same process group. The model runs on the first card
(raising InitError without one); -ng runs it on the CPU.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

N_UTT = 4
MAX_TOKENS = 8
RANKS_PER_HOST = 2     # the tp and dp grids' ranks per (notional) host


def hparams():
    from whisper_tpu_torch.checkpoint.init import tiny_test_hparams
    hp = tiny_test_hparams()
    return type(hp)(**{**hp.__dict__, "n_audio_state": 256, "n_audio_head": 4,
                       "n_text_state": 256, "n_text_head": 4})


def decisive_params():
    from whisper_tpu_torch.config import FullParams
    p = FullParams.default()
    p.no_timestamps = True
    p.max_tokens = MAX_TOKENS
    p.suppress_regex = r"<syn\d\d\d+>"
    return p


def setup(use_gpu: bool = True):
    """The seeded model (float32), the filter constants of the decisive
    config, and the 4 utterances' first mel windows and seek ends, the
    same in every process."""
    import whisper_tpu_torch as pt
    from whisper_tpu_torch.decoding import filters

    ctx = pt.WhisperContext.random(
        hp=hparams(), params=pt.ContextParams(dtype="float32", use_gpu=use_gpu), seed=3)
    consts, tids = filters.build_filter_consts(ctx.vocab, ctx.hparams, decisive_params(),
                                               ctx.device)
    rng = np.random.default_rng(7)
    audios = [(0.1 * rng.standard_normal(16000 * 2)).astype(np.float32)
              for _ in range(N_UTT)]
    sts = [ctx.create_state() for _ in range(N_UTT)]
    for st, a in zip(sts, audios):
        st.pcm_to_mel(a)
    mel_batch = torch.cat([st.mel_window(0) for st in sts])
    seek_end = np.array([st.n_len_org for st in sts], np.int32)
    return ctx, consts, tids, mel_batch, seek_end


def decode(ctx, consts, tids, mel_batch, seek_end, mesh=None):
    """Encode + batched window decode of this rank's utterances: all of
    them without a mesh, else its data coordinate's local_batch_slice on
    its shard of the params. Returns (slice, BatchWindowResult)."""
    from whisper_tpu_torch.decoding import batch_loop, device_loop
    from whisper_tpu_torch.decoding.batch_full import mesh_view
    from whisper_tpu_torch.models import whisper as model_mod
    from whisper_tpu_torch.parallel import distributed

    part = slice(0, N_UTT)
    if mesh is not None:
        part = distributed.local_batch_slice(N_UTT, mesh.size(0), mesh.get_coordinate()[0])
        ctx = mesh_view(ctx, mesh)[1]
    hp = ctx.hparams
    n = part.stop - part.start
    attn_fn = None
    if ctx.use_flash:
        from whisper_tpu_torch.ops.flash_attention import flash_attention
        attn_fn = flash_attention
    prompts = np.zeros((n, hp.n_text_ctx // 2 + 8), np.int64)
    prompts[:, 0] = ctx.vocab.token_sot
    embed = model_mod.encoder_forward(ctx.params, hp, mel_batch[part], ctx.dtype, attn_fn,
                                      tp=ctx.tp)
    ck, cv = model_mod.cross_attention_kv(ctx.params, hp, embed, tp=ctx.tp)
    res = batch_loop.decode_windows_batch(
        ctx.params, hp, consts, ck, cv, prompts, np.ones(n, np.int64), 0.0,
        np.zeros(n, np.int32), seek_end[part], np.ones(n, bool),
        tids=tids, n_utt=n, n_per_utt=1, strategy=device_loop.GREEDY_BEST,
        max_tokens=MAX_TOKENS, no_timestamps=True, dtype=ctx.dtype, tp=ctx.tp)
    return part, res


def run_reference(out_path: str, use_gpu: bool = True) -> None:
    """One process, no mesh: the expectation of every topology."""
    _, res = decode(*setup(use_gpu))
    np.savez(out_path, tokens=res.tokens, result_len=res.result_len)
    print(f"REF_OK tokens={res.tokens.shape}", flush=True)


def build_mesh(topology: str, n_procs: int, device_type: str):
    """The mesh of a topology (module docstring), its layout checked."""
    from whisper_tpu_torch.parallel import mesh as mesh_mod

    def host(r):
        return int(r) // RANKS_PER_HOST

    if topology == "tp":
        mesh = mesh_mod.make_cross_host_mesh(2, n_procs // 2, device_type)
        for row in mesh.mesh.tolist():       # one model group per row
            assert len({host(r) for r in row}) == len(row), mesh.mesh
    elif topology == "dp":
        mesh = mesh_mod.make_mesh(n_procs // 2, 2, device_type)
        for row in mesh.mesh.tolist():
            assert len({host(r) for r in row}) == 1, mesh.mesh
        assert len({host(row[0]) for row in mesh.mesh.tolist()}) == n_procs // 2, mesh.mesh
    elif topology == "tp4":
        mesh = mesh_mod.make_cross_host_mesh(1, n_procs, device_type)
    else:
        raise SystemExit(f"unknown topology {topology!r}")
    return mesh


def run_worker(init_method: str, n_procs: int, rank: int, expected_npz: str,
               topologies: str = "tp", use_gpu: bool = True) -> None:
    """One rank: for each topology, its rows of tokens and result_len
    must equal the reference's."""
    from whisper_tpu_torch.parallel import distributed

    info = distributed.init_distributed(init_method, n_procs, rank, backend="gloo")
    assert info["process_count"] == n_procs, info
    state = setup(use_gpu)
    exp = np.load(expected_npz)
    for topology in topologies.split(","):
        mesh = build_mesh(topology, n_procs, "cuda" if use_gpu else "cpu")
        part, res = decode(*state, mesh=mesh)
        for name in ("tokens", "result_len"):
            np.testing.assert_array_equal(
                getattr(res, name), exp[name][part],
                err_msg=f"{name} rows {part} rank {rank} topology {topology}")
        print(f"TP_DIST_OK topology={topology} rank={rank} "
              f"coord={mesh.get_coordinate()} rows={part.start}:{part.stop}", flush=True)
    import torch.distributed as dist
    dist.destroy_process_group()


def main(argv) -> None:
    use_gpu = "-ng" not in argv
    argv = [a for a in argv if a != "-ng"]
    mode = argv[0]
    if mode == "reference":
        run_reference(argv[1], use_gpu)
    elif mode == "worker":
        run_worker(argv[1], int(argv[2]), int(argv[3]), argv[4],
                   argv[5] if len(argv) > 5 else "tp", use_gpu)
    else:
        raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    main(sys.argv[1:])
