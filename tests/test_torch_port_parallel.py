"""Tensor and data parallelism in the PyTorch port (parallel/mesh.py,
parallel/distributed.py, models/whisper.py's `tp`, full_batch(mesh=...),
tools/dist_check.py) against the JAX package, on the CPU.

The ranks are processes over gloo: each test starts them with
`python -c`, rendezvous through a file under tmp_path (never a fixed TCP
port: the suite runs in several workers at once), one thread each, and a
timeout per process. Weights go across as the port's tree (params_from_jax
of the JAX package's), saved with torch.save. Tolerances are the f32 ones
the port is held to against the JAX package's unsharded model (2e-3
encoder, 3e-3 logits); token streams must be equal under the decisive
config."""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu as wt
import whisper_tpu_torch as pt
from whisper_tpu.checkpoint import ggml_io as j_ggml_io
from whisper_tpu.checkpoint import init as jinit
from whisper_tpu.checkpoint import loader as jloader
from whisper_tpu.checkpoint import quant as jquant
from whisper_tpu.config import WhisperHParams as JHParams
from whisper_tpu.decoding import batch_loop as jbl
from whisper_tpu.decoding import device_loop as jdl
from whisper_tpu.decoding import filters as jf
from whisper_tpu.models import whisper as jm
from whisper_tpu.parallel import distributed as jdist
from whisper_tpu_torch.checkpoint.from_jax import params_from_jax
from whisper_tpu_torch.checkpoint.init import random_params
from whisper_tpu_torch.checkpoint.loader import LoadedModel, load_model
from whisper_tpu_torch.config import WhisperHParams
from whisper_tpu_torch.errors import InitError
from whisper_tpu_torch.models import whisper as pm
from whisper_tpu_torch.parallel import distributed as pdist
from whisper_tpu_torch.parallel import mesh as pmesh
from whisper_tpu_torch.tools import dist_check

from test_ggml_io import _make_test_tensors

ROOT = pathlib.Path(__file__).resolve().parent.parent
RANK_TIMEOUT = 240          # seconds per rank process
ENC_TOL, LOGIT_TOL = 2e-3, 3e-3


def run_ranks(code: str, n: int, args, rdv: pathlib.Path):
    """Start n ranks of `code` (argv: init_method, n, rank, *args) and
    return their outputs; every rank must exit 0 within RANK_TIMEOUT."""
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", code, f"file://{rdv}", str(n), str(r),
                               *map(str, args)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out}"
    return outs


def wide4_hparams(cls=WhisperHParams):
    """dist_check's model: 4 heads of 64 (TP = 4 splits whole heads)."""
    return cls(**dist_check.hparams().__dict__)


# ------------------------------------------------------------ specs, shards

class FakeMesh:
    """The two things shard_params reads of a mesh, for one rank."""

    def __init__(self, n_model: int, rank: int):
        self.n_model, self.rank = n_model, rank

    def size(self, dim: int) -> int:
        return (1, self.n_model)[dim]

    def get_local_rank(self, dim: str) -> int:
        assert dim == "model"
        return self.rank


def leaves(tree, specs, path=""):
    """(path, leaf, spec) for every leaf; the two trees must match."""
    if isinstance(tree, dict):
        assert set(tree) == set(specs), (path, set(tree) ^ set(specs))
        for k in tree:
            yield from leaves(tree[k], specs[k], f"{path}.{k}")
    elif isinstance(tree, list):
        assert len(tree) == len(specs), path
        for i, (v, s) in enumerate(zip(tree, specs)):
            yield from leaves(v, s, f"{path}.{i}")
    else:
        assert isinstance(specs, tuple) and len(specs) == tree.ndim, (path, specs, tree.shape)
        yield path, tree, specs


def quantized_tree(tmp_path, hp, ttype):
    path = str(tmp_path / f"q{ttype}.bin")
    j_ggml_io.write_ggml(path, hp, np.zeros((hp.n_mels, 201), np.float32),
                         [b"t"] * 8, _make_test_tensors(hp, ttype=ttype))
    return load_model(path, "float32", keep_quantized=True).params


@pytest.mark.parametrize("layout,n_model", [("dense", 2), ("dense", 4), ("q5_1", 2),
                                            ("q5_1", 4), ("q6_k", 2)])
def test_shards_cover_every_leaf_and_concatenate_back(tmp_path, layout, n_model):
    hp = wide4_hparams()
    if layout == "dense":
        params = random_params(hp, seed=1, compute_dtype="float32")
    else:
        ttype = {"q5_1": jquant.GGML_TYPE_Q5_1, "q6_k": jquant.GGML_TYPE_Q6_K}[layout]
        params = quantized_tree(tmp_path, hp, ttype)
        blk = params["decoder"]["blocks"][0]
        assert blk["mlp_2"]["q"].dtype == torch.int8
        assert ("m" in blk["mlp_2"]) == (layout == "q5_1")
    specs = pmesh.param_specs(params, n_model=n_model)
    shards = [pmesh.shard_params(params, FakeMesh(n_model, r), hp) for r in range(n_model)]
    n_sharded = 0
    for path, leaf, spec in leaves(params, specs):
        parts = [next(x for p, x, _ in leaves(s, specs) if p == path) for s in shards]
        if "model" in spec:
            dim = spec.index("model")
            n_sharded += 1
            assert all(p.shape[dim] == leaf.shape[dim] // n_model and p.is_contiguous()
                       for p in parts), path
            assert torch.equal(torch.cat(parts, dim), leaf), path
        else:
            assert all(torch.equal(p, leaf) for p in parts), path
    enc0 = specs["encoder"]["blocks"][0]
    if layout == "dense":
        assert enc0["attn_q"] == {"w": ("model", None), "b": ("model",)}
        assert enc0["mlp_2"] == {"w": (None, "model"), "b": (None,)}
    else:
        lin = enc0["attn_out"]
        assert lin["q"] == lin["d"] == ("model", None) and lin["b"] == (None,)
        assert enc0["mlp_0"]["q"] == (None, "model")
        if layout == "q5_1":
            assert lin["m"] == ("model", None)
    assert specs["encoder"]["conv1"]["w"] == (None, None, None)      # replicated stem
    assert specs["decoder"]["token_embed"] == ("model", None)        # 51864 % 4 == 0
    # 10 linears a decoder layer, 6 an encoder layer, each with its sharded leaves
    assert n_sharded > 6 * hp.n_audio_layer + 10 * hp.n_text_layer


@pytest.mark.parametrize("n_vocab,n_model,sharded", [(51864, 4, True), (51865, 2, False),
                                                     (51866, 2, True), (51866, 4, False)])
def test_token_embedding_sharded_only_when_vocab_divides(n_vocab, n_model, sharded):
    params = {"decoder": {"token_embed": torch.zeros(n_vocab, 8), "blocks": []},
              "encoder": {"blocks": []}}
    spec = pmesh.param_specs(params, n_model=n_model)["decoder"]["token_embed"]
    assert spec == (("model" if sharded else None), None)


def test_shard_refusals(tmp_path):
    hp = WhisperHParams(**jinit.tiny_test_hparams().__dict__)   # 2 heads
    with pytest.raises(ValueError, match="whole heads"):
        pmesh.shard_params(random_params(hp, compute_dtype="float32"), FakeMesh(4, 0), hp)
    # 4 heads of 16 (width 64): attn_out's input shard of 16 rows is no whole qblock
    hp4 = WhisperHParams(**{**hp.__dict__, "n_audio_head": 4, "n_text_head": 4})
    q = quantized_tree(tmp_path, hp4, jquant.GGML_TYPE_Q8_0)
    with pytest.raises(ValueError, match="qblocks"):
        pmesh.shard_params(q, FakeMesh(4, 1), hp4)


def test_kv_and_batch_specs():
    hp = wide4_hparams()
    shape = (hp.n_text_layer, 6, hp.n_text_head, 512, 64)
    assert pmesh.shard_shape(shape, pmesh.kv_sharding(), 3, 2) == (3, 2, 2, 512, 64)
    assert pmesh.shard_shape(shape[:-1], pmesh.kv_scale_sharding(), 3, 2) == (3, 2, 2, 512)
    assert pmesh.shard_shape((6, 80, 3000), pmesh.batch_sharding(), n_data=2) == (3, 80, 3000)
    kv = pm.KVCache.zeros(hp, 6, quant=True)
    assert kv.k.shape == shape and kv.ks.shape == shape[:-1]


@pytest.mark.parametrize("n_parts", [1, 2, 3, 4])
def test_local_batch_slice_equals_jax(monkeypatch, n_parts):
    monkeypatch.setattr(jax, "process_count", lambda: n_parts)
    for b in range(10):
        got, seen = [], []
        for i in range(n_parts):
            monkeypatch.setattr(jax, "process_index", lambda i=i: i)
            want = jdist.local_batch_slice(b)
            assert pdist.local_batch_slice(b, n_parts, i) == want
            seen.extend(range(b)[want])
        assert seen == list(range(b))        # each utterance exactly once
    assert pdist.host_count() == 1 and pdist.local_batch_slice(5) == slice(0, 5)


# ------------------------------------------------- the sharded forward, 2 / 4 ranks

FORWARD = r"""
import sys, torch
torch.set_num_threads(1)
from whisper_tpu_torch.config import WhisperHParams
from whisper_tpu_torch.errors import InitError
from whisper_tpu_torch.models import whisper as pm
from whisper_tpu_torch.parallel import distributed, mesh as pmesh
init, n, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
distributed.init_distributed(init, n, rank, backend="gloo")
torch.cuda.is_available = lambda: False     # as on a host without a card
try:                                # a mesh is of cards unless asked otherwise
    pmesh.make_mesh(1, n)
    no_card = None
except InitError as e:
    no_card = str(e)
mesh = pmesh.make_mesh(1, n, "cpu")
tp = pmesh.model_group(mesh)
for src in sys.argv[4:]:
    blob = torch.load(src, weights_only=True)
    hp, q8 = WhisperHParams(**blob["hp"]), blob["kv_int8"]
    pm.tp_all_reduce.calls = pm.tp_all_gather.calls = 0
    params = pmesh.shard_params(blob["params"], mesh, hp)
    enc = pm.encoder_forward(params, hp, blob["mel"], torch.float32, tp=tp)
    ck, cv = pm.cross_attention_kv(params, hp, enc, quant=q8, tp=tp)
    toks = blob["toks"]
    kv = pm.KVCache.zeros(hp, toks.shape[0], torch.float32, quant=q8, tp=tp)
    lg0, kv, _ = pm.decoder_forward(params, hp, toks, 0, kv, ck, cv, torch.float32, tp=tp)
    lg1, kv, _ = pm.decoder_forward(params, hp, blob["step"], blob["pos"], kv, ck, cv,
                                    torch.float32, tp=tp)
    torch.save({"enc": enc, "lg0": lg0, "lg1": lg1, "kv": list(kv.k.shape),
                "all_reduce": pm.tp_all_reduce.calls, "all_gather": pm.tp_all_gather.calls,
                "no_card": no_card}, f"{src}.{rank}")
"""

FORWARD_CASES = {"tiny_tp2": 2, "q5_1_int8kv_tp2": 2, "wide4_tp4": 4}


def forward_case(tmp, case):
    """(JAX hparams, JAX params, inputs) of a sharded-forward case; the
    port's blob of them saved under tmp."""
    hp = wide4_hparams(JHParams) if case == "wide4_tp4" else jinit.tiny_test_hparams()
    q8 = case.startswith("q5_1")
    if q8:
        path = str(tmp / "q.bin")
        j_ggml_io.write_ggml(path, hp, np.zeros((hp.n_mels, 201), np.float32), [b"t"] * 8,
                             _make_test_tensors(hp, ttype=jquant.GGML_TYPE_Q5_1))
        jp = jloader.load_model(path, "float32", keep_quantized=True).params
    else:
        jp = jinit.random_params(hp, 2, "float32")
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    rng = np.random.default_rng(0)
    B = 2
    inputs = {"mel": rng.standard_normal((B, hp.n_mels, 2 * hp.n_audio_ctx)).astype(np.float32),
              "toks": rng.integers(0, hp.n_vocab, size=(B, 4)).astype(np.int32),
              "step": rng.integers(0, hp.n_vocab, size=(B, 1)).astype(np.int32),
              "pos": np.array([4, 3], np.int32)}     # per-row positions: the merged path
    torch.save({"hp": dict(hp.__dict__), "kv_int8": q8,
                "params": params_from_jax(jax.tree_util.tree_map(np.asarray, jp), hp),
                **{k: torch.from_numpy(v).long() if k != "mel" else torch.from_numpy(v)
                   for k, v in inputs.items()}},
               tmp / f"{case}.pt")
    return hp, jp, q8, inputs


@pytest.fixture(scope="module")
def sharded_forwards(tmp_path_factory):
    """Every case's inputs, and its ranks' outputs: one launch of 2 ranks
    for the TP = 2 cases and one of 4 for TP = 4."""
    tmp = tmp_path_factory.mktemp("forward")
    cases = {case: forward_case(tmp, case) for case in FORWARD_CASES}
    for n in (2, 4):
        run_ranks(FORWARD, n, [tmp / f"{c}.pt" for c, m in FORWARD_CASES.items() if m == n],
                  tmp / f"rdv{n}")
    return {case: (cases[case], [torch.load(tmp / f"{case}.pt.{r}", weights_only=True)
                                 for r in range(FORWARD_CASES[case])])
            for case in FORWARD_CASES}


@pytest.mark.parametrize("case", ["tiny_tp2", "wide4_tp4", "q5_1_int8kv_tp2"])
def test_sharded_forward_matches_jax_unsharded(sharded_forwards, case):
    """Encoder output, a prompt pass's logits (T = 4) and a per-row step's
    logits of the sharded model on n ranks, against the JAX package's
    unsharded forward; every rank returns the same bits."""
    (hp, jp, q8, inputs), outs = sharded_forwards[case]
    n, B = FORWARD_CASES[case], inputs["mel"].shape[0]
    enc_j = jm.encoder_forward(jp, hp, jnp.asarray(inputs["mel"]), jnp.float32)
    ck, cv = jm.cross_attention_kv(jp, hp, enc_j, quant=q8)
    kv = jm.KVCache.zeros(hp, B, jnp.float32, quant=q8)
    lg0, kv, _ = jm.decoder_forward(jp, hp, jnp.asarray(inputs["toks"]), jnp.int32(0), kv,
                                    ck, cv, jnp.float32)
    lg1, _, _ = jm.decoder_forward(jp, hp, jnp.asarray(inputs["step"]),
                                   jnp.asarray(inputs["pos"]), kv, ck, cv, jnp.float32)
    for name, want, tol in (("enc", enc_j, ENC_TOL), ("lg0", lg0, LOGIT_TOL),
                            ("lg1", lg1, LOGIT_TOL)):
        np.testing.assert_allclose(outs[0][name].numpy(), np.asarray(want), rtol=tol, atol=tol,
                                   err_msg=name)
        for o in outs[1:]:
            assert torch.equal(o[name], outs[0][name]), name
    assert outs[0]["kv"] == [hp.n_text_layer, B, hp.n_text_head // n, 512,
                             hp.n_text_state // hp.n_text_head]
    # 2 a layer in the encoder, 3 a layer in each of the 2 decoder calls,
    # + 1 embedding lookup a call (51864 divides by 2 and 4); logits gathered
    assert outs[0]["all_reduce"] == 2 * hp.n_audio_layer + 2 * (3 * hp.n_text_layer + 1)
    assert outs[0]["all_gather"] == 2
    # without device_type="cpu" a mesh is of cards: InitError with none
    assert all("no CUDA device" in o["no_card"] for o in outs)


# ------------------------------------------------------------ dist_check

@pytest.fixture(scope="module")
def dist_reference(tmp_path_factory):
    """dist_check's un-meshed decode (the workers' expectation), which
    must equal the JAX package's decode_windows_batch of the same model."""
    path = tmp_path_factory.mktemp("dist") / "ref.npz"
    dist_check.run_reference(str(path), use_gpu=False)
    ref = np.load(path)

    hp = wide4_hparams(JHParams)
    jctx = wt.WhisperContext.random(hp=hp, params=wt.ContextParams(dtype="float32"), seed=3)
    p = wt.FullParams.default()
    p.no_timestamps, p.max_tokens, p.suppress_regex = True, dist_check.MAX_TOKENS, \
        r"<syn\d\d\d+>"
    consts, tids = jf.build_filter_consts(jctx.vocab, hp, p)
    rng = np.random.default_rng(7)
    cks, cvs, n_len = [], [], []
    for _ in range(dist_check.N_UTT):
        st = jctx.create_state()
        st.pcm_to_mel((0.1 * rng.standard_normal(16000 * 2)).astype(np.float32))
        st.encode(0)
        cks.append(np.asarray(st.cross_k))
        cvs.append(np.asarray(st.cross_v))
        n_len.append(st.n_len_org)
    n = dist_check.N_UTT
    prompts = np.zeros((n, hp.n_text_ctx // 2 + 8), np.int32)
    prompts[:, 0] = jctx.vocab.token_sot
    jr = jbl.decode_windows_batch(
        jctx.params, hp, consts, jnp.asarray(np.concatenate(cks, 1)),
        jnp.asarray(np.concatenate(cvs, 1)), jnp.asarray(prompts), jnp.ones(n, jnp.int32),
        jnp.float32(0.0), jnp.zeros(n, jnp.int32), jnp.asarray(n_len, jnp.int32),
        jnp.ones(n, bool), jax.random.PRNGKey(0), tids=tids, n_utt=n, n_per_utt=1,
        strategy=jdl.GREEDY_BEST, max_tokens=dist_check.MAX_TOKENS, no_timestamps=True,
        dtype=jnp.float32)
    np.testing.assert_array_equal(ref["tokens"], np.asarray(jr.tokens))
    np.testing.assert_array_equal(ref["result_len"], np.asarray(jr.result_len))
    return path


WORKER = r"""
import sys, torch
torch.set_num_threads(1)
from whisper_tpu_torch.tools import dist_check
dist_check.main(["worker"] + sys.argv[1:])
"""


@pytest.fixture(scope="module")
def dist_workers(dist_reference):
    """One launch of 4 ranks on the CPU running the three topologies in
    turn, each rank checking its tokens against the reference."""
    return run_ranks(WORKER, 4, [dist_reference, "tp,dp,tp4", "-ng"],
                     dist_reference.parent / "rdv")


@pytest.mark.parametrize("topology", ["tp", "dp", "tp4"])
def test_dist_check_topologies(dist_workers, topology):
    for r, out in enumerate(dist_workers):
        assert f"TP_DIST_OK topology={topology} rank={r}" in out, out


def test_dist_check_takes_the_card_by_default(tmp_path, monkeypatch):
    """Without -ng the tool runs on the first card, and raises InitError
    where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(InitError, match="no CUDA device"):
        dist_check.main(["reference", str(tmp_path / "ref.npz")])
    assert not (tmp_path / "ref.npz").exists()


# ------------------------------------------------------ full_batch(mesh=...)

FULL_BATCH = r"""
import json, sys, numpy as np, torch
torch.set_num_threads(1)
import whisper_tpu_torch as pt
from whisper_tpu_torch.audio.mel import mel_filterbank
from whisper_tpu_torch.checkpoint.loader import LoadedModel
from whisper_tpu_torch.config import WhisperHParams
from whisper_tpu_torch.parallel import distributed
from whisper_tpu_torch.tokenizer import synthetic_vocab
init, n, rank, src = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
distributed.init_distributed(init, n, rank, backend="gloo")
blob = torch.load(src, weights_only=True)
hp = WhisperHParams(**blob["hp"])
ctx = pt.WhisperContext(LoadedModel(hp, blob["params"], mel_filterbank(hp.n_mels),
                                    synthetic_vocab(hp.n_vocab), -1),
                        pt.ContextParams(use_gpu=False, dtype="float32"))
# built for the mesh (1, 2): this rank's shard only, its mesh by default
sctx = pt.WhisperContext(LoadedModel(hp, blob["params"], mel_filterbank(hp.n_mels),
                                     synthetic_vocab(hp.n_vocab), -1),
                         pt.ContextParams(use_gpu=False, dtype="float32", mesh_shape=(1, 2)))
audios = [a.numpy() for a in blob["audios"]]
out = {"shard_rows": {k: list(v["w"].shape) for k, v in
                      sctx.params["encoder"]["blocks"][0].items() if "w" in v}}
try:
    sctx.full_batch(pt.FullParams.default(), audios, mesh=(2, 1))
except ValueError as e:
    out["other_mesh"] = str(e)
try:
    sctx.attach_draft(ctx)
except pt.api.InitError as e:
    out["draft"] = str(e)
for shape in ((2, 1), (1, 2), "own"):
    for beam in (0, 5):
        p = pt.FullParams.default(pt.SamplingStrategy.BEAM_SEARCH if beam
                                  else pt.SamplingStrategy.GREEDY)
        p.beam_search.beam_size = max(beam, 1)
        p.print_progress, p.temperature_inc, p.no_timestamps = False, 0.0, True
        p.max_tokens, p.suppress_regex = 12, r"<syn\d\d\d+>"
        stats, langs = {}, []
        segs = (sctx.full_batch(p, audios, stats=stats) if shape == "own"
                else ctx.full_batch(p, audios, mesh=shape, stats=stats))
        out[f"{shape}-{beam}"] = {
            "segs": [[(s.text, s.t0, s.t1, [t.id for t in s.tokens]) for s in u] for u in segs],
            "stats": stats}
json.dump(out, open(f"{src}.{rank}.json", "w"))
"""


@pytest.fixture(scope="module")
def meshed_batches(tmp_path_factory):
    """Two ranks run full_batch over the meshes (2, 1) and (1, 2), and on a
    context built with mesh_shape (1, 2), greedy and beam-5; the un-meshed
    full_batch of the same context in-process."""
    tmp = tmp_path_factory.mktemp("meshed")
    jctx = wt.WhisperContext.random(
        hp=jinit.tiny_test_hparams(), params=wt.ContextParams(dtype="float32"), seed=3)
    hp = jctx.hparams
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jctx.params), hp)
    rng = np.random.default_rng(5)
    audios = [(s * rng.standard_normal(16000 * n)).astype(np.float32)
              for s, n in ((0.1, 2), (0.2, 4), (0.05, 3))]
    src = tmp / "ctx.pt"
    torch.save({"hp": dict(hp.__dict__), "params": params,
                "audios": [torch.from_numpy(a) for a in audios]}, src)
    run_ranks(FULL_BATCH, 2, [src], tmp / "rdv")
    got = [json.load(open(f"{src}.{r}.json")) for r in range(2)]

    pctx = pt.WhisperContext(LoadedModel(WhisperHParams(**hp.__dict__), params,
                                         jctx.mel_filters, jctx.vocab, -1),
                             pt.ContextParams(use_gpu=False, dtype="float32"))
    want = {}
    for beam in (0, 5):
        p = pt.FullParams.default(pt.SamplingStrategy.BEAM_SEARCH if beam
                                  else pt.SamplingStrategy.GREEDY)
        p.beam_search.beam_size = max(beam, 1)
        p.print_progress, p.temperature_inc, p.no_timestamps = False, 0.0, True
        p.max_tokens, p.suppress_regex = 12, r"<syn\d\d\d+>"
        stats = {}
        segs = pctx.full_batch(p, audios, stats=stats)
        want[beam] = ([[[s.text, s.t0, s.t1, [t.id for t in s.tokens]] for s in u]
                       for u in segs], stats)
    return got, want


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
@pytest.mark.parametrize("beam", [0, 5])
def test_full_batch_mesh_equals_unmeshed(meshed_batches, shape, beam):
    got, want = meshed_batches
    segs, stats = want[beam]
    assert any(segs)
    for rank_out in got:                     # every rank returns the whole result
        run = rank_out[f"{shape}-{beam}"]
        assert run["segs"] == segs
        assert run["stats"]["admitted"] == stats["admitted"] == 3
        assert run["stats"]["n_lanes"] == 3
        assert (run["stats"]["n_data"], run["stats"]["n_model"]) == shape
        if shape == (1, 2):
            assert {k: v for k, v in run["stats"].items()
                    if k not in ("n_data", "n_model")} == stats


@pytest.mark.parametrize("beam", [0, 5])
def test_mesh_shape_context_holds_its_shard(meshed_batches, beam):
    """A context built with ContextParams.mesh_shape (1, 2) keeps half of
    each head-sharded weight, runs its own mesh by default, refuses
    another mesh and a draft, and returns the un-meshed segments on every
    rank."""
    got, want = meshed_batches
    hp = jinit.tiny_test_hparams()
    d = hp.n_audio_state
    for rank_out in got:
        assert rank_out["shard_rows"] == {"attn_q": [d // 2, d], "attn_k": [d // 2, d],
                                          "attn_v": [d // 2, d], "attn_out": [d, d // 2],
                                          "mlp_0": [2 * d, d], "mlp_2": [d, 2 * d]}
        assert "runs no other mesh" in rank_out["other_mesh"]
        assert "not meshed" in rank_out["draft"]
        run = rank_out[f"own-{beam}"]
        assert run["segs"] == want[beam][0]
        assert (run["stats"]["n_data"], run["stats"]["n_model"]) == (1, 2)
