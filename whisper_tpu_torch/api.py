"""Public API: WhisperContext / WhisperState.

Counterpart of whisper_tpu/api.py, mirroring the reference's Rust surface
(whisper-rs):
- WhisperContext: shared immutable model (src/whisper_ctx_wrapper.rs) —
  weights are read-only tensors on one device.
- WhisperState: per-stream mutable inference state
  (src/whisper_state.rs) — mel, encoder output, cross K/V, segments.

The model runs on cuda:{gpu_device} unless ContextParams(use_gpu=False)
asks for the CPU; with use_gpu=True and no CUDA device, the context
refuses to build. On CUDA with flash_attn set (the default), the encoder's
self-attention and the decoder's multi-row cross-attention (with a
compute-dtype cross-KV) run the hand-written flash-attention kernel
(ops/flash_attention.py). A checkpoint loaded with keep_quantized keeps its
block-format linear weights as int8 blocks, and every such linear runs the
hand-written quant_matmul kernels (ops/quant_matmul.py); kv_dtype="int8"
keeps the self- and cross-attention K/V as int8 codes with scales.

full() takes every FullParams option of single-stream decoding: VAD
(models/vad.py), language auto-detection (lang_detect), token-level
timestamps by the energy heuristic and by DTW (TokenData.t0 / t1 / t_dtw),
GBNF grammars and a logits_filter_callback. WhisperContext.full_batch and
WhisperState.full_parallel transcribe many utterances, or the chunks of
one, together through the batched path (decoding/batch_full.py). A draft
model (ContextParams.draft_model or WhisperContext.attach_draft) makes
full()'s greedy attempts speculative (decoding/speculative.py).
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from whisper_tpu_torch import config as cfg
from whisper_tpu_torch.audio import mel as mel_mod
from whisper_tpu_torch.checkpoint import init as init_mod
from whisper_tpu_torch.checkpoint import loader as loader_mod
from whisper_tpu_torch.config import ContextParams, FullParams, WhisperHParams
from whisper_tpu_torch.errors import InitError, WhisperError
from whisper_tpu_torch.models import whisper as model_mod
from whisper_tpu_torch.tokenizer import Tokenizer
from whisper_tpu_torch.utils.timings import Timings


@dataclasses.dataclass
class TokenData:
    """Per-token result (reference whisper_token_data, include/whisper.h:168-189)."""

    id: int
    tid: int          # forced timestamp token id
    p: float          # probability
    plog: float       # log prob
    pt: float         # prob of the timestamp token
    ptsum: float      # sum prob of all timestamp tokens
    t0: int = -1      # token-level start time (10 ms units)
    t1: int = -1
    t_dtw: int = -1   # DTW timestamp
    vlen: float = 0.0  # voice length


@dataclasses.dataclass
class Segment:
    """reference whisper_segment (src/whisper.cpp:494-503)."""

    t0: int           # centiseconds (10 ms units)
    t1: int
    text: str
    tokens: List[TokenData] = dataclasses.field(default_factory=list)
    speaker_turn_next: bool = False
    no_speech_prob: float = 0.0


def resolve_device(cp: ContextParams) -> torch.device:
    """cuda:{gpu_device} for use_gpu=True (raising when CUDA is absent),
    the CPU for use_gpu=False."""
    if not cp.use_gpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise InitError("use_gpu=True but no CUDA device is available; pass "
                        "ContextParams(use_gpu=False) to run on the CPU")
    if not 0 <= cp.gpu_device < torch.cuda.device_count():
        raise InitError(f"gpu_device {cp.gpu_device} out of range "
                        f"({torch.cuda.device_count()} CUDA devices)")
    return torch.device("cuda", cp.gpu_device)


def _load_device(cp: ContextParams) -> torch.device:
    """Where a constructor loads the weights: the context's device, or the
    CPU when mesh_shape splits the model, so that the card receives only
    its rank's shard."""
    device = resolve_device(cp)
    if cp.mesh_shape is not None and cp.mesh_shape[1] > 1:
        return torch.device("cpu")
    return device


class WhisperContext:
    """Immutable model container. With ContextParams.mesh_shape (every rank
    of the mesh builds it, after parallel.distributed.init_distributed)
    the context holds only this rank's shard of the weights, and its
    full_batch runs that mesh."""

    def __init__(self, model: loader_mod.LoadedModel,
                 params: Optional[ContextParams] = None):
        self.cparams = params or ContextParams()
        self.device = resolve_device(self.cparams)
        self.hparams = model.hparams
        self.vocab = model.vocab
        self.tokenizer = Tokenizer(model.vocab)
        self.mel_filters = model.mel_filters
        self.n_loaded = model.n_loaded
        self.dtype = loader_mod.torch_dtype(self.cparams.dtype)
        # int8 self- and cross-KV (ContextParams.kv_dtype)
        self.kv_quant = self.cparams.kv_dtype == "int8"
        # the mesh of ContextParams.mesh_shape and its model group (tensor
        # parallelism), else None; the sharded views other meshes make of a
        # whole context (decoding/batch_full.mesh_view)
        self.mesh = None
        self.tp = None
        self.mesh_views = {}
        params = model.params or {}
        if self.cparams.mesh_shape is not None:
            from whisper_tpu_torch.parallel import mesh as mesh_mod
            self.mesh = mesh_mod.make_mesh(*self.cparams.mesh_shape,
                                           device_type=self.device.type)
            self.tp = mesh_mod.model_group(self.mesh)
            if self.tp is not None:
                # cut on the host: only this rank's shard reaches the card
                params = mesh_mod.shard_params(
                    loader_mod.place_params(params, self.dtype, "cpu"), self.mesh,
                    self.hparams)
        # matmul weights in the compute dtype, int8 blocks as int8,
        # LayerNorm/bias in float32
        self.params = loader_mod.place_params(params, self.dtype, self.device)
        # the draft model of speculative greedy decoding
        # (decoding/speculative.py): attach_draft or ContextParams.draft_model
        self.draft: Optional["WhisperContext"] = None

    # -- constructors mirroring the reference API ---------------------------
    @classmethod
    def new_with_params(cls, path: str, params: Optional[ContextParams] = None) -> "WhisperContext":
        """reference whisper_init_from_file_with_params (src/whisper.cpp:3640)."""
        cp = params or ContextParams()
        device = _load_device(cp)
        try:
            model = loader_mod.load_model(path, cp.dtype, cp.keep_quantized, device)
        except WhisperError:
            raise
        except (OSError, ValueError, EOFError) as e:
            raise InitError(f"failed to load model '{path}': {e}") from e
        ctx = cls(model, cp)
        if cp.draft_model:
            # the draft inherits keep_quantized: its k steps per round are
            # the speculation's overhead, and int8 weights halve their reads
            ctx.attach_draft(cls.new_with_params(
                cp.draft_model, dataclasses.replace(cp, draft_model=None)))
        return ctx

    @classmethod
    def from_buffer(cls, buf, params: Optional[ContextParams] = None) -> "WhisperContext":
        """reference whisper_init_from_buffer_with_params (src/whisper.cpp:3680)."""
        import io
        cp = params or ContextParams()
        device = _load_device(cp)
        try:
            ckpt = loader_mod.ggml_io.read_ggml(io.BytesIO(buf))
            model = loader_mod.params_from_checkpoint(ckpt, cp.dtype, cp.keep_quantized,
                                                      device)
        except WhisperError:
            raise
        except (OSError, ValueError, EOFError) as e:
            raise InitError(f"failed to load model from buffer: {e}") from e
        return cls(model, cp)

    @classmethod
    def random(cls, preset: str = "tiny", params: Optional[ContextParams] = None,
               hp: Optional[WhisperHParams] = None, seed: int = 0) -> "WhisperContext":
        """Random-weight context (stub-model analogue for tests/benches).
        The weights are the JAX package's draws for the same seed, rounded
        to bfloat16 like its random contexts, then used in the context's
        compute dtype. Random weights are dense: keep_quantized is ignored,
        as in the JAX package."""
        cp = params or ContextParams()
        return cls(init_mod.random_model(preset, seed=seed, hp=hp, device=_load_device(cp)),
                   cp)

    @property
    def is_stub(self) -> bool:
        """Zero-tensor checkpoint → skip real decoding (reference
        n_loaded == 0 short-circuit, src/whisper.cpp:1959-1961, 7364-7369)."""
        return self.n_loaded == 0

    @property
    def use_flash(self) -> bool:
        """Whether attention runs the hand-written CUDA kernel."""
        return self.cparams.flash_attn and self.device.type == "cuda"

    def is_multilingual(self) -> bool:
        return self.hparams.is_multilingual

    def tokenize(self, text: str, max_tokens: Optional[int] = None) -> List[int]:
        toks = self.tokenizer.encode(text)
        if max_tokens is not None and len(toks) > max_tokens:
            raise ValueError(f"text tokenizes to {len(toks)} > max {max_tokens}")
        return toks

    def create_state(self) -> "WhisperState":
        """reference whisper_init_state (src/whisper.cpp:3390-3561)."""
        return WhisperState(self)

    def warmup(self, params: Optional[FullParams] = None,
               all_prompt_buckets: bool = True) -> None:
        """Run a throwaway full() on 30 s of silence so the first real
        request pays no first-use cost (kernel build and load, CUDA library
        initialisation) — the analogue of whisper_init_state's worst-case
        graph pre-reservation (src/whisper.cpp:3488-3558). With
        all_prompt_buckets the larger two prompt buckets run too, through
        synthetic initial prompts. On the card it first holds the
        flash-attention kernel against its plain version
        (utils/selfcheck.py) and raises InitError on a mismatch. A kernel
        that fails raises here; nothing switches it off."""
        if self.device.type == "cuda":
            from whisper_tpu_torch.utils import selfcheck
            ok, err = selfcheck.flash_attention_ab_check(device=self.device)
            if not ok:
                raise InitError(f"flash-attention kernel disagrees with its plain version "
                                f"on {self.device}: max abs err {err:.3g} > 2e-2")
        base = dataclasses.replace(params) if params is not None else FullParams.default()
        base.print_progress = False
        base.progress_callback = None
        base.new_segment_callback = None
        silence = np.zeros(30 * cfg.SAMPLE_RATE, np.float32)

        prompt_lens = [0]
        if all_prompt_buckets:
            pm = self.hparams.n_text_ctx // 2 + 8
            prompt_lens += [min(32, pm - 8), pm - 8]
        for n in prompt_lens:
            p = dataclasses.replace(base)
            p.prompt_tokens = list(range(1, n + 1)) if n else None
            self.create_state().full(p, silence)

    def attach_draft(self, draft: "WhisperContext") -> None:
        """Attach a draft model for speculative greedy decoding
        (decoding/speculative.py). The two models exchange token ids, so
        the draft must share the vocabulary (in practice a distil
        checkpoint of the same family: tiny's 51865 tokens do not match
        large-v3's 51866) and the audio context; with
        draft_shares_encoder, the encoder width too. It must sit on this
        context's device, and neither may be split by a mesh: the
        speculative loop runs no tensor parallelism."""
        if self.tp is not None or draft.tp is not None:
            raise InitError("speculative decoding is not meshed: a context split by "
                            "mesh_shape takes no draft")
        v_m, v_d = self.vocab, draft.vocab
        if (v_d.n_vocab != v_m.n_vocab or v_d.token_eot != v_m.token_eot
                or v_d.token_beg != v_m.token_beg or v_d.token_sot != v_m.token_sot):
            raise InitError(
                f"draft vocab incompatible: n_vocab {v_d.n_vocab} vs {v_m.n_vocab} "
                "(speculative decoding requires an identical vocabulary, e.g. a "
                "distil checkpoint of the same family)")
        if draft.hparams.n_audio_ctx != self.hparams.n_audio_ctx:
            raise InitError("draft n_audio_ctx differs from main model")
        if (self.cparams.draft_shares_encoder
                and draft.hparams.n_audio_state != self.hparams.n_audio_state):
            raise InitError(
                "draft_shares_encoder requires matching encoder width "
                f"({draft.hparams.n_audio_state} vs {self.hparams.n_audio_state})")
        if draft.device != self.device:
            raise InitError(f"draft on {draft.device}, main model on {self.device}")
        self.draft = draft

    def full_batch(self, params: FullParams, audios, mesh=None,
                   n_lanes: Optional[int] = None, stats: Optional[dict] = None):
        """Transcribe many utterances together (continuous batching, the
        replacement for whisper_full_parallel's threads; see
        decoding/batch_full.py). `n_lanes` caps the device batch: the
        utterances stream through the lanes, and a freed lane takes the
        next pending one. `stats` (a dict) receives n_lanes, rounds,
        admitted and lane_occupancy. `mesh` (a DeviceMesh of
        parallel/mesh.py, or an (n_data, n_model) shape; every rank of it
        calls with the same audios) splits the utterances over its data
        dim and the model over its model dim (tensor parallelism); every
        rank returns the whole result. It defaults to the context's own
        mesh (ContextParams.mesh_shape). Returns one list of segments per
        utterance."""
        from whisper_tpu_torch.decoding.batch_full import run_full_batch
        return run_full_batch(self, params, audios, mesh=self.mesh if mesh is None else mesh,
                              n_lanes=n_lanes, stats=stats)

    # model metadata getters (reference whisper_model_* / whisper_n_*)
    def n_vocab(self) -> int: return self.hparams.n_vocab
    def n_audio_ctx(self) -> int: return self.hparams.n_audio_ctx
    def n_text_ctx(self) -> int: return self.hparams.n_text_ctx
    def model_n_audio_state(self) -> int: return self.hparams.n_audio_state
    def model_n_audio_head(self) -> int: return self.hparams.n_audio_head
    def model_n_audio_layer(self) -> int: return self.hparams.n_audio_layer
    def model_n_text_state(self) -> int: return self.hparams.n_text_state
    def model_n_text_head(self) -> int: return self.hparams.n_text_head
    def model_n_text_layer(self) -> int: return self.hparams.n_text_layer
    def model_n_mels(self) -> int: return self.hparams.n_mels
    def model_ftype(self) -> int: return self.hparams.ftype
    def model_type(self) -> str: return self.hparams.model_type.value
    def model_type_readable(self) -> str:
        """reference whisper_model_type_readable (src/whisper.cpp:4249)."""
        return self.hparams.model_type.value

    # special token getters (reference whisper_token_*)
    def token_eot(self) -> int: return self.vocab.token_eot
    def token_sot(self) -> int: return self.vocab.token_sot
    def token_prev(self) -> int: return self.vocab.token_prev
    def token_nosp(self) -> int: return self.vocab.token_nosp
    def token_not(self) -> int: return self.vocab.token_not
    def token_beg(self) -> int: return self.vocab.token_beg
    def token_translate(self) -> int: return self.vocab.token_translate
    def token_transcribe(self) -> int: return self.vocab.token_transcribe
    def token_lang(self, lang_id: int) -> int: return self.vocab.token_lang(lang_id)
    def token_solm(self) -> int: return self.vocab.token_solm

    def token_to_str(self, token_id: int) -> str:
        """reference whisper_token_to_str (src/whisper.cpp:4240-4242)."""
        return self.tokenizer.decode([int(token_id)])


def _encoder_attention(ctx: WhisperContext):
    """The encoder's self-attention: the flash-attention kernel where the
    context runs it, else None (the plain attention)."""
    if not ctx.use_flash:
        return None
    from whisper_tpu_torch.ops.flash_attention import flash_attention
    return flash_attention


class WhisperState:
    """Per-stream inference state (reference whisper_state,
    src/whisper.cpp:862-996)."""

    def __init__(self, ctx: WhisperContext):
        self.ctx = ctx
        self.mel: Optional[torch.Tensor] = None   # (n_mels, n_len) on ctx.device
        self.n_len = 0
        self.n_len_org = 0
        self.audio_embed: Optional[torch.Tensor] = None   # (B, Ta, D)
        # (L, 1, H, Ta, Dh) each, or (int8 codes, scales) with kv_dtype="int8"
        self.cross_k = None
        self.cross_v = None
        self.segments: List[Segment] = []
        self.lang_id: int = 0
        self.timings = Timings()
        self.no_speech_prob: float = 0.0
        self.prompt_past: List[int] = []
        self._last_logits: Optional[torch.Tensor] = None
        # the VAD model (read from FullParams.vad_model_path on first use)
        # and the last run's processed -> original time mapping
        self.vad_model = None
        self.vad_mapping = None
        # speculative decoding: the draft's own mel (its filterbank and
        # n_mels may differ: 80 against large-v3's 128) and cross K/V of
        # the current window; {"rounds", "tokens"} of the last full() that
        # speculated (tokens per round = tokens / rounds)
        self.draft_mel: Optional[torch.Tensor] = None
        self.draft_cross_k = None
        self.draft_cross_v = None
        self.spec_stats: Optional[dict] = None

    def _sync(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    # ------------------------------------------------------------------ mel
    def pcm_to_mel(self, samples: np.ndarray, debug: bool = False) -> None:
        """reference whisper_pcm_to_mel_with_state (src/whisper.cpp:3985)."""
        t0 = time.perf_counter()
        self.mel, self.n_len, self.n_len_org = mel_mod.log_mel_spectrogram(
            samples, self.ctx.mel_filters, self.ctx.device)
        self._sync()
        self._drop_draft_window()   # new audio: run_full redoes the draft mel
        self.timings.add("mel", time.perf_counter() - t0)
        if debug:
            # reference debug_mode mel dump (src/whisper.cpp:3264-3273)
            import json
            with open("log_mel_spectrogram.json", "w") as f:
                json.dump(self.mel.cpu().flatten().tolist(), f)

    def set_mel(self, mel: np.ndarray, n_len_org: Optional[int] = None) -> None:
        """reference whisper_set_mel_with_state (src/whisper.cpp:4005-4035)."""
        mel_host = np.asarray(mel, np.float32)
        if mel_host.shape[0] != self.ctx.hparams.n_mels:
            raise ValueError(f"invalid n_mels {mel_host.shape[0]}")
        self.mel = torch.from_numpy(mel_host).to(self.ctx.device)
        self.n_len = mel_host.shape[1]
        self.n_len_org = n_len_org if n_len_org is not None else mel_host.shape[1]
        self._drop_draft_window()

    def _drop_draft_window(self) -> None:
        """Forget the draft mel and cross K/V of earlier audio."""
        self.draft_mel = None
        self.draft_cross_k = self.draft_cross_v = None

    def mel_window(self, seek: int, n_ctx_used: Optional[int] = None,
                   mel: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Slice mel [seek, seek+2*n_ctx), zero-padded (reference conv graph
        input handling, src/whisper.cpp:2389-2421), of this state's mel or
        of `mel`. Returns (1, n_mels, 2*ctx)."""
        mel = self.mel if mel is None else mel
        n_ctx = n_ctx_used or self.ctx.hparams.n_audio_ctx
        want = 2 * n_ctx
        seek = max(0, seek)
        part = mel[:, seek: seek + want]
        win = torch.zeros(mel.shape[0], want, dtype=mel.dtype, device=mel.device)
        win[:, : part.shape[1]] = part
        return win[None]

    # -------------------------------------------------------------- encode
    def encode(self, offset: int = 0, n_ctx_used: Optional[int] = None) -> torch.Tensor:
        """Conv stem + encoder + cross K/V for the 30 s window at mel offset
        (reference whisper_encode_internal, src/whisper.cpp:2376-2472). On
        CUDA with flash_attn set, the encoder's self-attention runs the
        flash-attention kernel; with kv_dtype="int8" the cross K/V are
        (int8 codes, scales) tuples."""
        ctx = self.ctx
        t0 = time.perf_counter()
        embed = model_mod.encoder_forward(
            ctx.params, ctx.hparams, self.mel_window(offset, n_ctx_used),
            ctx.dtype, _encoder_attention(ctx), tp=ctx.tp)
        self.audio_embed = embed
        self.cross_k, self.cross_v = model_mod.cross_attention_kv(
            ctx.params, ctx.hparams, embed, quant=ctx.kv_quant, tp=ctx.tp)
        self._sync()
        self.timings.add("encode", time.perf_counter() - t0)
        return embed

    def encode_draft(self, offset: int = 0, n_ctx_used: Optional[int] = None) -> None:
        """The attached draft's cross K/V for the window at mel offset
        (speculative decoding), timed as "encode_draft". With
        draft_shares_encoder the main model's encoder output (encode()
        must have run) goes through the draft's cross-KV weights and no
        draft encoder runs; otherwise the draft's encoder runs on
        `draft_mel`, which run_full computes from the same samples with
        the draft's filterbank, through the flash-attention kernel on
        CUDA."""
        ctx, draft = self.ctx, self.ctx.draft
        if draft is None:
            raise RuntimeError("no draft model")
        t0 = time.perf_counter()
        if ctx.cparams.draft_shares_encoder:
            if self.audio_embed is None:
                raise RuntimeError("encode() must run before encode_draft()")
            embed = self.audio_embed
        else:
            if self.draft_mel is None:
                raise RuntimeError("no draft mel")
            embed = model_mod.encoder_forward(
                draft.params, draft.hparams,
                self.mel_window(offset, n_ctx_used, self.draft_mel), draft.dtype,
                _encoder_attention(draft))
        self.draft_cross_k, self.draft_cross_v = model_mod.cross_attention_kv(
            draft.params, draft.hparams, embed, quant=ctx.kv_quant)
        self._sync()
        self.timings.add("encode_draft", time.perf_counter() - t0)

    # -------------------------------------------------------------- decode
    def new_kv_cache(self, batch: int) -> model_mod.KVCache:
        return model_mod.KVCache.zeros(self.ctx.hparams, batch, self.ctx.dtype,
                                       self.ctx.device, quant=self.ctx.kv_quant,
                                       tp=self.ctx.tp)

    def decode(
        self,
        tokens: Sequence[int] | np.ndarray,
        pos0: int,
        kv: model_mod.KVCache,
        batch: int = 1,
    ) -> Tuple[torch.Tensor, model_mod.KVCache]:
        """Low-level batched decode (reference whisper_decode_internal,
        src/whisper.cpp:2864-2993). tokens: (T,) replicated over batch, or
        (B, T). Returns (logits[B, T, V] float32, kv updated in place)."""
        ctx = self.ctx
        toks = np.asarray(tokens, dtype=np.int64)
        if toks.ndim == 1:
            toks = np.broadcast_to(toks, (batch, toks.shape[0]))
        ck = self.cross_k[0] if isinstance(self.cross_k, tuple) else self.cross_k
        if ck.shape[1] not in (1, toks.shape[0]):
            raise ValueError(
                f"cross-KV batch {ck.shape[1]} incompatible with "
                f"decode batch {toks.shape[0]}")
        t0 = time.perf_counter()
        logits, kv, _ = model_mod.decoder_forward(
            ctx.params, ctx.hparams,
            torch.tensor(toks, device=ctx.device),
            int(pos0), kv, self.cross_k, self.cross_v, ctx.dtype, tp=ctx.tp)
        self._sync()
        self.timings.add("decode" if toks.shape[1] == 1 else "prompt",
                         time.perf_counter() - t0)
        self._last_logits = logits
        return logits, kv

    # ---------------------------------------------------------------- full
    def full(self, params: FullParams, samples: np.ndarray) -> int:
        """THE main entry point (reference whisper_full_with_state,
        src/whisper.cpp:6795-7711). Returns 0 on success; segments are
        available via the getters below."""
        from whisper_tpu_torch.decoding.loop import run_full
        self.segments = run_full(self, params, samples)
        return 0

    def full_parallel(self, params: FullParams, samples: np.ndarray,
                      n_processors: int) -> int:
        """Split the audio into n_processors chunks, transcribe them and
        merge the results with time offsets and overlap clamping (reference
        whisper_full_parallel, src/whisper.cpp:7736-7864). The chunks go
        through the batched path together (decoding/batch_full.py), one
        lane each. VAD, when on, runs once on the whole audio before the
        split, and the merged segments are remapped through its mapping at
        the end. Returns 0; the segments are available via the getters."""
        if n_processors <= 1:
            return self.full(params, samples)

        # VAD applies once to the whole audio before the split (reference
        # :7748-7760: the workers run whisper_full_with_state, which has no
        # VAD step); the segment getters still translate through the
        # mapping it left (:7934, :7948), so the merged segments are
        # remapped at the end
        params = copy.copy(params)
        vad_mapping = None
        if params.vad:
            from whisper_tpu_torch.models.vad import vad_filter_audio
            filtered, vad_mapping = vad_filter_audio(self, samples, params)
            if filtered is None or len(filtered) == 0:
                self.segments = []
                return 0
            samples = filtered
            params.vad = False

        offset_samples = (cfg.SAMPLE_RATE * params.offset_ms) // 1000
        n_per = (len(samples) - offset_samples) // n_processors

        pc = copy.copy(params)
        pc.offset_ms = 0
        pc.print_progress = False
        pc.new_segment_callback = None
        pc.progress_callback = None

        chunks = []
        for i in range(n_processors):
            start = offset_samples + i * n_per
            end = len(samples) if i == n_processors - 1 else start + n_per
            chunks.append(np.asarray(samples[start:end], np.float32))

        from whisper_tpu_torch.decoding.batch_full import run_full_batch
        lang_sink: list = []
        per_chunk = run_full_batch(self.ctx, pc, chunks, timings_sink=self.timings,
                                   lang_sink=lang_sink)
        if lang_sink:
            # chunk 0 runs on the reference's ctx->state, so full_lang_id()
            # reports its language (src/whisper.cpp:7875)
            self.lang_id = lang_sink[0]

        # merge with the time offset and the overlap clamp (:7812-7846)
        offset_t = params.offset_ms // 10
        self.segments = []
        for i, segs in enumerate(per_chunk):
            shift = 100 * (i * n_per) // cfg.SAMPLE_RATE + offset_t
            for seg in segs:
                seg.t0 += shift
                seg.t1 += shift
                if self.segments:
                    seg.t0 = max(seg.t0, self.segments[-1].t1)
                self.segments.append(seg)
                if params.new_segment_callback:
                    params.new_segment_callback(self.ctx, self, seg)
        self.vad_mapping = vad_mapping
        if vad_mapping:
            from whisper_tpu_torch.models.vad import remap_segment_times
            for seg in self.segments:
                remap_segment_times(seg, vad_mapping)
        return 0

    def lang_detect(self, offset_ms: int = 0) -> Tuple[int, np.ndarray]:
        """Language of the window at offset_ms: (lang id, probabilities of
        the 100 language tokens) (reference whisper_lang_auto_detect_with_state,
        src/whisper.cpp:4037-4110). Sets lang_id."""
        from whisper_tpu_torch.decoding.language import lang_auto_detect
        return lang_auto_detect(self, offset_ms)

    # segment getters (reference whisper_full_get_segment_* family)
    def full_n_segments(self) -> int:
        return len(self.segments)

    def full_get_segment(self, i: int) -> Segment:
        return self.segments[i]

    def full_get_segment_text(self, i: int) -> str:
        return self.segments[i].text

    def full_get_segment_t0(self, i: int) -> int:
        return self.segments[i].t0

    def full_get_segment_t1(self, i: int) -> int:
        return self.segments[i].t1

    def full_n_tokens(self, i: int) -> int:
        return len(self.segments[i].tokens)

    def full_get_token_data(self, i: int, j: int) -> TokenData:
        return self.segments[i].tokens[j]

    def full_get_token_id(self, i: int, j: int) -> int:
        return self.segments[i].tokens[j].id

    def full_get_token_prob(self, i: int, j: int) -> float:
        """reference whisper_full_get_token_p."""
        return self.segments[i].tokens[j].p

    def full_get_segment_no_speech_prob(self, i: int) -> float:
        return self.segments[i].no_speech_prob

    def full_get_segment_speaker_turn_next(self, i: int) -> bool:
        return self.segments[i].speaker_turn_next

    def full_lang_id(self) -> int:
        """reference whisper_full_lang_id (src/whisper.cpp:7875)."""
        return self.lang_id

    def full_get_token_text(self, i: int, j: int) -> str:
        return self.ctx.tokenizer.token_str(self.segments[i].tokens[j].id)

    def full_get_all_text(self) -> str:
        return "".join(s.text for s in self.segments)

    def print_timings(self) -> str:
        return self.timings.report()

    def get_timings(self):
        """Phase totals/counts (reference whisper_get_timings,
        src/whisper.cpp:4261-4279)."""
        return self.timings.as_dict()

    def reset_timings(self) -> None:
        """reference whisper_reset_timings (src/whisper.cpp:4298-4312)."""
        self.timings.reset()

    def get_logits(self) -> Optional[np.ndarray]:
        """Logits of the most recent decode() call, (B*T, n_vocab) float32
        (reference whisper_get_logits_from_state, src/whisper.cpp:4150-4156)."""
        if self._last_logits is None:
            return None
        arr = self._last_logits.float().cpu().numpy()
        return arr.reshape(-1, arr.shape[-1])
