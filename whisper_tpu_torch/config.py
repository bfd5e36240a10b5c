"""Configuration dataclasses for the PyTorch port (whisper_tpu_torch).

Reproduces the reference's parameter surface:
- pipeline constants      (reference sys/whisper.cpp/include/whisper.h:33-36)
- model hparams           (reference src/whisper.cpp:623-636)
- whisper_full_params     (reference include/whisper.h:485-588; defaults
                           src/whisper.cpp:5914-6019)
- whisper_context_params  (reference include/whisper.h:116-129)
- whisper_vad_params      (reference include/whisper.h:192-199; defaults
                           src/whisper.cpp:4454-4464)
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Pipeline constants (whisper.h:33-36, src/whisper.cpp:140-141)
# ---------------------------------------------------------------------------
SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_SIZE = 30  # seconds per encoder window
N_SAMPLES_PER_CHUNK = SAMPLE_RATE * CHUNK_SIZE  # 480_000
MAX_DECODERS = 8

# Frames per 30 s window before the 2x conv downsample (2 * n_audio_ctx).
N_FRAMES_PER_CHUNK = N_SAMPLES_PER_CHUNK // HOP_LENGTH  # 3000


class ModelType(enum.Enum):
    TINY = "tiny"
    BASE = "base"
    SMALL = "small"
    MEDIUM = "medium"
    LARGE = "large"          # v1/v2/v3: n_audio_layer == 32
    UNKNOWN = "unknown"


@dataclasses.dataclass(frozen=True)
class WhisperHParams:
    """Model dimensions. Defaults are `tiny` (reference src/whisper.cpp:623-636)."""

    n_vocab: int = 51864
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4
    n_mels: int = 80
    ftype: int = 1
    eps: float = 1e-5

    @property
    def model_type(self) -> ModelType:
        # reference src/whisper.cpp:1543-1565 — inferred from n_audio_layer
        return {
            4: ModelType.TINY,
            6: ModelType.BASE,
            12: ModelType.SMALL,
            24: ModelType.MEDIUM,
            32: ModelType.LARGE,
        }.get(self.n_audio_layer, ModelType.UNKNOWN)

    @property
    def is_multilingual(self) -> bool:
        # reference src/whisper.cpp:486-488
        return self.n_vocab >= 51865

    @property
    def num_languages(self) -> int:
        # reference src/whisper.cpp:490-492
        return self.n_vocab - 51765 - (1 if self.is_multilingual else 0)

    @property
    def head_dim_audio(self) -> int:
        return self.n_audio_state // self.n_audio_head

    @property
    def head_dim_text(self) -> int:
        return self.n_text_state // self.n_text_head


# Canonical hparams per released checkpoint family (OpenAI Whisper paper,
# matched by the reference's size inference at src/whisper.cpp:1543-1565).
PRESET_HPARAMS = {
    "tiny": WhisperHParams(51864, 1500, 384, 6, 4, 448, 384, 6, 4, 80),
    "tiny.en": WhisperHParams(51864, 1500, 384, 6, 4, 448, 384, 6, 4, 80),
    "tiny-multi": WhisperHParams(51865, 1500, 384, 6, 4, 448, 384, 6, 4, 80),
    "base": WhisperHParams(51865, 1500, 512, 8, 6, 448, 512, 8, 6, 80),
    "base.en": WhisperHParams(51864, 1500, 512, 8, 6, 448, 512, 8, 6, 80),
    "small": WhisperHParams(51865, 1500, 768, 12, 12, 448, 768, 12, 12, 80),
    "small.en": WhisperHParams(51864, 1500, 768, 12, 12, 448, 768, 12, 12, 80),
    "medium": WhisperHParams(51865, 1500, 1024, 16, 24, 448, 1024, 16, 24, 80),
    "medium.en": WhisperHParams(51864, 1500, 1024, 16, 24, 448, 1024, 16, 24, 80),
    "large-v1": WhisperHParams(51865, 1500, 1280, 20, 32, 448, 1280, 20, 32, 80),
    "large-v2": WhisperHParams(51865, 1500, 1280, 20, 32, 448, 1280, 20, 32, 80),
    "large-v3": WhisperHParams(51866, 1500, 1280, 20, 32, 448, 1280, 20, 32, 128),
    "large-v3-turbo": WhisperHParams(51866, 1500, 1280, 20, 32, 448, 1280, 20, 4, 128),
}


class SamplingStrategy(enum.Enum):
    """reference include/whisper.h:477-480 + src/whisper_params.rs:8-17."""

    GREEDY = 0
    BEAM_SEARCH = 1


class AlignmentHeadsPreset(enum.Enum):
    """DTW alignment-heads preset (reference include/whisper.h:85-101)."""

    NONE = 0
    N_TOP_MOST = 1  # use the n top text layers, all heads
    CUSTOM = 2
    TINY_EN = 3
    TINY = 4
    BASE_EN = 5
    BASE = 6
    SMALL_EN = 7
    SMALL = 8
    MEDIUM_EN = 9
    MEDIUM = 10
    LARGE_V1 = 11
    LARGE_V2 = 12
    LARGE_V3 = 13
    LARGE_V3_TURBO = 14


# Per-model DTW alignment heads (text_layer, head) — reference
# src/whisper.cpp:417-443.
ALIGNMENT_HEADS = {
    AlignmentHeadsPreset.TINY_EN: (
        (1, 0), (2, 0), (2, 5), (3, 0), (3, 1), (3, 2), (3, 3), (3, 4)),
    AlignmentHeadsPreset.TINY: ((2, 2), (3, 0), (3, 2), (3, 3), (3, 4), (3, 5)),
    AlignmentHeadsPreset.BASE_EN: ((3, 3), (4, 7), (5, 1), (5, 5), (5, 7)),
    AlignmentHeadsPreset.BASE: (
        (3, 1), (4, 2), (4, 3), (4, 7), (5, 1), (5, 2), (5, 4), (5, 6)),
    AlignmentHeadsPreset.SMALL_EN: (
        (6, 6), (7, 0), (7, 3), (7, 8), (8, 2), (8, 5), (8, 7), (9, 0), (9, 4),
        (9, 8), (9, 10), (10, 0), (10, 1), (10, 2), (10, 3), (10, 6), (10, 11),
        (11, 2), (11, 4)),
    AlignmentHeadsPreset.SMALL: (
        (5, 3), (5, 9), (8, 0), (8, 4), (8, 7), (8, 8), (9, 0), (9, 7), (9, 9),
        (10, 5)),
    AlignmentHeadsPreset.MEDIUM_EN: (
        (11, 4), (14, 1), (14, 12), (14, 14), (15, 4), (16, 0), (16, 4),
        (16, 9), (17, 12), (17, 14), (18, 7), (18, 10), (18, 15), (20, 0),
        (20, 3), (20, 9), (20, 14), (21, 12)),
    AlignmentHeadsPreset.MEDIUM: (
        (13, 15), (15, 4), (15, 15), (16, 1), (20, 0), (23, 4)),
    AlignmentHeadsPreset.LARGE_V1: (
        (9, 19), (11, 2), (11, 4), (11, 17), (22, 7), (22, 11), (22, 17),
        (23, 2), (23, 15)),
    AlignmentHeadsPreset.LARGE_V2: (
        (10, 12), (13, 17), (16, 11), (16, 12), (16, 13), (17, 15), (17, 16),
        (18, 4), (18, 11), (18, 19), (19, 11), (21, 2), (21, 3), (22, 3),
        (22, 9), (22, 12), (23, 5), (23, 7), (23, 13), (25, 5), (26, 1),
        (26, 12), (27, 15)),
    AlignmentHeadsPreset.LARGE_V3: (
        (7, 0), (10, 17), (12, 18), (13, 12), (16, 1), (17, 14), (19, 11),
        (21, 4), (24, 1), (25, 6)),
    AlignmentHeadsPreset.LARGE_V3_TURBO: (
        (2, 4), (2, 11), (3, 3), (3, 6), (3, 11), (3, 14)),
}


@dataclasses.dataclass
class DtwParams:
    """DTW token-timestamp config (reference include/whisper.h:120-127,
    src/whisper_ctx.rs:517-605)."""

    mode: AlignmentHeadsPreset = AlignmentHeadsPreset.NONE
    n_top: int = -1                      # for N_TOP_MOST
    custom_aheads: Tuple[Tuple[int, int], ...] = ()
    mem_size: int = 1024 * 1024 * 128    # accepted for API parity; unused


@dataclasses.dataclass
class ContextParams:
    """reference whisper_context_params (include/whisper.h:116-129; defaults
    src/whisper.cpp:3700-3719).

    The port keeps the reference's device switch: use_gpu=True (the
    default) places the model on cuda:{gpu_device} and raises when CUDA is
    absent; use_gpu=False places it on the CPU. mesh_shape is the JAX
    package's field with its meaning, a (data, model) shape. The JAX
    package reads it nowhere; the port builds that mesh when the context
    is made (every rank of it makes the context), keeps only this rank's
    shard of the weights on its device, and runs full_batch over it
    (parallel/mesh.py). full_batch(mesh=...) runs a whole context over
    any mesh."""

    use_gpu: bool = True            # False places the model on the CPU
    flash_attn: bool = True         # hand-written CUDA flash attention (ops/)
    gpu_device: int = 0             # CUDA device index
    dtw_token_timestamps: bool = False
    dtw: DtwParams = dataclasses.field(default_factory=DtwParams)
    dtype: str = "bfloat16"         # compute dtype for matmuls/attention
    mesh_shape: Optional[Tuple[int, int]] = None   # (data, model); None = one card
    batch_size: int = 1             # accepted for API parity; full_batch takes n_lanes
    keep_quantized: bool = False    # keep block-format weights as int8 blocks
                                    # (the quant_matmul kernels, ops/)
    kv_dtype: str = ""              # "" = compute dtype; "int8" = int8 self-
                                    # and cross-KV with per-position scales
    draft_model: Optional[str] = None  # checkpoint path of a draft model for
                                       # speculative greedy decoding (same
                                       # vocab, e.g. distil-large-v3 against
                                       # large-v3) — decoding/speculative.py
    spec_k: int = 8                 # speculative chunk length: draft tokens
                                    # verified per main-model forward
    draft_shares_encoder: bool = False  # the draft keeps the main model's
                                        # encoder (distil drafts freeze the
                                        # teacher's): no draft encoder pass,
                                        # the main encoder output goes
                                        # through the draft's cross-KV weights


@dataclasses.dataclass
class GreedyParams:
    best_of: int = 5  # reference src/whisper.cpp:6007 (GREEDY strategy default)


@dataclasses.dataclass
class BeamSearchParams:
    beam_size: int = 5      # reference src/whisper.cpp:6013
    patience: float = -1.0
    # strict-parity candidate generation: draw the beam_size candidates
    # multinomially from the filtered distribution like the reference's
    # whisper_sample_token_topk (std::discrete_distribution at every
    # temperature, src/whisper.cpp:6548-6558) instead of deterministic
    # top-k. Default False: top-k dominates sampled candidates for search
    # quality and gives run-to-run determinism (PARITY.md "Documented
    # deviations", retired by this flag).
    multinomial_candidates: bool = False


@dataclasses.dataclass
class VadParams:
    """reference whisper_vad_params defaults (src/whisper.cpp:4454-4464)."""

    threshold: float = 0.5
    min_speech_duration_ms: int = 250
    min_silence_duration_ms: int = 100
    max_speech_duration_s: float = float("inf")
    speech_pad_ms: int = 30
    samples_overlap: float = 0.1


@dataclasses.dataclass
class FullParams:
    """reference whisper_full_params (include/whisper.h:485-588; defaults
    src/whisper.cpp:5914-6019). Field order follows the C struct."""

    strategy: SamplingStrategy = SamplingStrategy.GREEDY

    n_threads: int = 4              # host-side threads (mel/io)
    n_max_text_ctx: int = 16384
    offset_ms: int = 0
    duration_ms: int = 0

    translate: bool = False
    no_context: bool = True
    no_timestamps: bool = False
    single_segment: bool = False
    print_special: bool = False
    print_progress: bool = True
    print_realtime: bool = False
    print_timestamps: bool = True

    token_timestamps: bool = False
    thold_pt: float = 0.01
    thold_ptsum: float = 0.01
    max_len: int = 0
    split_on_word: bool = False
    max_tokens: int = 0

    debug_mode: bool = False
    audio_ctx: int = 0              # 0 = full 1500-frame context

    tdrz_enable: bool = False

    suppress_regex: Optional[str] = None

    initial_prompt: Optional[str] = None
    prompt_tokens: Optional[Sequence[int]] = None

    language: Optional[str] = "en"
    detect_language: bool = False

    suppress_blank: bool = True
    suppress_nst: bool = False      # non-speech tokens

    temperature: float = 0.0
    max_initial_ts: float = 1.0
    length_penalty: float = -1.0

    temperature_inc: float = 0.2
    entropy_thold: float = 2.4
    logprob_thold: float = -1.0
    no_speech_thold: float = 0.6

    greedy: GreedyParams = dataclasses.field(default_factory=GreedyParams)
    beam_search: BeamSearchParams = dataclasses.field(default_factory=BeamSearchParams)

    new_segment_callback: Optional[Callable] = None
    progress_callback: Optional[Callable] = None
    encoder_begin_callback: Optional[Callable] = None
    abort_callback: Optional[Callable] = None
    logits_filter_callback: Optional[Callable] = None

    grammar_rules: Optional[object] = None   # parsed GBNF rules (decoding/grammar.py)
    i_start_rule: int = 0
    grammar_penalty: float = 100.0

    vad: bool = False
    vad_model_path: Optional[str] = None
    vad_params: VadParams = dataclasses.field(default_factory=VadParams)

    @classmethod
    def default(cls, strategy: SamplingStrategy = SamplingStrategy.GREEDY) -> "FullParams":
        # the field defaults already match the reference defaults for BOTH
        # strategies (best_of=5; beam_size=5, patience=-1 —
        # src/whisper.cpp:5991-6000); no strategy-dependent overrides exist
        return cls(strategy=strategy)

    @property
    def n_decoders(self) -> int:
        # reference src/whisper.cpp:6866-6898. NOT clamped: requesting more
        # than MAX_DECODERS is an ERROR in the reference (:6881-6883 returns
        # -4); run_full raises, matching that (a silent clamp here would
        # decode with a different beam width than asked)
        if self.strategy == SamplingStrategy.GREEDY:
            n = self.greedy.best_of
        else:
            n = max(self.beam_search.beam_size, self.greedy.best_of)
        return max(1, n)

    def temperatures(self) -> Tuple[float, ...]:
        """Temperature fallback ladder (reference src/whisper.cpp:6854-6863)."""
        out = [self.temperature]
        if self.temperature_inc > 0:
            t = self.temperature + self.temperature_inc
            while t < 1.0 + 1e-6:
                out.append(t)
                t += self.temperature_inc
        return tuple(out)
