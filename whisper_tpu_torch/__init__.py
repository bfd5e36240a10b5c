"""whisper_tpu_torch — the PyTorch / CUDA port of whisper_tpu for one
NVIDIA H100.

It mirrors the JAX package's module paths (whisper_tpu_torch/models/whisper.py
is the counterpart of whisper_tpu/models/whisper.py, and so on) and never
imports JAX or the JAX package. Entry points run on the GPU unless
ContextParams(use_gpu=False) asks for the CPU. Both TPU kernels of the
main path are hand-written CUDA kernels: flash attention
(csrc/flash_attention.cu, ops/flash_attention.py) and the int8
block-dequant matmul that runs every linear of a keep_quantized
checkpoint (csrc/quant_matmul.cu, ops/quant_matmul.py). WhisperState.full
takes every single-stream FullParams option, VAD included (models/vad.py,
VadContext); WhisperContext.full_batch and WhisperState.full_parallel
transcribe many utterances together (decoding/batch_full.py); a draft
model (ContextParams.draft_model, WhisperContext.attach_draft) makes the
greedy attempts speculative (decoding/speculative.py); audio/io.py reads
WAV input and utils/device_info.py describes the CUDA devices. The host
C++ runtime (csrc/runtime.cpp, built with g++; runtime/native.py) runs
DTW, the signal energy, dequantization and the grammar's vocab scan.
Users reach the model through serving/: the CLI and its output writers,
the HTTP server (its dispatcher turns concurrent requests into one
full_batch), streaming, voice commands and the LSP-style JSON protocol,
each on the card unless -ng asks for the CPU; eval/ scores transcripts
(WER over the English normalizer, LibriSpeech and Earnings-21 runners);
utils/logging.py routes the log into Python logging and
utils/profiling.py captures torch.profiler traces.
"""

__version__ = "0.1.0"

from whisper_tpu_torch.config import (  # noqa: F401
    WhisperHParams,
    ContextParams,
    FullParams,
    SamplingStrategy,
    VadParams,
    SAMPLE_RATE,
    N_FFT,
    HOP_LENGTH,
    CHUNK_SIZE,
)
from whisper_tpu_torch.tokenizer import WhisperVocab, Tokenizer  # noqa: F401
from whisper_tpu_torch.api import WhisperContext, WhisperState  # noqa: F401
from whisper_tpu_torch.models.vad import VadContext, VadContextParams  # noqa: F401
from whisper_tpu_torch.utils.logging import install_logging_hooks, log_set, LogLevel  # noqa: F401
from whisper_tpu_torch.serving.writers import system_info_string as print_system_info  # noqa: F401
from whisper_tpu_torch.utils.device_info import (  # noqa: F401
    device_count,
    device_description,
    device_total_memory,
    devices_info,
)
