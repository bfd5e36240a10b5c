"""GGUF container support.

Counterpart of the JAX package's checkpoint/gguf.py (reference:
ggml/src/gguf.cpp, the newer ggml container). Whisper checkpoints ship as
legacy .bin (checkpoint/ggml_io.py), but the runtime supports gguf, so the
port reads (and writes, for tests and tools) GGUF v3 with the standard
whisper tensor names. Metadata keys follow the GGUF convention
(`general.architecture` = "whisper", `whisper.*` hparams). The writer's
bytes equal the JAX package's for the same tensors and types: the same KV
order, 32-byte alignment and zero padding.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np

from whisper_tpu_torch.checkpoint import ggml_io, quant
from whisper_tpu_torch.config import WhisperHParams
from whisper_tpu_torch.errors import InvalidModelFormat

GGUF_MAGIC = 0x46554747  # "GGUF" LE
GGUF_VERSION = 3
ALIGNMENT = 32

# GGUF value types
T_U8, T_I8, T_U16, T_I16, T_U32, T_I32, T_F32, T_BOOL, T_STR, T_ARR, \
    T_U64, T_I64, T_F64 = range(13)

_SCALAR_FMT = {T_U8: "<B", T_I8: "<b", T_U16: "<H", T_I16: "<h",
               T_U32: "<I", T_I32: "<i", T_F32: "<f", T_U64: "<Q",
               T_I64: "<q", T_F64: "<d"}


def _read_str(f) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8", errors="surrogateescape")


def _write_str(f, s: str) -> None:
    b = s.encode("utf-8", errors="surrogateescape")
    f.write(struct.pack("<Q", len(b)))
    f.write(b)


def _read_value(f, vtype: int):
    if vtype == T_BOOL:
        return bool(f.read(1)[0])
    if vtype == T_STR:
        return _read_str(f)
    if vtype == T_ARR:
        (etype,) = struct.unpack("<I", f.read(4))
        (n,) = struct.unpack("<Q", f.read(8))
        return [_read_value(f, etype) for _ in range(n)]
    fmt = _SCALAR_FMT[vtype]
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))[0]


def _write_kv(f, key: str, vtype: int, value) -> None:
    _write_str(f, key)
    f.write(struct.pack("<I", vtype))
    if vtype == T_BOOL:
        f.write(bytes([1 if value else 0]))
    elif vtype == T_STR:
        _write_str(f, value)
    elif vtype == T_ARR:
        etype, items = value
        f.write(struct.pack("<IQ", etype, len(items)))
        for it in items:
            if etype == T_STR:
                _write_str(f, it)
            else:
                f.write(struct.pack(_SCALAR_FMT[etype], it))
    else:
        f.write(struct.pack(_SCALAR_FMT[vtype], value))


def _padded(n: int) -> int:
    return -(-n // ALIGNMENT) * ALIGNMENT


def read_gguf(path: str) -> ggml_io.GgmlCheckpoint:
    """Parse a whisper GGUF into the structure the legacy reader yields,
    so the loader path is shared."""
    with open(path, "rb") as f:
        magic, version = struct.unpack("<II", f.read(8))
        if magic != GGUF_MAGIC:
            raise InvalidModelFormat(f"bad GGUF magic 0x{magic:08x}")
        if version not in (2, 3):
            raise InvalidModelFormat(f"unsupported GGUF version {version}")
        n_tensors, n_kv = struct.unpack("<QQ", f.read(16))

        kv: Dict[str, Any] = {}
        for _ in range(n_kv):
            key = _read_str(f)
            (vtype,) = struct.unpack("<I", f.read(4))
            kv[key] = _read_value(f, vtype)

        infos: List[Tuple[str, Tuple[int, ...], int, int]] = []
        for _ in range(n_tensors):
            name = _read_str(f)
            (nd,) = struct.unpack("<I", f.read(4))
            dims = struct.unpack(f"<{nd}Q", f.read(8 * nd))  # ne order
            ttype, offset = struct.unpack("<IQ", f.read(4 + 8))
            infos.append((name, tuple(int(d) for d in dims), ttype, offset))

        align = int(kv.get("general.alignment", ALIGNMENT))
        data_start = -(-f.tell() // align) * align

        tensors: Dict[str, ggml_io.RawTensor] = {}
        for name, ne, ttype, offset in infos:
            nbytes = quant.row_nbytes(ttype, int(np.prod(ne)))
            f.seek(data_start + offset)
            tensors[name] = ggml_io.RawTensor(name=name, ne=ne, ttype=ttype,
                                              data=f.read(nbytes))

    def g(k, d=0):
        return int(kv.get(f"whisper.{k}", d))

    hp = WhisperHParams(
        n_vocab=g("vocab_size", 51864),
        n_audio_ctx=g("encoder.context_length", 1500),
        n_audio_state=g("encoder.embedding_length", 384),
        n_audio_head=g("encoder.attention.head_count", 6),
        n_audio_layer=g("encoder.block_count", 4),
        n_text_ctx=g("decoder.context_length", 448),
        n_text_state=g("decoder.embedding_length", 384),
        n_text_head=g("decoder.attention.head_count", 6),
        n_text_layer=g("decoder.block_count", 4),
        n_mels=g("encoder.mels_count", 80),
        ftype=g("ftype", 1),
    )

    filters = np.asarray(kv.get("whisper.mel_filters", []), np.float32)
    if filters.size:
        filters = filters.reshape(hp.n_mels, 201)
    else:
        from whisper_tpu_torch.audio.mel import mel_filterbank
        filters = mel_filterbank(hp.n_mels)

    vocab_tokens = [t.encode("utf-8", errors="surrogateescape")
                    for t in kv.get("tokenizer.ggml.tokens", [])]
    return ggml_io.GgmlCheckpoint(hp, 2, filters, vocab_tokens, tensors)


def write_gguf(
    path: str,
    hparams: WhisperHParams,
    mel_filters: np.ndarray,
    vocab_tokens: List[bytes],
    tensors: Dict[str, Tuple[np.ndarray, int]],
) -> None:
    """Write a GGUF v3 whisper checkpoint: `tensors` maps name -> (float32
    array in numpy shape, target ggml type)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<II", GGUF_MAGIC, GGUF_VERSION))

        kvs = [
            ("general.architecture", T_STR, "whisper"),
            ("general.alignment", T_U32, ALIGNMENT),
            ("whisper.vocab_size", T_U32, hparams.n_vocab),
            ("whisper.encoder.context_length", T_U32, hparams.n_audio_ctx),
            ("whisper.encoder.embedding_length", T_U32, hparams.n_audio_state),
            ("whisper.encoder.attention.head_count", T_U32, hparams.n_audio_head),
            ("whisper.encoder.block_count", T_U32, hparams.n_audio_layer),
            ("whisper.decoder.context_length", T_U32, hparams.n_text_ctx),
            ("whisper.decoder.embedding_length", T_U32, hparams.n_text_state),
            ("whisper.decoder.attention.head_count", T_U32, hparams.n_text_head),
            ("whisper.decoder.block_count", T_U32, hparams.n_text_layer),
            ("whisper.encoder.mels_count", T_U32, hparams.n_mels),
            ("whisper.ftype", T_U32, hparams.ftype),
            ("whisper.mel_filters", T_ARR,
             (T_F32, np.asarray(mel_filters, np.float32).flatten().tolist())),
            ("tokenizer.ggml.tokens", T_ARR,
             (T_STR, [t.decode("utf-8", errors="surrogateescape")
                      for t in vocab_tokens])),
        ]
        f.write(struct.pack("<QQ", len(tensors), len(kvs)))
        for key, vtype, val in kvs:
            _write_kv(f, key, vtype, val)

        payloads = []
        offset = 0
        for name, (arr, ttype) in tensors.items():
            arr = np.ascontiguousarray(arr, np.float32)
            raw = quant.quantize(arr, ttype)
            ne = tuple(reversed(arr.shape))
            _write_str(f, name)
            f.write(struct.pack("<I", len(ne)))
            f.write(struct.pack(f"<{len(ne)}Q", *ne))
            f.write(struct.pack("<IQ", ttype, offset))
            payloads.append(raw)
            offset += _padded(len(raw))

        pos = f.tell()
        f.write(b"\x00" * (_padded(pos) - pos))
        for raw in payloads:
            f.write(raw)
            f.write(b"\x00" * (_padded(len(raw)) - len(raw)))


def load_model_gguf(path: str, compute_dtype: str = "bfloat16",
                    keep_quantized: bool = False, device="cpu"):
    """read_gguf, then the loader's params_from_checkpoint (as load_model
    does for a .bin)."""
    from whisper_tpu_torch.checkpoint.loader import params_from_checkpoint
    return params_from_checkpoint(read_gguf(path), compute_dtype, keep_quantized, device)
