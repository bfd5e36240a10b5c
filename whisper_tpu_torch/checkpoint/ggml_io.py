"""Reader/writer for the legacy ggml .bin Whisper checkpoint container.

Format (reference reader src/whisper.cpp:1503-1974; writer
models/convert-pt-to-ggml.py:268-334):

  u32   magic 0x67676d6c ("ggml" LE)
  i32   n_vocab, n_audio_ctx, n_audio_state, n_audio_head, n_audio_layer,
        n_text_ctx, n_text_state, n_text_head, n_text_layer, n_mels, ftype
  i32   filters.n_mel, filters.n_fft; f32[n_mel*n_fft] mel filterbank
  i32   n_vocab_in_file; { u32 len; u8[len] token } * n_vocab_in_file
  until EOF:
        i32 n_dims; i32 name_len; i32 ttype
        i32 ne[n_dims]            (ne[0] fastest-varying / contiguous)
        u8[name_len] name
        u8[row_nbytes] data       (row-major with numpy shape reversed(ne))

The hparams ftype field encodes quantization version:
ftype = qnt_version * 1000 + ggml_ftype (reference src/whisper.cpp:1566-1568).
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from whisper_tpu_torch.checkpoint import quant
from whisper_tpu_torch.config import WhisperHParams

GGML_MAGIC = 0x67676D6C
QNT_VERSION = 2
QNT_VERSION_FACTOR = 1000


@dataclasses.dataclass
class RawTensor:
    name: str
    ne: Tuple[int, ...]   # ggml order: ne[0] contiguous
    ttype: int
    data: bytes           # raw payload (possibly quantized blocks)

    @property
    def shape(self) -> Tuple[int, ...]:
        """numpy (row-major) shape."""
        return tuple(reversed(self.ne))

    @property
    def nelements(self) -> int:
        n = 1
        for d in self.ne:
            n *= d
        return n

    def to_float32(self) -> np.ndarray:
        return quant.dequantize(self.data, self.ttype, self.nelements).reshape(self.shape)


@dataclasses.dataclass
class GgmlCheckpoint:
    hparams: WhisperHParams
    qnt_version: int
    mel_filters: np.ndarray          # (n_mel, n_fft_bins) float32
    vocab_tokens: List[bytes]
    tensors: Dict[str, RawTensor]


def _read_i32(f) -> int:
    return struct.unpack("<i", f.read(4))[0]


def read_ggml(path_or_file, max_tensors: Optional[int] = None) -> GgmlCheckpoint:
    """Parse a ggml .bin checkpoint. Accepts a path or binary file object
    (the reference supports both file and in-memory buffers —
    whisper_init_from_buffer_with_params, src/whisper.cpp:3680)."""
    from whisper_tpu_torch.errors import InvalidModelFormat

    if hasattr(path_or_file, "__fspath__"):      # pathlib.Path etc. (r4)
        path_or_file = os.fspath(path_or_file)
    is_path = isinstance(path_or_file, (str, bytes))
    f = open(path_or_file, "rb") if is_path else path_or_file
    try:
        head = f.read(4)
        if len(head) < 4:
            raise InvalidModelFormat("invalid model data (file too short)")
        magic = struct.unpack("<I", head)[0]
        if magic != GGML_MAGIC:
            raise InvalidModelFormat(f"invalid model data (bad magic 0x{magic:08x})")

        vals = struct.unpack("<11i", f.read(44))
        ftype_raw = vals[10]
        hp = WhisperHParams(
            n_vocab=vals[0], n_audio_ctx=vals[1], n_audio_state=vals[2],
            n_audio_head=vals[3], n_audio_layer=vals[4], n_text_ctx=vals[5],
            n_text_state=vals[6], n_text_head=vals[7], n_text_layer=vals[8],
            n_mels=vals[9], ftype=ftype_raw % QNT_VERSION_FACTOR,
        )
        qnt_version = ftype_raw // QNT_VERSION_FACTOR

        n_mel = _read_i32(f)
        n_fft = _read_i32(f)
        filters = np.frombuffer(f.read(4 * n_mel * n_fft), dtype=np.float32)
        filters = filters.reshape(n_mel, n_fft).copy()

        n_vocab_file = _read_i32(f)
        tokens: List[bytes] = []
        for _ in range(n_vocab_file):
            ln = struct.unpack("<I", f.read(4))[0]
            tokens.append(f.read(ln) if ln > 0 else b"")

        tensors: Dict[str, RawTensor] = {}
        while True:
            # bound check BEFORE reading: max_tensors=0 (header-only peek)
            # must not pull a whole tensor payload into memory (r3 review)
            if max_tensors is not None and len(tensors) >= max_tensors:
                break
            hdr = f.read(12)
            if len(hdr) < 12:
                break
            n_dims, name_len, ttype = struct.unpack("<3i", hdr)
            ne = struct.unpack(f"<{n_dims}i", f.read(4 * n_dims))
            name = f.read(name_len).decode("utf-8")
            nelems = int(np.prod(ne))
            nbytes = quant.row_nbytes(ttype, nelems)
            data = f.read(nbytes)
            if len(data) < nbytes:
                raise InvalidModelFormat(f"truncated tensor data for '{name}'")
            tensors[name] = RawTensor(name=name, ne=tuple(ne), ttype=ttype, data=data)

        return GgmlCheckpoint(hp, qnt_version, filters, tokens, tensors)
    except (struct.error, ValueError, UnicodeDecodeError) as e:
        # short reads inside a header/section or garbage sizes surface as
        # raw struct/reshape/decode errors — normalize to the documented
        # error type so callers' except InvalidModelFormat works (r4)
        raise InvalidModelFormat(f"invalid model data ({e})") from e
    finally:
        if isinstance(path_or_file, (str, bytes)):
            f.close()


def write_ggml(
    path_or_file,
    hparams: WhisperHParams,
    mel_filters: np.ndarray,
    vocab_tokens: List[bytes],
    tensors: Dict[str, Union[Tuple[np.ndarray, int], RawTensor]],
) -> None:
    """Write a ggml .bin checkpoint. `tensors` maps name -> (float32 array in
    numpy shape, target ggml ttype), or name -> a RawTensor whose payload is
    already encoded (tools/quantize.quantize_tensors). Used by the quantizer tool
    (tools/quantize.py, reproducing examples/quantize/quantize.cpp) and by
    tests to fabricate stub checkpoints (the reference tests do the same —
    tests/CMakeLists.txt:18-91 uses zero-tensor stub models)."""
    f = open(path_or_file, "wb") if isinstance(path_or_file, (str, bytes)) else path_or_file
    own = isinstance(path_or_file, (str, bytes))
    try:
        f.write(struct.pack("<I", GGML_MAGIC))
        f.write(struct.pack(
            "<11i", hparams.n_vocab, hparams.n_audio_ctx, hparams.n_audio_state,
            hparams.n_audio_head, hparams.n_audio_layer, hparams.n_text_ctx,
            hparams.n_text_state, hparams.n_text_head, hparams.n_text_layer,
            hparams.n_mels, QNT_VERSION * QNT_VERSION_FACTOR + hparams.ftype))

        n_mel, n_fft = mel_filters.shape
        f.write(struct.pack("<2i", n_mel, n_fft))
        f.write(np.ascontiguousarray(mel_filters, dtype=np.float32).tobytes())

        f.write(struct.pack("<i", len(vocab_tokens)))
        for tok in vocab_tokens:
            f.write(struct.pack("<I", len(tok)))
            f.write(tok)

        for name, val in tensors.items():
            if isinstance(val, RawTensor):
                ne, ttype, payload = val.ne, val.ttype, val.data
            else:
                arr, ttype = val
                arr = np.ascontiguousarray(arr, dtype=np.float32)
                ne = tuple(reversed(arr.shape))
                payload = quant.quantize(arr, ttype)
            name_b = name.encode("utf-8")
            f.write(struct.pack("<3i", len(ne), len(name_b), ttype))
            f.write(struct.pack(f"<{len(ne)}i", *ne))
            f.write(name_b)
            f.write(payload)
    finally:
        if own:
            f.close()


def read_header_only(path: str) -> WhisperHParams:
    """Cheap hparams peek (model type detection without loading tensors)."""
    with open(path, "rb") as f:
        return read_ggml(f, max_tensors=0).hparams
