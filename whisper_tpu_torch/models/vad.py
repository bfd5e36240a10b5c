"""Silero-VAD v5 in PyTorch, speech segmentation and audio splicing.

Counterpart of whisper_tpu/models/vad.py (reference: the VAD model and
graph, src/whisper.cpp:4361-5200; the hysteresis state machine
whisper_vad_segments_from_probs, :5202-5435; audio splicing and the time
mapping of whisper_vad, :6615-6793; the remap, :7882-7960; the model file
written by models/convert-silero-vad-to-ggml.py).

Architecture (Silero v5, 16 kHz): reflect-pad(64) -> conv(k=256, s=128)
STFT basis -> magnitude over 129 bins -> 4x conv1d+ReLU (129->128->64->64->
128, strides 1,2,2,1) -> take t=0 -> LSTM cell(128) -> ReLU -> 1x1 conv ->
sigmoid.

The STFT and the conv encoder run for all windows of an utterance at
once (F.conv1d over an (N, C, T) batch of windows). The recurrence over
the N windows is one call of PyTorch's LSTM (cuDNN's persistent kernel on
CUDA, the native loop on the CPU): a Python loop of N steps of
`h @ w_hh^T` would launch a few kernels per window (~940 windows for 30 s
of audio, 112 500 for an hour), while the one call costs N sequential
cell updates inside one library call. The cell takes `bias_ih + bias_hh`
summed first, as the JAX package's cell does. The computation is float32
and does not depend on the caller's TF32 setting: the convolutions and the
LSTM run under `torch.backends.cudnn.flags(allow_tf32=False)`, and the
final 1x1 conv is an elementwise product and sum, not a matmul. The
segmenter, the splicing and the time mapping are host code on numpy, as
in the JAX package.
"""

from __future__ import annotations

import bisect
import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from whisper_tpu_torch.checkpoint import quant
from whisper_tpu_torch.config import SAMPLE_RATE, VadParams

GGML_MAGIC = 0x67676D6C


@dataclasses.dataclass
class VadHParams:
    n_window: int = 512
    n_context: int = 64
    n_encoder_layers: int = 4
    encoder_in_channels: Tuple[int, ...] = (129, 128, 64, 64)
    encoder_out_channels: Tuple[int, ...] = (128, 64, 64, 128)
    kernel_sizes: Tuple[int, ...] = (3, 3, 3, 3)
    lstm_input_size: int = 128
    lstm_hidden_size: int = 128
    final_conv_in: int = 128
    final_conv_out: int = 1


@dataclasses.dataclass
class VadModel:
    hparams: VadHParams
    params: Dict[str, np.ndarray]
    model_type: str = "silero-16k"
    version: str = "5.0.0"
    # float32 tensors and the LSTM per device, made on first use by `placed`
    _placed: Dict[str, tuple] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def placed(self, device) -> Tuple[Dict[str, torch.Tensor], torch.nn.LSTM]:
        """The weights as float32 tensors on `device`, and the LSTM cell as
        a one-layer torch.nn.LSTM whose weights lie in one flat buffer (as
        cuDNN takes them; its input bias is bias_ih + bias_hh, its hidden
        bias zero), made once per device."""
        key = str(torch.device(device))
        if key not in self._placed:
            p = {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
                 for k, v in self.params.items()}
            H = self.hparams.lstm_hidden_size
            lstm = torch.nn.LSTM(self.hparams.lstm_input_size, H).to(device)
            with torch.no_grad():
                lstm.weight_ih_l0.copy_(p["_model.decoder.rnn.weight_ih"])
                lstm.weight_hh_l0.copy_(p["_model.decoder.rnn.weight_hh"])
                lstm.bias_ih_l0.copy_(p["_model.decoder.rnn.bias_ih"]
                                      + p["_model.decoder.rnn.bias_hh"])
                lstm.bias_hh_l0.zero_()
            lstm.flatten_parameters()
            self._placed[key] = (p, lstm.requires_grad_(False))
        return self._placed[key]


ENCODER_STRIDES = (1, 2, 2, 1)


@dataclasses.dataclass
class VadContextParams:
    """The device fields of the reference's whisper_vad_context_params
    (include/whisper.h:663-667). use_gpu=True (the default) runs the model
    on cuda:{gpu_device} and raises when CUDA is absent; use_gpu=False runs
    it on the CPU."""

    use_gpu: bool = True
    gpu_device: int = 0


def read_vad_ggml(path_or_file) -> VadModel:
    """Parse the silero .bin container (format: convert-silero-vad-to-ggml.py,
    reader src/whisper.cpp:4777-5090)."""
    own = isinstance(path_or_file, (str, bytes))
    f = open(path_or_file, "rb") if own else path_or_file
    try:
        (magic,) = struct.unpack("<I", f.read(4))
        if magic != GGML_MAGIC:
            raise ValueError(f"invalid VAD model (bad magic 0x{magic:08x})")
        (slen,) = struct.unpack("<i", f.read(4))
        model_type = f.read(slen).decode("utf-8")
        major, minor, patch = struct.unpack("<3i", f.read(12))
        n_window, n_context = struct.unpack("<2i", f.read(8))
        (n_layers,) = struct.unpack("<i", f.read(4))
        ins, outs, ks = [], [], []
        for _ in range(n_layers):
            i, o, k = struct.unpack("<3i", f.read(12))
            ins.append(i)
            outs.append(o)
            ks.append(k)
        lstm_in, lstm_hid, fc_in, fc_out = struct.unpack("<4i", f.read(16))
        hp = VadHParams(n_window, n_context, n_layers, tuple(ins), tuple(outs),
                        tuple(ks), lstm_in, lstm_hid, fc_in, fc_out)

        tensors: Dict[str, np.ndarray] = {}
        while True:
            hdr = f.read(12)
            if len(hdr) < 12:
                break
            n_dims, name_len, ttype = struct.unpack("<3i", hdr)
            ne = struct.unpack(f"<{n_dims}i", f.read(4 * n_dims))
            name = f.read(name_len).decode("utf-8")
            nelems = int(np.prod(ne))
            raw = f.read(quant.row_nbytes(ttype, nelems))
            arr = quant.dequantize(raw, ttype, nelems).reshape(tuple(reversed(ne)))
            if name == "_model.decoder.decoder.2.weight":
                # stored squeezed ([final_conv_in] or [1, in]) by the
                # reference converter; the forward pass wants (1, in, 1)
                arr = arr.reshape(1, -1, 1)
            tensors[name] = arr
        return VadModel(hp, tensors, model_type, f"{major}.{minor}.{patch}")
    finally:
        if own:
            f.close()


def _is_conv_weight(name: str) -> bool:
    return ("weight" in name and ("encoder" in name
                                  or "_model.decoder.decoder.2" in name)) or "stft" in name


def write_vad_ggml(path, model: VadModel) -> None:
    """Writer (mirror of convert-silero-vad-to-ggml.py) for tests and tools.
    Conv weights (the encoder's reparam convs, the final conv, the STFT
    basis) are stored f16, everything else f32, as whisper.cpp's VAD
    loader allocates them (convert-silero-vad-to-ggml.py:147-154)."""
    hp = model.hparams
    with open(path, "wb") as f:
        f.write(struct.pack("<I", GGML_MAGIC))
        mt = model.model_type.encode()
        f.write(struct.pack("<i", len(mt)))
        f.write(mt)
        f.write(struct.pack("<3i", *[int(x) for x in model.version.split(".")]))
        f.write(struct.pack("<2i", hp.n_window, hp.n_context))
        f.write(struct.pack("<i", hp.n_encoder_layers))
        for i in range(hp.n_encoder_layers):
            f.write(struct.pack("<3i", hp.encoder_in_channels[i],
                                hp.encoder_out_channels[i], hp.kernel_sizes[i]))
        f.write(struct.pack("<4i", hp.lstm_input_size, hp.lstm_hidden_size,
                            hp.final_conv_in, hp.final_conv_out))
        for name, arr in model.params.items():
            if name == "_model.decoder.decoder.2.weight":
                # whisper.cpp allocates this as [final_conv_in, 1] 2-D
                # (src/whisper.cpp:4980-4983); the converter writes it squeezed
                arr = np.asarray(arr).reshape(1, -1)
            if _is_conv_weight(name):
                arr = np.ascontiguousarray(arr, np.float16)
                ttype = quant.GGML_TYPE_F16
            else:
                arr = np.ascontiguousarray(arr, np.float32)
                ttype = quant.GGML_TYPE_F32
            ne = tuple(reversed(arr.shape))
            nb = name.encode()
            f.write(struct.pack("<3i", len(ne), len(nb), ttype))
            f.write(struct.pack(f"<{len(ne)}i", *ne))
            f.write(nb)
            f.write(arr.tobytes())


def random_vad_model(seed: int = 0) -> VadModel:
    """Random weights in the converter's layout (the stub-model analogue),
    the JAX package's draws for the same seed."""
    rng = np.random.default_rng(seed)
    hp = VadHParams()
    p = {}
    for i in range(hp.n_encoder_layers):
        cin, cout, k = (hp.encoder_in_channels[i], hp.encoder_out_channels[i],
                        hp.kernel_sizes[i])
        p[f"_model.encoder.{i}.reparam_conv.weight"] = (
            rng.standard_normal((cout, cin, k)).astype(np.float32) * (cin * k) ** -0.5)
        p[f"_model.encoder.{i}.reparam_conv.bias"] = np.zeros(cout, np.float32)
    H = hp.lstm_hidden_size
    p["_model.decoder.rnn.weight_ih"] = rng.standard_normal((4 * H, H)).astype(np.float32) * H**-0.5
    p["_model.decoder.rnn.weight_hh"] = rng.standard_normal((4 * H, H)).astype(np.float32) * H**-0.5
    p["_model.decoder.rnn.bias_ih"] = np.zeros(4 * H, np.float32)
    p["_model.decoder.rnn.bias_hh"] = np.zeros(4 * H, np.float32)
    p["_model.decoder.decoder.2.weight"] = (
        rng.standard_normal((1, H, 1)).astype(np.float32) * H**-0.5)
    p["_model.decoder.decoder.2.bias"] = np.zeros(1, np.float32)
    # DFT basis: rows = [real(129); imag(129)] of kernel 256
    k = np.arange(129)[:, None]
    n = np.arange(256)[None, :]
    real = np.cos(2 * np.pi * k * n / 256)
    imag = -np.sin(2 * np.pi * k * n / 256)
    basis = np.concatenate([real, imag], axis=0).astype(np.float32)  # (258, 256)
    p["_model.stft.forward_basis_buffer"] = basis.reshape(258, 1, 256)
    # conv weights are stored f16 in the container; pre-round them so a
    # model in memory and the same model written and read back are equal
    for name in list(p):
        if _is_conv_weight(name):
            p[name] = p[name].astype(np.float16).astype(np.float32)
    return VadModel(hp, p)


# ---------------------------------------------------------------------------
# forward pass
# ---------------------------------------------------------------------------


def vad_probs(model: VadModel, chunks: torch.Tensor) -> torch.Tensor:
    """chunks: (N, n_window) float32 on a device -> per-window speech
    probabilities (N,), float32 on the same device (the JAX package's
    vad_probs_jit). See the module docstring for the recurrence and TF32."""
    hp = model.hparams
    p, lstm = model.placed(chunks.device)
    H = hp.lstm_hidden_size
    cudnn = torch.backends.cudnn
    with torch.no_grad(), cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                                      deterministic=cudnn.deterministic, allow_tf32=False):
        # reflect pad 64 on each side (reference ggml_pad_reflect_1d, :4537)
        x = F.pad(chunks.float()[:, None, :], (64, 64), mode="reflect")  # (N, 1, 640)
        basis = p["_model.stft.forward_basis_buffer"]                     # (258, 1, 256)
        # STFT hop = n_window / 4 (128 for Silero v5)
        stft = F.conv1d(x, basis, stride=hp.n_window // 4)                # (N, 258, 4)
        cutoff = basis.shape[0] // 2
        h = torch.sqrt(stft[:, :cutoff] ** 2 + stft[:, cutoff: 2 * cutoff] ** 2)
        for i in range(hp.n_encoder_layers):
            h = F.relu(F.conv1d(h, p[f"_model.encoder.{i}.reparam_conv.weight"],
                                p[f"_model.encoder.{i}.reparam_conv.bias"],
                                stride=ENCODER_STRIDES[i], padding=1))
        feat = h[:, :, 0]                                                 # (N, 128)

        zeros = torch.zeros(1, 1, H, dtype=torch.float32, device=chunks.device)
        hs, _ = lstm(feat[:, None, :], (zeros, zeros))                   # (N, 1, H)
        out = F.relu(hs[:, 0])
        w_fc = p["_model.decoder.decoder.2.weight"][0, :, 0]              # (H,)
        logit = (out * w_fc).sum(-1) + p["_model.decoder.decoder.2.bias"][0]
        return torch.sigmoid(logit)


def detect_speech(model: VadModel, samples: np.ndarray, device="cpu") -> np.ndarray:
    """Per-window speech probabilities (reference whisper_vad_detect_speech,
    :5100-5186), computed on `device`. Zero-pads the trailing partial
    window."""
    hp = model.hparams
    n = len(samples)
    n_chunks = -(-n // hp.n_window) if n else 0
    if n_chunks == 0:
        return np.zeros(0, np.float32)
    buf = np.zeros(n_chunks * hp.n_window, np.float32)
    buf[:n] = samples
    chunks = torch.from_numpy(buf.reshape(n_chunks, hp.n_window)).to(device)
    return vad_probs(model, chunks).cpu().numpy()


@dataclasses.dataclass
class SpeechSegment:
    start: int  # centiseconds
    end: int


def _samples_to_cs(s: int) -> int:
    return int(s / SAMPLE_RATE * 100.0 + 0.5)


def _cs_to_samples(cs: int) -> int:
    return int(cs / 100.0 * SAMPLE_RATE + 0.5)


def segments_from_probs(
    probs: np.ndarray,
    params: VadParams,
    n_window: int = 512,
) -> List[SpeechSegment]:
    """Hysteresis state machine (reference :5202-5435)."""
    sr = SAMPLE_RATE
    n_probs = len(probs)
    threshold = params.threshold
    min_silence_samples = sr * params.min_silence_duration_ms // 1000
    audio_length_samples = n_probs * n_window
    min_speech_samples = sr * params.min_speech_duration_ms // 1000
    speech_pad_samples = sr * params.speech_pad_ms // 1000

    if params.max_speech_duration_s > 100000.0:
        max_speech_samples = 2**31 // 2
    else:
        # the reference truncates the float duration to whole seconds
        # before multiplying (whisper.cpp:5229)
        max_speech_samples = (sr * int(params.max_speech_duration_s)
                              - n_window - 2 * speech_pad_samples)
        if max_speech_samples < 0:
            max_speech_samples = 2**31 // 2
    min_silence_at_max = sr * 98 // 1000
    neg_threshold = max(threshold - 0.15, 0.01)

    speeches: List[List[int]] = []
    is_speech = False
    temp_end = prev_end = next_start = 0
    cur_start = 0
    has_cur = False

    for i in range(n_probs):
        prob = float(probs[i])
        cur = n_window * i

        if prob >= threshold and temp_end:
            temp_end = 0
            if next_start < prev_end:
                next_start = cur

        if prob >= threshold and not is_speech:
            is_speech = True
            cur_start = cur
            has_cur = True
            continue

        if is_speech and (cur - cur_start) > max_speech_samples:
            if prev_end:
                speeches.append([cur_start, prev_end])
                has_cur = True
                if next_start < prev_end:
                    is_speech = False
                    has_cur = False
                else:
                    cur_start = next_start
                prev_end = next_start = temp_end = 0
            else:
                speeches.append([cur_start, cur])
                prev_end = next_start = temp_end = 0
                is_speech = False
                has_cur = False
                continue

        if prob < neg_threshold and is_speech:
            if not temp_end:
                temp_end = cur
            if (cur - temp_end) > min_silence_at_max:
                prev_end = temp_end
            if (cur - temp_end) < min_silence_samples:
                continue
            if (temp_end - cur_start) > min_speech_samples:
                speeches.append([cur_start, temp_end])
            prev_end = next_start = temp_end = 0
            is_speech = False
            has_cur = False
            continue

    if has_cur and (audio_length_samples - cur_start) > min_speech_samples:
        speeches.append([cur_start, audio_length_samples])

    # merge small gaps (< 200 ms) (:5339-5359)
    merged: List[List[int]] = []
    max_gap = sr * 200 // 1000
    for s in speeches:
        if merged and s[0] - merged[-1][1] < max_gap:
            merged[-1][1] = s[1]
        else:
            merged.append(list(s))
    merged = [s for s in merged if s[1] - s[0] >= min_speech_samples]

    # padding (:5375-5420)
    out = []
    for i, s in enumerate(merged):
        if i == 0:
            s[0] = max(0, s[0] - speech_pad_samples)
        if i < len(merged) - 1:
            gap = merged[i + 1][0] - s[1]
            if gap < 2 * speech_pad_samples:
                s[1] += gap // 2
                merged[i + 1][0] = max(0, merged[i + 1][0] - gap // 2)
            else:
                s[1] = min(s[1] + speech_pad_samples, audio_length_samples)
                merged[i + 1][0] = max(0, merged[i + 1][0] - speech_pad_samples)
        else:
            s[1] = min(s[1] + speech_pad_samples, audio_length_samples)
        out.append(SpeechSegment(_samples_to_cs(s[0]), _samples_to_cs(s[1])))
    return out


def vad_filter_audio(state, samples: np.ndarray, params) -> Tuple[Optional[np.ndarray], List]:
    """Splice the speech segments with 0.1 s silence gaps and build the
    piecewise-linear time-mapping table (reference whisper_vad,
    :6615-6793). The model is read from params.vad_model_path once per
    state (state.vad_model) and runs on the state's device.

    Returns (filtered samples or None, mapping table [(processed, original)])."""
    if getattr(state, "vad_model", None) is None:
        if params.vad_model_path:
            state.vad_model = read_vad_ggml(params.vad_model_path)
        else:
            raise ValueError("vad enabled but no vad_model_path set")
    model = state.vad_model

    probs = detect_speech(model, samples, state.ctx.device)
    segs = segments_from_probs(probs, params.vad_params, model.hparams.n_window)
    if not segs:
        return None, []

    n_samples = len(samples)
    sr = SAMPLE_RATE
    overlap_samples = int(params.vad_params.samples_overlap * sr)
    silence_samples = int(0.1 * sr)

    mapping: List[Tuple[int, int]] = []
    pieces: List[np.ndarray] = []
    offset = 0
    for i, seg in enumerate(segs):
        s0 = _cs_to_samples(seg.start)
        s1 = _cs_to_samples(seg.end)
        if i < len(segs) - 1:
            s1 += overlap_samples
        s0 = min(s0, n_samples - 1)
        s1 = min(s1, n_samples)
        seg_len = s1 - s0
        if seg_len <= 0:
            continue
        vad_start = _samples_to_cs(offset)
        vad_end = _samples_to_cs(offset + seg_len)
        mapping.append((vad_start, seg.start))
        mapping.append((vad_end, seg.end))
        # intermediate interpolation points every 200 ms (:6723-6743)
        if vad_end - vad_start > 100:
            dur = vad_end - vad_start
            orig_total = seg.end - seg.start
            npts = dur // 20 - 1
            for j in range(1, npts + 1):
                vt = vad_start + j * 20
                if vt >= vad_end:
                    continue
                ot = seg.start + (vt - vad_start) * orig_total // dur
                mapping.append((vt, ot))
        pieces.append(samples[s0:s1])
        offset += seg_len
        if i < len(segs) - 1:
            sil_start = _samples_to_cs(offset)
            sil_end = _samples_to_cs(offset + silence_samples)
            mapping.append((sil_start, seg.end))
            mapping.append((sil_end, segs[i + 1].start))
            pieces.append(np.zeros(silence_samples, np.float32))
            offset += silence_samples

    mapping.sort(key=lambda m: m[0])
    dedup = []
    for m in mapping:
        if not dedup or m[0] != dedup[-1][0]:
            dedup.append(m)
    return np.concatenate(pieces).astype(np.float32), dedup


def map_processed_to_original_time(t: int, mapping: List[Tuple[int, int]]) -> int:
    """Linear interpolation over the mapping table (reference :7882-7921)."""
    if not mapping:
        return t
    if t <= mapping[0][0]:
        return mapping[0][1]
    if t >= mapping[-1][0]:
        return mapping[-1][1]
    idx = bisect.bisect_left(mapping, (t, -(10**18)))
    upper = mapping[idx]
    if upper[0] == t:
        return upper[1]
    lower = mapping[idx - 1]
    pd = upper[0] - lower[0]
    od = upper[1] - lower[1]
    if pd == 0:
        return lower[1]
    return lower[1] + (t - lower[0]) * od // pd


def remap_segment_times(segment, mapping: List[Tuple[int, int]]) -> None:
    """Remap a segment's t0/t1 through the VAD mapping (reference
    whisper_full_get_segment_t{0,1}_from_state, :7925-7961, with its
    10-unit minimum duration). Token times (t0/t1/t_dtw) stay in processed
    time, as the reference's token getters return them."""
    t0 = map_processed_to_original_time(segment.t0, mapping)
    t1 = map_processed_to_original_time(segment.t1, mapping)
    if t1 - t0 < 10:
        t1 = t0 + 10
    segment.t0, segment.t1 = t0, t1


def vad_segments_from_samples(model: VadModel, samples: np.ndarray, params,
                              device="cpu") -> List[SpeechSegment]:
    """Probabilities and segments in one call (reference
    whisper_vad_segments_from_samples, src/whisper.cpp:5437-5449)."""
    probs = detect_speech(model, samples, device)
    return segments_from_probs(probs, params, n_window=model.hparams.n_window)


class VadContext:
    """Standalone VAD context with the reference's object API
    (include/whisper.h:675-716: whisper_vad_init_from_file_with_params,
    whisper_vad_detect_speech, whisper_vad_n_probs / probs,
    whisper_vad_segments_from_probs / samples). The model runs on
    cuda:{gpu_device} unless VadContextParams(use_gpu=False) asks for the
    CPU. Segment times are centiseconds, as the reference's are."""

    def __init__(self, model: VadModel, params: Optional[VadContextParams] = None):
        from whisper_tpu_torch.api import resolve_device
        self.model = model
        self.params = params or VadContextParams()
        self.device = resolve_device(self.params)
        self._probs = np.zeros(0, np.float32)

    @classmethod
    def init_from_file_with_params(cls, path: str,
                                   params: Optional[VadContextParams] = None) -> "VadContext":
        return cls(read_vad_ggml(path), params)

    # whisper_vad_init_with_params takes a model loader (a buffer source)
    init_with_params = init_from_file_with_params

    def detect_speech(self, samples: np.ndarray) -> bool:
        """whisper.h:690-693: runs the model and keeps the probabilities."""
        self._probs = detect_speech(self.model, np.asarray(samples, np.float32), self.device)
        return True

    @property
    def n_probs(self) -> int:
        return len(self._probs)

    @property
    def probs(self) -> np.ndarray:
        return self._probs

    def segments_from_probs(self, params) -> List[SpeechSegment]:
        return segments_from_probs(self._probs, params,
                                   n_window=self.model.hparams.n_window)

    def segments_from_samples(self, params, samples: np.ndarray) -> List[SpeechSegment]:
        self.detect_speech(samples)
        return self.segments_from_probs(params)
