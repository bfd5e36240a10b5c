"""Native checkpoint cache: fast repeat loads.

Counterpart of the JAX package's checkpoint/native_cache.py. The first
load parses and dequantizes the .bin (seconds for large-v3); later loads
read the ready parameter tree back. The JAX package writes its tree with
orbax; the port writes its own tree (per-layer lists, dense `w` in
[out, in], keep_quantized int8 `q` / float32 `d` / `m`) with `torch.save`
and reads it with `torch.load(weights_only=True)`, straight onto the
device. Sharding after the load composes: restore, then
`parallel.mesh.shard_params`.

Layout on disk:
  <cache_dir>/
    meta.json            hparams, n_loaded, vocab (base64), source stamp
    mel_filters.f32      the filterbank, raw float32
    params.pt            the parameter tree (torch.save)

meta.json and mel_filters.f32 are laid out as the JAX package's. The
cache holds the vocab truncated to min(n_vocab, 50364) tokens, as the JAX
cache does, so both packages restore the same vocab.
"""

from __future__ import annotations

import base64
import json
import logging
import os
from typing import Optional

import numpy as np
import torch

from whisper_tpu_torch.checkpoint.loader import LoadedModel
from whisper_tpu_torch.config import WhisperHParams
from whisper_tpu_torch.tokenizer import WhisperVocab

log = logging.getLogger(__name__)

_META, _FILTERS, _PARAMS = "meta.json", "mel_filters.f32", "params.pt"


def _source_stamp(path: str) -> Optional[dict]:
    """Identity of the source .bin: size + mtime_ns. A replaced or
    re-quantized checkpoint at the same path invalidates the cache."""
    try:
        st = os.stat(path)
        return {"size": st.st_size, "mtime_ns": st.st_mtime_ns}
    except OSError:
        return None


def save_native(model: LoadedModel, cache_dir: str,
                source_path: Optional[str] = None) -> None:
    """Write `model` to `cache_dir`. meta.json goes last, so a cache cut
    off while it is written has none and is never read."""
    os.makedirs(cache_dir, exist_ok=True)
    meta = {
        "hparams": model.hparams.__dict__,
        "n_loaded": model.n_loaded,
        "mel_filters_shape": list(model.mel_filters.shape),
        "vocab": [base64.b64encode(t).decode("ascii")
                  for t in model.vocab.id_to_token[: min(model.hparams.n_vocab, 50364)]],
    }
    if source_path is not None:
        meta["source"] = _source_stamp(source_path)
    meta_path = os.path.join(cache_dir, _META)
    if os.path.exists(meta_path):
        os.remove(meta_path)
    model.mel_filters.astype(np.float32).tofile(os.path.join(cache_dir, _FILTERS))
    torch.save(model.params, os.path.join(cache_dir, _PARAMS))
    with open(meta_path + ".part", "w") as f:
        json.dump(meta, f)
    os.replace(meta_path + ".part", meta_path)


def load_native(cache_dir: str, source_path: Optional[str] = None,
                device="cpu") -> Optional[LoadedModel]:
    """Restore a cached model onto `device`; None if the cache is absent,
    incomplete or (when source_path is given) stale against the source."""
    paths = [os.path.join(cache_dir, n) for n in (_META, _FILTERS, _PARAMS)]
    if not all(os.path.exists(p) for p in paths):
        return None
    with open(paths[0]) as f:
        meta = json.load(f)
    # a cache without a stamp counts as stale too: converting once more
    # is cheap and safe
    if source_path is not None and meta.get("source") != _source_stamp(source_path):
        return None
    hp = WhisperHParams(**meta["hparams"])
    filters = np.fromfile(paths[1], dtype=np.float32).reshape(meta["mel_filters_shape"])
    tokens = [base64.b64decode(t) for t in meta["vocab"]]
    params = torch.load(paths[2], map_location=device, weights_only=True)
    return LoadedModel(hparams=hp, params=params, mel_filters=filters,
                       vocab=WhisperVocab(hp.n_vocab, tokens), n_loaded=meta["n_loaded"])


def load_model_cached(path: str, compute_dtype: str = "bfloat16",
                      keep_quantized: bool = False,
                      cache_dir: Optional[str] = None, device="cpu") -> LoadedModel:
    """load_model with a cache beside the .bin (by default
    `<path>.native-torch-<dtype>[-q]`, apart from the JAX package's)."""
    from whisper_tpu_torch.checkpoint.loader import load_model

    if cache_dir is None:
        cache_dir = path + f".native-torch-{compute_dtype}" + ("-q" if keep_quantized else "")
    cached = load_native(cache_dir, source_path=path, device=device)
    if cached is not None:
        return cached
    model = load_model(path, compute_dtype, keep_quantized, device)
    if model.params:
        try:
            save_native(model, cache_dir, source_path=path)
        except OSError as e:     # the cache is best-effort: the load stands
            log.warning("native cache %s not written: %s", cache_dir, e)
    return model
