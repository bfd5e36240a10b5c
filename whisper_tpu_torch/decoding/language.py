"""Language auto-detection.

Counterpart of whisper_tpu/decoding/language.py (reference
whisper_lang_auto_detect_with_state, src/whisper.cpp:4037-4110): encode the
window at the given offset (the flash-attention kernel on CUDA), decode a
single [SOT] token (one row: the plain attention), softmax over the
language-token logits, return the argmax id and the full probability
vector.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from whisper_tpu_torch import languages


def lang_auto_detect(state, offset_ms: int = 0) -> Tuple[int, np.ndarray]:
    ctx = state.ctx
    vocab = ctx.vocab

    seek = offset_ms // 10
    if seek < 0:
        raise ValueError(f"offset {offset_ms}ms is before the start of the audio")
    if state.mel is None:
        raise RuntimeError("pcm_to_mel must run before lang_detect")
    if seek >= state.n_len_org:
        # reference bound: the UNPADDED mel length (src/whisper.cpp:4051)
        raise ValueError(f"offset {offset_ms}ms is past the end of the audio")

    state.encode(seek)
    logits, _ = state.decode([vocab.token_sot], pos0=0, kv=state.new_kv_cache(1))
    row = logits[0, -1].double().cpu().numpy()

    # the reference iterates the FULL 100-entry language table regardless
    # of the model's num_languages (:4072-4076) — on a 99-language model
    # the last entry reads the logit one past the language block (a
    # reference quirk, reproduced for parity)
    n_langs = languages.lang_max_id() + 1
    lang_token_ids = np.array([vocab.token_lang(i) for i in range(n_langs)])
    lang_logits = row[lang_token_ids]
    ex = np.exp(lang_logits - lang_logits.max())
    probs_all = (ex / ex.sum()).astype(np.float32)

    lang_id = int(np.argmax(lang_logits))
    state.lang_id = lang_id
    return lang_id, probs_all
