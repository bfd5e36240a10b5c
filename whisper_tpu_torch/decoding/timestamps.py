"""Token-level timestamps — signal-energy heuristic.

Counterpart of whisper_tpu/decoding/timestamps.py, on numpy; the energy
envelope runs in the host C++ runtime (runtime/native.py) when it is
built.

reference whisper_exp_compute_token_level_timestamps
(src/whisper.cpp:8390-8615) plus helpers voice_length (:8335-8357) and
get_signal_energy (:8360-8376). Algorithm: anchor tokens whose sampled
timestamp-token stats clear the pt/ptsum thresholds, proportionally split
the remaining intervals by per-token "voice length", then expand/contract
each token's span against a smoothed |signal| energy envelope.

Host-side by design: it walks variable-length token lists with data-
dependent control flow over tiny arrays — sub-millisecond in numpy and not
worth a kernel.
"""

from __future__ import annotations

import numpy as np

from whisper_tpu_torch.config import SAMPLE_RATE


def voice_length(text: str) -> float:
    """Pronunciation-cost heuristic (reference :8335-8357). Iterates UTF-8
    BYTES like the C++ `for (char c : text)` — per-codepoint iteration
    would shorten multi-byte (accented/CJK) tokens and skew the
    proportional interval split."""
    res = 0.0
    for b in text.encode("utf-8", "surrogateescape"):
        if b == 0x20:                     # ' '
            res += 0.01
        elif b == 0x2C:                   # ','
            res += 2.0
        elif b in (0x2E, 0x21, 0x3F):     # '.' '!' '?'
            res += 3.0
        elif 0x30 <= b <= 0x39:           # '0'-'9'
            res += 3.0
        else:
            res += 1.0
    return res


def get_signal_energy(signal: np.ndarray, n_samples_per_half_window: int) -> np.ndarray:
    """Moving average of |signal| with window 2*hw+1; the divisor stays
    2*hw+1 even at the edges (reference :8360-8376). The host runtime
    sums in float64 prefix sums, numpy's convolution in float32: the two
    differ in the last bits."""
    hw = n_samples_per_half_window
    from whisper_tpu_torch.runtime import native
    nat = native.signal_energy(np.asarray(signal, np.float32), hw)
    if nat is not None:
        return nat
    a = np.abs(np.asarray(signal, dtype=np.float32))
    kernel = np.ones(2 * hw + 1, np.float32)
    summed = np.convolve(a, kernel, mode="same")
    return (summed / (2 * hw + 1)).astype(np.float32)


def _timestamp_to_sample(t: int, segment_t0: int, n_samples: int) -> int:
    rel = t - segment_t0
    s = int((rel * SAMPLE_RATE) // 100)
    return max(0, min(n_samples - 1, s))


def _sample_to_timestamp(i_sample: int, segment_t0: int) -> int:
    return (100 * i_sample) // SAMPLE_RATE + segment_t0


def compute_token_level_timestamps(state, segment, thold_pt: float, thold_ptsum: float) -> None:
    """Fill t0/t1 (centiseconds) on segment.tokens in place."""
    ctx = state.ctx
    vocab = ctx.vocab
    tokens = segment.tokens
    energy = getattr(state, "energy", None)
    if energy is None or len(energy) == 0:
        return
    n_samples = len(energy)

    t0, t1 = segment.t0, segment.t1
    n = len(tokens)
    if n == 0:
        return
    if n == 1:
        tokens[0].t0, tokens[0].t1 = t0, t1
        return

    t_beg = state.t_beg
    t_last = state.t_last
    tid_last = state.tid_last

    for j, token in enumerate(tokens):
        if j == 0:
            if token.id == vocab.token_beg:
                tokens[0].t0 = t0
                tokens[0].t1 = t0
                tokens[1].t0 = t0
                t_beg = t0
                t_last = t0
                tid_last = vocab.token_beg
            else:
                tokens[0].t0 = t_last

        tt = t_beg + 2 * (token.tid - vocab.token_beg)
        token.vlen = voice_length(ctx.tokenizer.token_str(token.id) or "")

        if (token.pt > thold_pt and token.ptsum > thold_ptsum
                and token.tid > tid_last and tt <= t1):
            if j > 0:
                tokens[j - 1].t1 = tt
            token.t0 = tt
            tid_last = token.tid

    tokens[n - 2].t1 = t1
    tokens[n - 1].t0 = t1
    tokens[n - 1].t1 = t1
    t_last = t1

    state.t_beg = t_beg
    state.t_last = t_last
    state.tid_last = tid_last

    # proportional split of unknown intervals by voice length (:8469-8508)
    p0 = 0
    p1 = 0
    while True:
        while p1 < n and tokens[p1].t1 < 0:
            p1 += 1
        if p1 >= n:
            p1 = n - 1
        if p1 > p0:
            psum = sum(tokens[j].vlen for j in range(p0, p1 + 1))
            if psum > 0:
                dt = tokens[p1].t1 - tokens[p0].t0
                for j in range(p0 + 1, p1 + 1):
                    ct = tokens[j - 1].t0 + dt * tokens[j - 1].vlen / psum
                    tokens[j - 1].t1 = int(ct)
                    tokens[j].t0 = int(ct)
        p1 += 1
        p0 = p1
        if p1 >= n:
            break

    # fix-up pass (:8511-8525)
    for j in range(n - 1):
        if tokens[j].t1 < 0:
            tokens[j + 1].t0 = tokens[j].t1
        if j > 0 and tokens[j - 1].t1 > tokens[j].t0:
            tokens[j].t0 = tokens[j - 1].t1
            tokens[j].t1 = max(tokens[j].t0, tokens[j].t1)

    # energy-based expand/contract (:8528-8597)
    hw = SAMPLE_RATE // 8
    for j in range(n):
        token = tokens[j]
        if token.id >= vocab.token_eot:
            continue
        s0 = _timestamp_to_sample(token.t0, segment.t0, n_samples)
        s1 = _timestamp_to_sample(token.t1, segment.t0, n_samples)
        ss0 = max(s0 - hw, 0)
        ss1 = min(s1 + hw, n_samples)
        ns = ss1 - ss0
        if ns <= 0:
            continue
        thold = 0.5 * float(energy[ss0:ss1].sum()) / ns

        k = s0
        if energy[k] > thold and j > 0:
            while k > 0 and energy[k] > thold:
                k -= 1
            token.t0 = _sample_to_timestamp(k, segment.t0)
            if token.t0 < tokens[j - 1].t1:
                token.t0 = tokens[j - 1].t1
            else:
                s0 = k
        else:
            while k < s1 and energy[k] < thold:
                k += 1
            s0 = k
            token.t0 = _sample_to_timestamp(k, segment.t0)

        k = s1
        if energy[k] > thold:
            while k < n_samples - 1 and energy[k] > thold:
                k += 1
            token.t1 = _sample_to_timestamp(k, segment.t0)
            if j < n - 1 and token.t1 > tokens[j + 1].t0:
                token.t1 = tokens[j + 1].t0
            else:
                s1 = k
        else:
            while k > s0 and energy[k] < thold:
                k -= 1
            s1 = k
            token.t1 = _sample_to_timestamp(k, segment.t0)
