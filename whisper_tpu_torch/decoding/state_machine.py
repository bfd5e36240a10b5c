"""The per-token decoder state machine, on the host.

Counterpart of whisper_tpu/decoding/state_machine.py: the reference
whisper_full_with_state's per-decoder update rules
(src/whisper.cpp:7297-7378) — timestamp-token seek_delta tracking,
timestamp-regression failure, EOT / max_tokens / end-of-audio completion,
the result_len==0 end-of-segment rule (:7341-7351), and the final-step
repetition bail-out (:7364-7377).

The port's decode loop (decoding/device_loop.py) keeps the per-decoder
state as small numpy arrays on the host, so this runs on numpy: every
input may be a scalar or a (B,) array.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from whisper_tpu_torch.config import CHUNK_SIZE

DELTA_MIN = 10  # 100 ms guard (reference :6847)


class StepUpdate(NamedTuple):
    has_ts: np.ndarray
    seek_delta: np.ndarray
    result_len: np.ndarray
    failed: np.ndarray
    completed: np.ndarray
    live2: np.ndarray      # live and not newly regress-failed this step
    eos: np.ndarray        # completed by this token
    terminal: np.ndarray   # this token ended the decoder (eos or any failure)


def advance(
    tok,            # sampled token id(s)
    s,              # 0-based step index of this token
    live,           # decoder was live before this token
    has_ts, seek_delta, result_len, failed, completed,
    seek, seek_end,  # window bounds (scalar or per-row)
    tids,           # filters.TokenIds
    *,
    max_tokens: int,
    single_segment: bool,
    no_timestamps: bool,
    n_max: int,
) -> StepUpdate:
    """Advance the state machine by one sampled token (rules cited above)."""
    is_ts_tok = live & (tok > tids.beg)            # strictly > (:7317)
    sd_new = 2 * (tok - tids.beg)
    regress = is_ts_tok & has_ts & (seek_delta > sd_new) & (result_len < s)
    failed = failed | regress
    ok_ts = is_ts_tok & ~regress
    seek_delta = np.where(ok_ts, sd_new, seek_delta)
    result_len = np.where(ok_ts, s + 1, result_len)
    has_ts = has_ts | ok_ts

    live2 = live & ~regress

    end_of_audio = has_ts & (seek + seek_delta + DELTA_MIN >= seek_end)
    hit_max = (max_tokens > 0) & (s >= max_tokens)
    eos = live2 & ((tok == tids.eot) | hit_max | end_of_audio)

    # result_len == 0 at end-of-segment (:7341-7351)
    rl0 = eos & (result_len == 0) & (not no_timestamps)
    rl0_ok = rl0 & (seek + seek_delta + DELTA_MIN >= seek_end)
    rl0_fail = rl0 & ~rl0_ok
    result_len = np.where(rl0_ok, s + 1, result_len)
    failed = failed | rl0_fail
    eos = eos & ~rl0_fail

    if single_segment or no_timestamps:
        result_len = np.where(eos, s + 1, result_len)
        seek_delta = np.where(eos, 100 * CHUNK_SIZE, seek_delta)
    completed = completed | eos

    # repetition bail-out on the final step (:7364-7377)
    rep = (s == n_max - 1) & live2 & ~eos & (
        (result_len == 0) | (seek_delta < 100 * CHUNK_SIZE // 2))
    failed = failed | rep

    return StepUpdate(
        has_ts=has_ts, seek_delta=seek_delta, result_len=result_len,
        failed=failed, completed=completed, live2=live2, eos=eos,
        terminal=eos | regress | rl0_fail | rep)
