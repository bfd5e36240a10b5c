"""Error types mirroring the reference's WhisperError surface
(src/error.rs:9-116 — 19 variants with numeric codes and severity).

Subclasses of ValueError/OSError keep Python idiom (callers may catch the
builtin) while exposing the reference's taxonomy via `code` for API parity.
"""

from __future__ import annotations

import enum


class Severity(enum.Enum):
    WARNING = "warning"
    ERROR = "error"
    FATAL = "fatal"


class WhisperError(Exception):
    """Base class; `code` mirrors src/error.rs numeric codes."""

    code = -1
    severity = Severity.ERROR


class InitError(WhisperError, OSError):
    """Failed to create a context (bad path/unreadable model)."""
    code = 1


class SpectrogramNotInitialized(WhisperError, RuntimeError):
    code = 2


class UnableToCalculateSpectrogram(WhisperError, RuntimeError):
    code = 3


class UnableToCalculateEvaluation(WhisperError, RuntimeError):
    code = 4


class FailedToEncode(WhisperError, RuntimeError):
    code = 5


class FailedToDecode(WhisperError, RuntimeError):
    code = 6


class InvalidThreadCount(WhisperError, ValueError):
    code = 7


class InvalidUtf8(WhisperError, ValueError):
    code = 8


class NullByteInString(WhisperError, ValueError):
    code = 9


class NullPointer(WhisperError, ValueError):
    code = 10


class UnknownLanguage(WhisperError, ValueError):
    code = 11


class InvalidText(WhisperError, ValueError):
    code = 12


class AudioConversionError(WhisperError, ValueError):
    """Stereo/mono or int/float conversion failure (src/utilities.rs)."""
    code = 13


class HalfEmptyUtf16(WhisperError, ValueError):
    code = 14


class InvalidUtf16(WhisperError, ValueError):
    code = 15


class GenericError(WhisperError):
    code = 16


class InvalidModelFormat(WhisperError, ValueError):
    """Bad magic / truncated tensors / wrong shapes (model loader)."""
    code = 17


class NoSamples(WhisperError, ValueError):
    code = 18


class InvalidTimestamp(WhisperError, ValueError):
    code = 19


# numeric code -> class (reference error.rs from_c_int style round trip)
BY_CODE = {cls.code: cls for cls in [
    InitError, SpectrogramNotInitialized, UnableToCalculateSpectrogram,
    UnableToCalculateEvaluation, FailedToEncode, FailedToDecode,
    InvalidThreadCount, InvalidUtf8, NullByteInString, NullPointer,
    UnknownLanguage, InvalidText, AudioConversionError, HalfEmptyUtf16,
    InvalidUtf16, GenericError, InvalidModelFormat, NoSamples,
    InvalidTimestamp,
]}
