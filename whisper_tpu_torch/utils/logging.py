"""Logging hooks.

Counterpart of whisper_tpu/utils/logging.py. reference: whisper_log_set +
default stderr callback (src/whisper.cpp:116-117, 8935-8967; levels
NONE/INFO/WARN/ERROR/DEBUG/CONT) and the Rust layer's install_logging_hooks
(src/whisper_logging_hook.rs:10-73), which routes whisper+ggml logs into
the host logging framework. Here the host framework is Python `logging`
(logger "whisper_tpu_torch"); install_logging_hooks() is idempotent via a
Once-style guard exactly like the Rust layer.
"""

from __future__ import annotations

import enum
import logging
import sys
import threading
from typing import Callable, Optional


class LogLevel(enum.IntEnum):
    """reference ggml_log_level (GGMLLogLevel in src/common_logging.rs)."""

    NONE = 0
    INFO = 1
    WARN = 2
    ERROR = 3
    DEBUG = 4
    CONT = 5  # continuation of the previous message


_callback: Optional[Callable[[LogLevel, str], None]] = None
_last_level = LogLevel.INFO
_install_once = threading.Lock()
_installed = False

logger = logging.getLogger("whisper_tpu_torch")


def log_set(callback: Optional[Callable[[LogLevel, str], None]]) -> None:
    """Install a global log callback (reference whisper_log_set; None
    restores the default stderr writer)."""
    global _callback
    _callback = callback


def log(level: LogLevel, msg: str) -> None:
    global _last_level
    lvl = _last_level if level == LogLevel.CONT else level
    _last_level = lvl
    if _callback is not None:
        _callback(LogLevel(level), msg)
        return
    if lvl == LogLevel.NONE:
        return
    print(msg, file=sys.stderr, end="")


def log_info(msg: str) -> None:
    log(LogLevel.INFO, msg + "\n")


def log_warn(msg: str) -> None:
    log(LogLevel.WARN, msg + "\n")


def log_error(msg: str) -> None:
    log(LogLevel.ERROR, msg + "\n")


def log_debug(msg: str) -> None:
    log(LogLevel.DEBUG, msg + "\n")


_PY_LEVELS = {
    LogLevel.NONE: logging.NOTSET,
    LogLevel.INFO: logging.INFO,
    LogLevel.WARN: logging.WARNING,
    LogLevel.ERROR: logging.ERROR,
    LogLevel.DEBUG: logging.DEBUG,
    LogLevel.CONT: logging.INFO,
}


def install_logging_hooks() -> None:
    """Route framework logs into Python `logging` (reference
    install_logging_hooks, src/lib.rs + whisper_logging_hook.rs). Safe to
    call repeatedly; only the first call installs (Once semantics)."""
    global _installed
    with _install_once:
        if _installed:
            return
        _installed = True

        state = {"last": logging.INFO}

        def hook(level: LogLevel, msg: str) -> None:
            # CONT continues the PREVIOUS message's level (the Rust hook
            # does the same, whisper_logging_hook.rs:45-52), so a
            # multi-part ERROR message stays at ERROR
            if level == LogLevel.CONT:
                py = state["last"]
            else:
                py = _PY_LEVELS.get(level, logging.INFO)
                state["last"] = py
            logger.log(py, msg.rstrip("\n"))

        log_set(hook)
