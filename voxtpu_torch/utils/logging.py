"""Leveled logging with the reference's message shape.

Port of `voxtpu/utils/logging.py`, the analog of the reference's printf
macros (`vplib/src/debug_utils.h:24-41`): ``log_{error,warn,info,debug}``
print ``[LEVEL] [HH:MM:SS] file:line — message`` to stderr. The level is
process-wide and read from ``VOXTPU_LOG=debug|info|warn|error|off``
(default warn) when the module is imported; `set_level` changes it.

Unlike the reference's ``cpuAssert``/``gpuAssert`` (`debug_utils.h:43-64`),
which ``exit()`` the process, :func:`check` raises: a library must not
kill its host process.
"""

from __future__ import annotations

import os
import sys
import time

_LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40, "off": 99}
_level = _LEVELS.get(os.environ.get("VOXTPU_LOG", "warn").lower(), 30)


def set_level(name: str) -> None:
    global _level
    _level = _LEVELS[name.lower()]


def _emit(level_name: str, level: int, msg: str, *args) -> None:
    if level < _level:
        return
    # sys._getframe is O(1); inspect.stack() would read the whole call
    # stack (with source I/O) a line.
    frame = sys._getframe(2)
    text = msg % args if args else msg
    print(f"[{level_name}] [{time.strftime('%H:%M:%S')}] "
          f"{os.path.basename(frame.f_code.co_filename)}:{frame.f_lineno} — {text}",
          file=sys.stderr, flush=True)


def log_debug(msg: str, *args) -> None:
    _emit("DEBUG", 10, msg, *args)


def log_info(msg: str, *args) -> None:
    _emit("INFO", 20, msg, *args)


def log_warn(msg: str, *args) -> None:
    _emit("WARN", 30, msg, *args)


def log_error(msg: str, *args) -> None:
    _emit("ERROR", 40, msg, *args)


def check(cond: bool, msg: str = "check failed") -> None:
    """Raise ValueError when `cond` is false (the reference's `cpuAssert`,
    `debug_utils.h:56-64`, without the process exit)."""
    if not cond:
        raise ValueError(msg)
