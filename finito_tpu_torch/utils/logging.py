"""Logging utilities with the reference's `write_log` semantics.

Equivalent of the SBWT globals used by the reference CLI
(ref: include/search_fmin.hh:73-77, build_fmin.hh:306):
timestamped messages to stderr, gated by a global log level.
"""

from __future__ import annotations

import enum
import sys
import time


class LogLevel(enum.IntEnum):
    OFF = 0
    MAJOR = 1
    MINOR = 2
    DEBUG = 3


_LOG_LEVEL = LogLevel.MAJOR


def set_log_level(level: LogLevel) -> None:
    global _LOG_LEVEL
    _LOG_LEVEL = level


def write_log(message: str, level: LogLevel = LogLevel.MAJOR) -> None:
    if level <= _LOG_LEVEL:
        ts = time.strftime("%Y-%m-%d %H:%M:%S")
        sys.stderr.write(f"{ts} ({level.name}) {message}\n")
        sys.stderr.flush()


def cur_time_micros() -> int:
    return time.perf_counter_ns() // 1000
