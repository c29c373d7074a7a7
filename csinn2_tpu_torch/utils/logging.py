"""Leveled debug logging (a copy of csinn2_tpu/utils/logging.py).

(ref: include/shl_debug.h + source/utils/debug.c — levels DEBUG..FATAL from
csinn_data_structure.h:478-484, printers shl_debug_info/warning/error.)
"""

from __future__ import annotations

import os
import sys
import time

from csinn2_tpu_torch.core.dtypes import DebugLevel

_level = DebugLevel[os.environ.get("CSINN_TPU_DEBUG", "WARNING").upper()]


def set_level(level: DebugLevel):
    global _level
    _level = DebugLevel(level)


def get_level() -> DebugLevel:
    return _level


def _log(level: DebugLevel, tag: str, msg: str, *args):
    if level >= _level:
        ts = time.strftime("%H:%M:%S")
        print(f"[{ts}] {tag}: {msg % args if args else msg}", file=sys.stderr)


def debug(msg, *args):
    _log(DebugLevel.DEBUG, "DEBUG", msg, *args)


def info(msg, *args):
    _log(DebugLevel.INFO, "INFO", msg, *args)


def warning(msg, *args):
    _log(DebugLevel.WARNING, "WARN", msg, *args)


def error(msg, *args):
    _log(DebugLevel.ERROR, "ERROR", msg, *args)
