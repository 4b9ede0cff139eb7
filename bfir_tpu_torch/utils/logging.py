"""Logging with a registerable sink.

Replaces the reference's ``pinfo`` printf-through-callback scheme
(``pinfo.c:14-38``; the plugin binds the foobar2000 console at
``foo_dsp_bfir.cpp:54``). Here any callable can be registered as the sink;
default is the standard ``logging`` module.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

_logger = logging.getLogger("bfir_tpu_torch")
_callback: Optional[Callable[[str], None]] = None


def set_print_callback(cb: Optional[Callable[[str], None]]) -> None:
    """Register a sink for engine messages (pinfo.c:18-23 equivalent)."""
    global _callback
    _callback = cb


def pinfo(msg: str, *args) -> None:
    text = (msg % args) if args else msg
    if _callback is not None:
        _callback(text)
    else:
        _logger.info(text)
