"""Hashing for artifact cache keys.

Counterpart of ``bfir_tpu/utils/hashing.py``. The reference keys its
derived-artifact cache (rendered EQ FIRs, resampled impulses, preconvolved
chains) on DJB string hashes (``hash.c:113-124``, used at
``equalizer.cpp:152-180``, ``buffer.cpp:243-253``,
``preprocessor.cpp:89-98``). DJB is kept for byte-level parity of the
naming scheme, with a stronger content hash for cache integrity, and a
backend fingerprint of the PyTorch stack for verdict-cache keys.
"""

from __future__ import annotations

import hashlib

import torch


def djb_hash(data: bytes) -> int:
    """DJB string hash (hash.c:113-124), 32-bit."""
    h = 5381
    for b in data:
        h = ((h << 5) + h + b) & 0xFFFFFFFF
    return h


def content_key(*parts) -> str:
    """Stable hex key over heterogeneous parts (floats, strings, bytes)."""
    m = hashlib.sha256()
    for p in parts:
        if isinstance(p, bytes):
            m.update(p)
        else:
            m.update(repr(p).encode())
        m.update(b"\x00")
    return m.hexdigest()[:16]


def backend_fingerprint(device) -> str:
    """Identity of the compute stack a verdict holds for: the torch
    version, its CUDA build and the device's name. ``device``: a
    ``torch.device`` or its name."""
    device = torch.device(device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return "|".join([torch.__version__, str(torch.version.cuda), name])
