"""Build and bind the port's CUDA kernels (``bfir_tpu_torch/csrc/*.cu``).

Each ``.cu`` source compiles with its own nvcc process, all started
together, and one more nvcc links the objects into a shared library with a
plain C interface, bound with ctypes. The build runs at first use, into
``build/bfir_tpu_torch/`` at the root of the checkout, under a name keyed by
a hash of the sources and flags: an unchanged tree reuses its library and a
changed one builds anew. ptxas's register and shared-memory report is kept
beside the library as ``build-<hash>.log``.

Every entry point returns the ``cudaError_t`` of its launch; ``check``
raises on anything but success. Nothing here runs when the module is
imported, so a machine without nvcc or a GPU can import the package.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "bfir_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    # r_a, r_lo, r_scale, r_kind, c_a, c_lo, c_scale, c_kind, yr, yi,
    # P, C, Cs, hp, band_start, band_len, pos, slices, unroll, width, stream
    "bfir_mac_hc": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _P,
                    _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # hr, hi, in_stride, out, tw, rows, h, stream
    "bfir_irfft_hc_tail": [_P, _P, ctypes.c_longlong, _P, _P, _I, _I, _P],
    # hist, h_kind, coeff, c_kind, yr, yi, P, B, C, Cs, hp, variant,
    # b_chunk, grid, stream
    "bfir_corr_mac": [_P, _I, _P, _I, _P, _P] + [_I] * 8 + [_P],
    # variant, h_kind, c_kind, per_sm (out), sms (out)
    "bfir_corr_mac_occupancy": [_I, _I, _I, ctypes.POINTER(_I),
                                ctypes.POINTER(_I)],
    # ring, coeff, yr, yi, P, C, fp, lanes, pos, slices, unroll, width,
    # stream
    "bfir_mac_packed": [_P, _P, _P, _P] + [_I] * 8 + [_P],
    # ring2, coeff_rk, yr, yi, P, C, fp, lanes, pos, k, stream
    "bfir_mac_chunked": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # ring_re, ring_im, coeff_re, coeff_im, yr, yi, P, C, fp, lanes, pos,
    # stream
    "bfir_mac_split": [_P] * 6 + [_I] * 5 + [_P],
    # ring, coeff, wr, wi, out, scratch, P, C, hp, pos, grid, splits, ks,
    # stream
    "bfir_mac_tail_hc": [_P] * 6 + [_I] * 7 + [_P],
    # grid (out)
    "bfir_mac_tail_hc_grid": [ctypes.POINTER(_I)],
    # ring, coeff, xpk, yr, yi, P, C, hp, pos, stream
    "bfir_mac_hc_insert": [_P] * 5 + [_I] * 4 + [_P],
    # x, dv, e0, e1, nof, lg, ilg, q, e0', e1', nof', lg', ilg', C, T,
    # imin, imax, is_f64, stream
    "bfir_quantize_hp_tpdf": [_P] * 13 + [_I, _I, _D, _D, _I, _P],
    # zr, zi, out_r, out_i, tw, rows, h, inverse, tail_only, stream
    "bfir_cfft_balanced": [_P] * 5 + [_I] * 4 + [_P],
    # x, hr, hi, tw, rows, h, stream
    "bfir_rfft_hc": [_P] * 4 + [_I, _I, _P],
    # kind, is_f64, in, out, cycles, iters, mask, stream
    "bfir_chain_latency": [_I, _I, _P, _P, _P, _I, ctypes.c_uint, _P],
}


def sources() -> list:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the kernels (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _run_nvcc(jobs, log) -> None:
    """Run nvcc argument lists side by side; append their output to
    ``log``; raise if any failed."""
    procs = [subprocess.Popen([_nvcc(), *args], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for args in jobs]
    failed = []
    for args, proc in zip(jobs, procs):
        out, _ = proc.communicate()
        log.write(f"$ nvcc {' '.join(args)}\n{out}\n")
        if proc.returncode:
            failed.append(f"nvcc {' '.join(args)} (exit {proc.returncode}):"
                          f"\n{out[-4000:]}")
    if failed:
        raise RuntimeError("\n".join(failed))


def library_path() -> str:
    """Path of the built library, building it first if it is missing."""
    digest = _digest()
    so = os.path.join(BUILD_DIR, f"libbfir_kernels-{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        cu = [s for s in sources() if s.endswith(".cu")]
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in cu]
        with open(os.path.join(BUILD_DIR, f"build-{digest}.log"), "w") as log:
            _run_nvcc([[*NVCC_FLAGS, "-c", src, "-o", obj]
                       for src, obj in zip(cu, objs)], log)
            lib = os.path.join(tmp, "lib.so")
            _run_nvcc([[*NVCC_FLAGS[:2], "-shared", "-o", lib, *objs]], log)
        os.replace(lib, so)  # atomic against a concurrent build
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The kernel library, built on first use and bound."""
    lib = ctypes.CDLL(library_path())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.bfir_error_string.argtypes = [ctypes.c_int]
    lib.bfir_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    if err:
        msg = load().bfir_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(t: torch.Tensor, name: str, dtypes, device) -> None:
    """Raise unless ``t`` is a contiguous tensor on CUDA ``device``, of one
    of ``dtypes``, whose storage is 16-byte aligned (the kernels' vector
    loads)."""
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got "
                         f"{t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of "
                        f"{tuple(str(d) for d in dtypes)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} storage is not 16-byte aligned")
