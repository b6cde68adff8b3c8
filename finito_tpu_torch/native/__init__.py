"""Native (C++) host components, loaded via ctypes.

The shared library is compiled on first use with the toolchain's g++
into ``build/finito_tpu_torch/native/<hash>/`` at the root of the
checkout, keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads the cached library. If compilation
or loading fails, every consumer falls back to the pure-Python
implementation, so the host layers stay functional on toolchain-less
machines.

Set FINITO_NO_NATIVE=1 to force the Python paths (used by tests to
compare both implementations).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
import time
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [
    os.path.join(_HERE, "fastx_native.cpp"),
    os.path.join(_HERE, "sort_native.cpp"),
    os.path.join(_HERE, "bits_native.cpp"),
]
_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread"]
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "finito_tpu_torch", "native")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
# what the build of this process reported: seconds and the library path
build_info: dict = {}


def _cpu_id() -> bytes:
    """The host CPU's identity: -march=native output runs only where it
    was built, and a checkout (with its build directory) may move."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            models = [line for line in f if line.startswith((b"model name", b"flags"))]
    except OSError:
        models = []
    return platform.machine().encode() + b"".join(sorted(set(models)))


def _so_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_cpu_id())
    for src in _SRCS:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], "libfinito_native.so")


def _compile(so: str) -> bool:
    try:
        os.makedirs(os.path.dirname(so), exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
        os.close(fd)
    except OSError:
        return False
    t0 = time.perf_counter()
    try:
        r = subprocess.run(["g++", *_FLAGS, *_SRCS, "-o", tmp], capture_output=True, timeout=120)
        ok = r.returncode == 0
    except (OSError, subprocess.TimeoutExpired):
        ok = False
    build_info["seconds"] = time.perf_counter() - t0
    if not ok:
        os.unlink(tmp)
        return False
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None (Python fallback).

    FINITO_NO_NATIVE is honored on EVERY call (not just the first), so
    tests can flip between implementations mid-process."""
    global _lib, _tried
    if os.environ.get("FINITO_NO_NATIVE"):
        return None
    if _lib is not None:
        return _lib
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _so_path()
        if not os.path.exists(so) and not _compile(so):
            return None
        build_info["path"] = so
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        i64 = ctypes.c_int64
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.ftx_parse.restype = ctypes.c_int
        lib.ftx_parse.argtypes = [u8p, i64, u8p, i64p, u8p, i64p, i64p]
        lib.ftx_bounds.restype = None
        lib.ftx_bounds.argtypes = [u8p, i64, i64p]
        lib.ftx_encode.restype = None
        lib.ftx_encode.argtypes = [u8p, i64, u8p]
        lib.ftx_revcomp_codes.restype = None
        lib.ftx_revcomp_codes.argtypes = [u8p, i64, u8p]
        lib.fin_radix_argsort.restype = None
        lib.fin_radix_argsort.argtypes = [u64p, i64, i64, i64, i64p, u64p]
        lib.fin_merge_join.restype = None
        lib.fin_merge_join.argtypes = [u64p, i64, u64p, i64, i64, i64p]
        lib.fin_pack_windows.restype = None
        lib.fin_pack_windows.argtypes = [u8p, i64, i64, u64p]
        lib.fin_window_min.restype = None
        lib.fin_window_min.argtypes = [i64p, i64p, i64, i64, i64, i64p]
        lib.fin_minimizer_positions.restype = i64
        lib.fin_minimizer_positions.argtypes = [u32p, i64p, i64, i64, i64, i64p]
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.fin_format_pairs.restype = i64
        lib.fin_format_pairs.argtypes = [i32p, i32p, i64p, i64, u8p]
        lib.fin_lower_bound.restype = None
        lib.fin_lower_bound.argtypes = [u64p, i64, u64p, i64, i64, i64p]
        lib.fin_scatter_max.restype = None
        lib.fin_scatter_max.argtypes = [i64p, i64p, i64p, i64]
        lib.fin_simplitigs.restype = None
        lib.fin_simplitigs.argtypes = [u64p, i64, i64, i64, u8p, u8p,
                                       ctypes.c_int, u8p, i64p, i64p, i64p]
        lib.fin_pack_values.restype = None
        lib.fin_pack_values.argtypes = [u64p, i64, i64, u64p]
        lib.fin_unpack_values.restype = None
        lib.fin_unpack_values.argtypes = [u64p, i64, i64, i64, ctypes.c_void_p]
        lib.fin_desc_to_rows.restype = None
        lib.fin_desc_to_rows.argtypes = [ctypes.c_void_p, i64, i64, i64, i32p]
        _lib = lib
        return _lib


def parse_fastx_bytes(data: bytes):
    """Parse decompressed FASTA/FASTQ bytes natively.

    Returns (codes uint8, seq_ends int64, headers list[bytes]) or None if
    the native library is unavailable (caller falls back to Python).
    Raises ValueError on malformed input (same cases as the Python parser).
    """
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    n = buf.size
    bounds = np.zeros(3, dtype=np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)

    def p8(a):
        return a.ctypes.data_as(u8p)

    def p64(a):
        return a.ctypes.data_as(i64p)

    if n == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.int64), []
    lib.ftx_bounds(p8(buf), n, p64(bounds))
    max_rec, max_code, max_hdr = (int(x) for x in bounds)
    codes = np.empty(max_code, dtype=np.uint8)
    seq_ends = np.empty(max_rec, dtype=np.int64)
    hdr_bytes = np.empty(max_hdr, dtype=np.uint8)
    hdr_ends = np.empty(max_rec, dtype=np.int64)
    counts = np.zeros(3, dtype=np.int64)
    rc = lib.ftx_parse(
        p8(buf), n, p8(codes), p64(seq_ends), p8(hdr_bytes), p64(hdr_ends), p64(counts)
    )
    if rc != 0:
        msgs = {
            -1: "cannot detect FASTA/FASTQ (bad record start byte)",
            -2: "malformed FASTQ '+' line (multi-line FASTQ is not supported)",
            -3: "FASTQ quality length != sequence length",
            -4: "FASTA sequence data before first '>' header",
        }
        raise ValueError(f"native fastx parse failed: {msgs.get(rc, rc)}")
    n_rec, n_code, n_hdr = (int(x) for x in counts)
    codes = codes[:n_code].copy()
    seq_ends = seq_ends[:n_rec].copy()
    hdr_blob = hdr_bytes[:n_hdr].tobytes()
    hdr_ends = hdr_ends[:n_rec]
    headers = []
    prev = 0
    for e in hdr_ends:
        headers.append(hdr_blob[prev:int(e)])
        prev = int(e)
    return codes, seq_ends, headers


# ------------------------------------------------------------------ sort


def _u64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def radix_argsort(words, used_bits: int, want_keys: bool = False):
    """Stable ascending argsort of multiword keys (list of W uint64
    arrays, least-significant first). Returns idx, or (idx, sorted_words)
    with want_keys. None when the native library is unavailable."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    W = len(words)
    n = int(words[0].size)
    stacked = np.ascontiguousarray(np.stack([np.ascontiguousarray(w, dtype=np.uint64) for w in words]))
    idx = np.empty(n, dtype=np.int64)
    if want_keys:
        keys_out = np.empty((W, n), dtype=np.uint64)
        lib.fin_radix_argsort(_u64p(stacked), n, W, used_bits, _i64p(idx), _u64p(keys_out))
        return idx, [keys_out[w] for w in range(W)]
    lib.fin_radix_argsort(
        _u64p(stacked), n, W, used_bits, _i64p(idx),
        ctypes.cast(None, ctypes.POINTER(ctypes.c_uint64)),
    )
    return idx


def merge_join(A_sorted, B_sorted_unique):
    """Index in B of each key of A (both sorted, same W), -1 if absent."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    W = len(A_sorted)
    nA, nB = int(A_sorted[0].size), int(B_sorted_unique[0].size)
    A = np.ascontiguousarray(np.stack([np.ascontiguousarray(w, dtype=np.uint64) for w in A_sorted]))
    B = np.ascontiguousarray(np.stack([np.ascontiguousarray(w, dtype=np.uint64) for w in B_sorted_unique]))
    out = np.empty(nA, dtype=np.int64)
    lib.fin_merge_join(_u64p(A), nA, _u64p(B), nB, W, _i64p(out))
    return out


def pack_windows(codes, k: int):
    """All k-windows of a 2-bit code sequence as 3-bit multiword keys
    (list of W uint64 arrays), or None without the native library."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = int(codes.size)
    nw = n - k + 1
    W = (3 * k + 63) // 64
    if W > 12:  # native kernel's window-key buffer is 12 words (k <= 255)
        return None
    if nw <= 0:
        return [np.zeros(0, dtype=np.uint64) for _ in range(W)]
    out = np.empty((W, nw), dtype=np.uint64)
    lib.fin_pack_windows(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, k, _u64p(out)
    )
    return [out[w] for w in range(W)]


def window_min(cand_key, ends, k: int, bigkey: int):
    """The builder's validity-constrained sliding candidate minimum (see
    sort_native.cpp fin_window_min); returns one int64 fin key per valid
    window (windows not crossing a unitig boundary, unitig-major order)."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    cand_key = np.ascontiguousarray(cand_key, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    lens = np.diff(np.concatenate([[0], ends]))
    n_windows = int(np.maximum(lens - k + 1, 0).sum())
    out = np.empty(n_windows, dtype=np.int64)
    lib.fin_window_min(_i64p(cand_key), _i64p(ends), int(ends.size), k, bigkey, _i64p(out))
    return out


def format_pairs(u, p, line_lens):
    """Render '(u,p) (u,p) ...\\n' output lines (empty line for a zero
    count) from flat int32 pair streams; returns bytes, or None without
    the native library."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    u = np.ascontiguousarray(u, dtype=np.int32)
    p = np.ascontiguousarray(p, dtype=np.int32)
    line_lens = np.ascontiguousarray(line_lens, dtype=np.int64)
    out = np.empty(27 * int(u.size) + int(line_lens.size) + 1, dtype=np.uint8)
    n = lib.fin_format_pairs(
        u.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _i64p(line_lens), int(line_lens.size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out[:n].tobytes()


def lower_bound(A_sorted, B_sorted):
    """Number of B keys strictly below each A key (both sorted, same W)."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    W = len(A_sorted)
    nA, nB = int(A_sorted[0].size), int(B_sorted[0].size)
    A = np.ascontiguousarray(np.stack([np.ascontiguousarray(w, dtype=np.uint64) for w in A_sorted]))
    B = np.ascontiguousarray(np.stack([np.ascontiguousarray(w, dtype=np.uint64) for w in B_sorted]))
    out = np.empty(nA, dtype=np.int64)
    lib.fin_lower_bound(_u64p(A), nA, _u64p(B), nB, W, _i64p(out))
    return out


def scatter_max(best, idx, key) -> bool:
    """best[idx[i]] = max(best[idx[i]], key[i]), in place (int64 arrays).
    Returns False (caller falls back to np.maximum.at) without the lib."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return False
    assert best.dtype == np.int64 and best.flags.c_contiguous
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    key = np.ascontiguousarray(key, dtype=np.int64)
    lib.fin_scatter_max(_i64p(best), _i64p(idx), _i64p(key), int(idx.size))
    return True


def argsort_u64(vals):
    """Stable ascending argsort of one uint64 array via the native radix,
    or None without the library."""
    import numpy as np

    vals = np.ascontiguousarray(vals, dtype=np.uint64)
    lib = get_lib()
    if lib is None or vals.size == 0:
        return None if lib is None else np.zeros(0, dtype=np.int64)
    hi = int(vals.max())
    idx = np.empty(vals.size, dtype=np.int64)
    lib.fin_radix_argsort(
        _u64p(vals), int(vals.size), 1, max(1, hi.bit_length()), _i64p(idx),
        ctypes.cast(None, ctypes.POINTER(ctypes.c_uint64)),
    )
    return idx


def unique_sorted_i64(vals):
    """Sorted unique values of a NON-NEGATIVE int64 array (radix-backed),
    or None without the library."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    if vals.size == 0:
        return vals.copy()
    u = vals.view(np.uint64)
    hi = int(u.max())
    idx = np.empty(vals.size, dtype=np.int64)
    keys_out = np.empty((1, vals.size), dtype=np.uint64)
    lib.fin_radix_argsort(
        _u64p(u.reshape(1, -1)), int(vals.size), 1, max(1, hi.bit_length()),
        _i64p(idx), _u64p(keys_out),
    )
    s = keys_out[0].view(np.int64)
    keep = np.ones(s.size, dtype=bool)
    keep[1:] = s[1:] != s[:-1]
    return s[keep]


def minimizer_positions(hv, ends, k: int, m: int):
    """Deduplicated leftmost-lowest minimizer positions over all valid
    windows (ascending), or None without the native library."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    hv = np.ascontiguousarray(hv, dtype=np.uint32)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    # every emitted position is distinct, bounded by the m-mer count
    out = np.empty(max(1, hv.size), dtype=np.int64)
    n = lib.fin_minimizer_positions(
        hv.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        _i64p(ends), int(ends.size), k, m, _i64p(out),
    )
    return out[:n].copy()


def simplitigs(keys_sorted, k: int):
    """Greedy maximal walks (simplitigs) over sorted canonical keys:
    (concat_codes uint8 0..3, ends int64) or None without the library."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    W = len(keys_sorted)
    if W > 12:  # kernel's local key buffers are sized for k <= 250
        return None
    n = int(keys_sorted[0].size)
    if n == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.int64)
    A = np.ascontiguousarray(
        np.stack([np.ascontiguousarray(w, dtype=np.uint64) for w in keys_sorted])
    )
    used = np.empty(n, np.uint8)
    scratch = np.empty(2 * n + 2 * k, np.uint8)
    total = np.zeros(1, np.int64)
    walks = np.zeros(1, np.int64)
    nullp = ctypes.cast(None, ctypes.POINTER(ctypes.c_uint8))
    nulli = ctypes.cast(None, ctypes.POINTER(ctypes.c_int64))
    lib.fin_simplitigs(_u64p(A), n, W, k, used.ctypes.data_as(
        ctypes.POINTER(ctypes.c_uint8)), scratch.ctypes.data_as(
        ctypes.POINTER(ctypes.c_uint8)), 0, nullp, nulli,
        _i64p(total), _i64p(walks))
    out = np.empty(int(total[0]), np.uint8)
    ends = np.empty(int(walks[0]), np.int64)
    lib.fin_simplitigs(_u64p(A), n, W, k, used.ctypes.data_as(
        ctypes.POINTER(ctypes.c_uint8)), scratch.ctypes.data_as(
        ctypes.POINTER(ctypes.c_uint8)), 1,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), _i64p(ends),
        _i64p(total), _i64p(walks))
    return out, ends


# ------------------------------------------------------------------ bits


def pack_values_native(values, width: int):
    """sdsl-layout bit pack (LSB-first u64 stream); None -> Python path."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    values = np.ascontiguousarray(values, dtype=np.uint64)
    n = int(values.size)
    n_words = (n * width + 63) // 64
    out = np.empty(n_words, np.uint64)
    lib.fin_pack_values(_u64p(values), n, width, _u64p(out))
    return out


def unpack_values_native(words, n: int, width: int, dtype=None):
    """Inverse of pack_values_native; None -> Python path. dtype (default
    uint64) selects the output element type; its bit size must cover
    width (the sign bit of signed dtypes included: values < 2^width are
    stored as-is, so width <= 8*itemsize-1 for signed)."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    dt = np.dtype(dtype) if dtype is not None else np.dtype(np.uint64)
    bits = 8 * dt.itemsize - (1 if dt.kind == "i" else 0)
    if dt.kind not in ("u", "i") or width > bits:
        raise ValueError(f"dtype {dt} cannot hold width-{width} values")
    words = np.ascontiguousarray(words, dtype=np.uint64)
    out = np.empty(n, dt)
    lib.fin_unpack_values(
        _u64p(words), n, width, dt.itemsize, out.ctypes.data_as(ctypes.c_void_p)
    )
    return out


def desc_to_rows_native(desc, len_bits: int):
    """Minimizer slot descriptors -> (n, 2) int32 [start, exact_len]
    rows in one pass; None -> Python path."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    desc = np.ascontiguousarray(desc)
    if desc.dtype not in (np.dtype(np.uint32), np.dtype(np.uint64)):
        return None
    n = int(desc.size)
    out = np.empty((n, 2), np.int32)
    lib.fin_desc_to_rows(
        desc.ctypes.data_as(ctypes.c_void_p), n, desc.dtype.itemsize, len_bits,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out
