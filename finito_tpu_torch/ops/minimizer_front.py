"""The minimizer engine's front end: counterpart of
finito_tpu/ops/pallas_min.py.

For every k-window of a (B, L) code batch: the leftmost m-mer of lowest
mix32 hash (its value and its offset), whether any code of the window
is > 3 (pad or non-ACGT), and the window packed at 2 bits per base,
least-significant base first, into ceil(2k/32) words for the XOR
compare against the packed unitig text.

``minimizer_windows`` is the one entry point. On a CPU tensor it runs
the plain PyTorch version; on a CUDA tensor it launches the hand-written
kernel (csrc/minimizer_front.cu) or raises.
"""

from __future__ import annotations

import torch

from finito_tpu_torch.ops.bits import U32, mix32, to_i32


def n_words(k: int) -> int:
    return (2 * k + 31) // 32


def minimizer_windows_ref(codes: torch.Tensor, k: int, m: int):
    """Plain PyTorch version; equals the JAX minimizer_scan +
    pack_query_windows together. codes: (B, L) integer codes. Returns
    (best_v, best_o, bad, q_words): best_v (B, W) int32 bit patterns of
    the uint32 values, best_o (B, W) int32, bad (B, W) bool, q_words
    (NW, B, W) int32 bit patterns; W = L - k + 1."""
    c = codes.to(torch.int64)
    B, L = c.shape
    W = L - k + 1
    nm = L - m + 1
    mv = torch.zeros((B, nm), dtype=torch.int64, device=c.device)
    bad_m = torch.zeros((B, nm), dtype=torch.bool, device=c.device)
    for i in range(m):
        ci = c[:, i : i + nm]
        mv = ((mv << 2) | (ci & 3)) & U32
        bad_m |= ci > 3
    hv = mix32(mv)
    best_v = mv[:, :W]
    best_h = hv[:, :W]
    best_o = torch.zeros((B, W), dtype=torch.int32, device=c.device)
    bad = bad_m[:, :W].clone()
    for r in range(1, k - m + 1):
        cand_h = hv[:, r : r + W]
        upd = cand_h < best_h  # strict: keeps the leftmost minimum
        best_v = torch.where(upd, mv[:, r : r + W], best_v)
        best_h = torch.where(upd, cand_h, best_h)
        best_o = torch.where(upd, r, best_o)
        bad |= bad_m[:, r : r + W]
    q = torch.zeros((n_words(k), B, W), dtype=torch.int64, device=c.device)
    for i in range(k):
        q[i // 16] |= (c[:, i : i + W] & 3) << (2 * (i % 16))
    return to_i32(best_v), best_o, bad, to_i32(q)


_kernel = None  # the ctypes function, loaded on the first launch


def minimizer_windows(codes: torch.Tensor, k: int, m: int):
    """The front end: plain version for a CPU tensor, the CUDA kernel for
    a CUDA tensor (uint8, contiguous, B * L < 2^31). Same
    outputs as minimizer_windows_ref; on the card the four are views of
    one buffer. ``minimizer_windows.launches`` counts kernel launches."""
    global _kernel
    if codes.device.type == "cpu":
        return minimizer_windows_ref(codes, k, m)
    if codes.device.type != "cuda":
        raise ValueError(f"minimizer_windows: unsupported device {codes.device}")
    if codes.dtype != torch.uint8 or codes.dim() != 2 or not codes.is_contiguous():
        raise ValueError("minimizer_windows: codes must be a contiguous (B, L) uint8 tensor")
    if not 1 <= m <= k:
        raise ValueError(f"minimizer_windows: need 1 <= m <= k, got k={k} m={m}")
    B, L = codes.shape
    W = L - k + 1
    if W < 1:
        raise ValueError(f"minimizer_windows: L={L} shorter than k={k}")
    if B * L >= 1 << 31:
        raise ValueError(f"minimizer_windows: B * L = {B * L} reaches 2^31 (32-bit indexing)")
    BW, nw = B * W, n_words(k)
    buf = torch.empty(BW * (4 * (2 + nw) + 1), dtype=torch.uint8, device=codes.device)
    words = buf[: 4 * BW * (2 + nw)].view(torch.int32)
    best_v = words[:BW].view(B, W)
    best_o = words[BW : 2 * BW].view(B, W)
    q = words[2 * BW :].view(nw, B, W)
    bad = buf[4 * BW * (2 + nw) :].view(torch.bool).view(B, W)
    if B == 0:
        return best_v, best_o, bad, q
    if _kernel is None:
        from finito_tpu_torch.ops import _build

        _kernel = _build.library().fin_minimizer_windows
    args = (codes.data_ptr(), B, L, k, m, best_v.data_ptr(), best_o.data_ptr(),
            bad.data_ptr(), q.data_ptr())
    if codes.device.index == torch.cuda.current_device():
        rc = _kernel(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(codes.device):
            rc = _kernel(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"minimizer_front kernel launch failed: CUDA error {rc}")
    minimizer_windows.launches += 1
    return best_v, best_o, bad, q


minimizer_windows.launches = 0
