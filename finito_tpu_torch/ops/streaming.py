"""Stream compaction for the port: counterpart of compact_mask in
finito_tpu/ops/streaming.py (the only piece of that module the
minimizer path runs)."""

from __future__ import annotations

import torch


def compact_mask(mask: torch.Tensor, K: int):
    """Indices of the first K set positions of a bool mask (flattened),
    in ascending order and padded with -1, plus the true count: the
    JAX compact_mask's contract.

    One cumsum gives every set position its output rank; a scatter into
    a K+1 buffer whose last slot is a sink drops ranks >= K and the
    unset positions. Nothing here reads a value back to the host (unlike
    torch.nonzero), so the count stays a device tensor. Returns
    ((K,) int32, () int32)."""
    flat = mask.reshape(-1)
    dev = flat.device
    if flat.numel() == 0:
        return (torch.full((K,), -1, dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    rank = torch.cumsum(flat.to(torch.int32), 0) - 1  # int64 (torch's cumsum rule)
    n = (rank[-1] + 1).to(torch.int32)
    sink = torch.where(flat & (rank < K), rank, K)
    out = torch.full((K + 1,), -1, dtype=torch.int32, device=dev)
    out.scatter_(0, sink, torch.arange(flat.numel(), dtype=torch.int32, device=dev))
    return out[:K], n
