"""Device-side LCS construction: counterpart of finito_tpu/ops/lcs_jax.py.

Same dataflow as the host lcs_array (finito_tpu_torch/sbwt/lcs.py) and
the reference's k-round algorithm
(ref: include/lcs_basic_parallel_algorithm.hpp:52-120): round r marks
LCS[i] = r where the r-th-from-last label column first differs from the
row above, then propagates the column one de-Bruijn step (a permutation
scatter src -> dst derived from the out-edge bit matrix and the C
array). Each round is a few elementwise passes and one scatter over the
node axis; the node-sharded form over a mesh is
finito_tpu_torch.parallel.mesh.sharded_lcs_fn.
"""

from __future__ import annotations

import numpy as np
import torch


def lcs_scatter_indices(sbwt):
    """(src, dst) int32 permutation arrays for label propagation, from a
    host PlainMatrixSBWT (flat across the four characters)."""
    bit_rows = sbwt.bit_rows()
    C = np.asarray(sbwt.get_C_array(), dtype=np.int64)
    src, dst = [], []
    for c in range(4):
        s = np.flatnonzero(bit_rows[c])
        src.append(s)
        dst.append(np.arange(int(C[c]), int(C[c]) + s.size))
    return (
        np.concatenate(src).astype(np.int32),
        np.concatenate(dst).astype(np.int32),
    )


def first_labels(sbwt, size: int) -> np.ndarray:
    """(size,) int32 first label column: node i's last character as
    1..4 (from the C array), 0 for the '$' node and for padding past the
    node count."""
    n = sbwt.number_of_subsets()
    C = np.asarray(sbwt.get_C_array(), dtype=np.int64)
    cur0 = np.zeros(size, dtype=np.int32)
    for c in range(4):
        hi = int(C[c + 1]) if c < 3 else n
        cur0[int(C[c]) : hi] = c + 1
    return cur0


def lcs_array_device(sbwt, device="cuda") -> np.ndarray:
    """LCS array computed on device; host int64, equal to lcs_array."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but CUDA is not available")
    k = sbwt.get_k()
    n = sbwt.number_of_subsets()
    src, dst = (torch.from_numpy(a).to(device).to(torch.int64) for a in lcs_scatter_indices(sbwt))
    cur = torch.from_numpy(first_labels(sbwt, n)).to(device)
    lcs = torch.full((n,), k, dtype=torch.int32, device=device)
    first = torch.ones(1, dtype=torch.bool, device=device)
    for r in range(k):
        diff = torch.cat([first, cur[1:] != cur[:-1]])
        lcs = torch.where((lcs == k) & diff, r, lcs)
        nxt = torch.zeros_like(cur)
        nxt[dst] = cur[src]
        cur = nxt
    return lcs.cpu().numpy().astype(np.int64)
