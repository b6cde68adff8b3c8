"""LCS array construction (longest common suffix of adjacent SBWT labels).

Same dataflow as the reference's k-round "basic parallel algorithm"
(ref: include/lcs_basic_parallel_algorithm.hpp:52-120),
re-expressed as whole-array vector ops instead of OpenMP thread blocks:

  round r:  LCS[i] := r  where LCS unset and column_r[i] != column_r[i-1]
            column_{r+1} := propagate labels one de-Bruijn step
                            (scatter column_r[src_c] into C[c]+arange)

column_r[i] is the r-th-from-last character of node i's label; the first
column is implied by the C array. Values in [0, k-1]; serialized width is
bit_width(k-1) like the reference (:115).

The device-side build is finito_tpu_torch/ops/lcs_device.py (one
device) and finito_tpu_torch/parallel/mesh.py:sharded_lcs_fn (the node
axis sharded over a mesh); both equal this function.
"""

from __future__ import annotations

import numpy as np

from finito_tpu_torch.sbwt.sbwt import PlainMatrixSBWT


def lcs_array(sbwt: PlainMatrixSBWT) -> np.ndarray:
    k = sbwt.k
    n = sbwt.n_nodes
    bit_rows = sbwt.bit_rows()
    C = sbwt.get_C_array()

    # Source node list per char, precomputed once (reference recomputes
    # rank per thread block each round).
    src = [np.flatnonzero(bit_rows[c]) for c in range(4)]
    dst = [np.arange(int(C[c]), int(C[c]) + len(src[c])) for c in range(4)]

    # cur[i] = incoming char code of node i in {0=$,1=A..4=T}; first column
    # is the last char of each label: grouped by the C array.
    cur = np.zeros(n, dtype=np.uint8)
    for c in range(4):
        hi = int(C[c + 1]) if c < 3 else n
        cur[int(C[c]) : hi] = c + 1

    lcs = np.full(n, k, dtype=np.int64)
    diff = np.empty(n, dtype=bool)
    for r in range(k):
        diff[0] = True
        np.not_equal(cur[1:], cur[:-1], out=diff[1:])
        lcs[(lcs == k) & diff] = r
        if r + 1 < k:
            nxt = np.zeros(n, dtype=np.uint8)  # node 0 gets '$'
            for c in range(4):
                nxt[dst[c]] = cur[src[c]]
            cur = nxt
    return lcs
