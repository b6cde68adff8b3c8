"""Device-resident plain-matrix SBWT: packed words and rank superblocks
on one torch device; counterpart of finito_tpu/ops/bitvec.py.

The four out-edge bitvectors are stored as 32-bit words (int32 bit
patterns, ops.bits) with a cumulative popcount per word boundary, so

    rank_c(i) = blocks[c, i>>5] + popcount(words[c, i>>5] & ((1<<(i&31))-1))

is two gathers and one popcount. The four characters share one flat
array indexed c * n_words + w, so a batch of mixed characters is one
gather.
"""

from __future__ import annotations

import numpy as np
import torch

from finito_tpu_torch.ops.bits import popcount32, put_i32, u32
from finito_tpu_torch.ops.rank24 import extend_interval
from finito_tpu_torch.utils.bits import popcount_words


class DeviceSBWT:
    """The SBWT's rank tables on one device, with the leaves of the JAX
    DeviceSBWT: words (4 * n_words,) and blocks (4 * n_words,) int32, C
    (4,) int32, and k, n_nodes, n_words."""

    def __init__(self, words, blocks, C, k: int, n_nodes: int, n_words: int):
        self.words = words
        self.blocks = blocks
        self.C = C
        self.k = int(k)
        self.n_nodes = int(n_nodes)
        self.n_words = int(n_words)

    @staticmethod
    def from_numpy(words, blocks, C, k: int, n_nodes: int, n_words: int,
                   device="cuda") -> "DeviceSBWT":
        """From the JAX DeviceSBWT's leaves as numpy arrays (words uint32,
        blocks and C int32)."""
        return DeviceSBWT(put_i32(words, device), put_i32(blocks, device), put_i32(C, device),
                          k, n_nodes, n_words)

    @staticmethod
    def from_host(sbwt, device="cuda") -> "DeviceSBWT":
        """Upload a host PlainMatrixSBWT (64-bit words) as 32-bit words."""
        if sbwt.number_of_subsets() >= 2**31:
            raise ValueError("single-shard DeviceSBWT supports < 2^31 nodes; shard the index")
        n = sbwt.number_of_subsets()
        n_words = (n + 31) // 32 + 1  # +1 pad word so i == n_nodes is safe
        words = np.zeros((4, n_words), dtype=np.uint32)
        blocks = np.zeros((4, n_words), dtype=np.int32)
        for c in range(4):
            w32 = sbwt.words[c].view(np.uint32)[:n_words]  # one zero pad word already
            words[c, : w32.size] = w32
            pc = popcount_words(words[c]).astype(np.int64)
            blocks[c, 1:] = np.cumsum(pc[:-1])
        return DeviceSBWT.from_numpy(words.reshape(-1), blocks.reshape(-1),
                                     np.asarray(sbwt.get_C_array()), sbwt.get_k(), n, n_words,
                                     device)


def rank(sbwt: DeviceSBWT, c, i):
    """Batched rank_c(i); c in [0, 4), i in [0, n_nodes]. Returns int64."""
    flat = c * sbwt.n_words + (i >> 5)
    mask = (1 << (i & 31)) - 1
    return sbwt.blocks[flat] + popcount32(u32(sbwt.words[flat]) & mask)


def update_interval(sbwt: DeviceSBWT, c, lo, hi):
    """Batched SBWT right-extension (rank24.extend_interval over rank)."""
    return extend_interval(lambda cs, i: rank(sbwt, cs, i), sbwt.C, c, lo, hi)


def kmer_ranks_fixed(sbwt: DeviceSBWT, codes: torch.Tensor, k: int) -> torch.Tensor:
    """Colex rank of every k-window of every read; -1 where absent.

    codes: (..., L) uint8, pad/invalid = anything > 3. Returns (..., L-k+1)
    int32: k uniform extension steps over all windows at once (the JAX
    fori_loop, here a Python loop of k steps)."""
    L = codes.shape[-1]
    W = L - k + 1
    c = codes.to(torch.int64)
    lo = torch.zeros(codes.shape[:-1] + (W,), dtype=torch.int64, device=codes.device)
    hi = torch.full_like(lo, sbwt.n_nodes - 1)
    for j in range(k):
        lo, hi = update_interval(sbwt, c[..., j : j + W], lo, hi)
    return lo.to(torch.int32)


def search_batch_device(sbwt: DeviceSBWT, kmers: torch.Tensor) -> torch.Tensor:
    """Batched full-k-mer search: (n, k) codes -> (n,) int32 colex rank
    or -1."""
    n = kmers.shape[0]
    lo = torch.zeros(n, dtype=torch.int64, device=kmers.device)
    hi = torch.full_like(lo, sbwt.n_nodes - 1)
    for j in range(kmers.shape[1]):
        lo, hi = update_interval(sbwt, kmers[:, j], lo, hi)
    return lo.to(torch.int32)
