"""The plain reference of `search-fmin`'s served output, in plain PyTorch
on whatever device it is given. It imports nothing of the program and
reads nothing the program made: it starts from the generated unitig set
(flat codes and their ends, benchmark/datagen.py) and from the read pool.

The rules it follows are Finito's own (github.com/ElenaBiagi/Finito):

  * unitig ids: unitigs are numbered in colexicographic order of their
    first k-mer (include/PackedStrings.hh, permute_unitigs);
  * a window's answer: the (unitig, offset) of the one unitig window that
    spells it (a DSPSS holds each k-mer once), else (-1,-1); with
    canonical unitigs a k-mer stored reverse-complemented is found by the
    strand merge below;
  * the strand merge (include/search_fmin.hh:62-71): window w of a read
    takes its forward hit, else the hit of window n-1-w of the read's
    reverse complement, which spells the reverse complement of window w;
  * a read with a base outside ACGT, or shorter than k, gives an empty
    line (include/common.hh:108-111 returns {} for the read);
  * the line: "(u,p)" per window, joined by single spaces, then "\\n";
  * the found counts: windows of the forward read found, plus windows
    of its reverse complement found.

With rc=False the reverse complement is never looked up: the control,
which breaks the strand-merge guarantee.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.datagen import cut_unitigs


def _pack(codes: torch.Tensor, k: int, reverse_complement: bool) -> torch.Tensor:
    """int64 key of every k-window of a flat 0..3 code tensor: the window
    itself, first base most significant, or its reverse complement."""
    n = codes.numel() - k + 1
    c = codes.to(torch.int64)
    key = torch.zeros(max(n, 0), dtype=torch.int64, device=codes.device)
    for j in range(k):
        if reverse_complement:
            key |= (3 - c[j : j + n]) << (2 * j)
        else:
            key = (key << 2) | c[j : j + n]
    return key


def unitig_ids(codes: np.ndarray, ends: np.ndarray, k: int) -> np.ndarray:
    """Index id of each unitig of a set (flat codes, exclusive ends): its
    rank in colex order of the unitigs' first k-mers (the last base
    compares first)."""
    starts = np.concatenate([[0], np.asarray(ends, np.int64)[:-1]])
    first = codes[starts[:, None] + np.arange(k)[None, :]].astype(np.uint64)
    key = np.zeros(first.shape[0], np.uint64)
    for j in range(k - 1, -1, -1):
        key = (key << np.uint64(2)) | first[:, j]
    ids = np.empty(key.size, np.int64)
    ids[np.argsort(key, kind="stable")] = np.arange(key.size)
    return ids


class Reference:
    """Every unitig window's (unitig id, offset), sorted by key."""

    def __init__(self, genome: np.ndarray, cuts: np.ndarray, k: int, device):
        """The reference of genome cut into unitigs at cuts (datagen.draw_cuts);
        Reference.of_unitigs takes any unitig set."""
        self._index(*cut_unitigs(genome, cuts, k), k, device)

    @classmethod
    def of_unitigs(cls, codes: np.ndarray, ends: np.ndarray, k: int, device) -> "Reference":
        """The reference of a unitig set: flat 0..3 codes and each unitig's
        exclusive end. A k-mer in two windows raises: the set is no DSPSS."""
        ref = cls.__new__(cls)
        ref._index(codes, ends, k, device)
        return ref

    def _index(self, codes: np.ndarray, ends: np.ndarray, k: int, device) -> None:
        self.k, self.device = k, torch.device(device)
        ends = np.asarray(ends, np.int64)
        c = torch.from_numpy(np.ascontiguousarray(codes)).to(self.device)
        keys = _pack(c, k, False)
        pos = torch.arange(keys.numel(), dtype=torch.int64, device=self.device)
        ends_d = torch.from_numpy(ends).to(self.device)
        unitig = torch.searchsorted(ends_d, pos, right=True)
        inside = pos + k <= ends_d[unitig]  # the windows that cross no unitig's end
        keys, pos, unitig = keys[inside], pos[inside], unitig[inside]
        starts_d = torch.cat([ends_d.new_zeros(1), ends_d[:-1]])
        ids = torch.from_numpy(unitig_ids(codes, ends, k)).to(self.device)
        self.keys, order = torch.sort(keys)
        if bool((self.keys[1:] == self.keys[:-1]).any()):
            raise ValueError("a k-mer lies in two unitig windows: the unitig set is no DSPSS")
        self.uid = ids[unitig][order].to(torch.int32)
        self.off = (pos - starts_d[unitig])[order].to(torch.int32)

    def lookup(self, keys: torch.Tensor):
        i = torch.searchsorted(self.keys, keys).clamp(max=self.keys.numel() - 1)
        hit = self.keys[i] == keys
        return hit, torch.where(hit, self.uid[i], -1), torch.where(hit, self.off[i], -1)

    def answer(self, codes: np.ndarray, ends: np.ndarray, rc: bool = True):
        """Reads given as flat codes (values > 3 are not ACGT) and their
        exclusive ends. Returns per read (windows, found, line bytes) as
        int64 arrays, and per window the merged (u, p) as int32 device
        tensors with each window's read and the reads' first windows."""
        k = self.k
        ends = np.asarray(ends, np.int64)
        lens = np.diff(np.concatenate([[0], ends]))
        c = torch.from_numpy(np.ascontiguousarray(codes)).to(self.device)
        bad = (c > 3).to(torch.int64)
        ends_d = torch.from_numpy(ends).to(self.device)
        starts_d = ends_d - torch.from_numpy(lens).to(self.device)
        n_bad = torch.zeros(ends.size, dtype=torch.int64, device=self.device)
        read_of_base = torch.searchsorted(ends_d, torch.arange(c.numel(), device=self.device),
                                          right=True)
        n_bad.index_add_(0, read_of_base, bad)
        ok = (n_bad == 0) & (ends_d - starts_d >= k)
        W = torch.where(ok, ends_d - starts_d - k + 1, 0)
        first = torch.cumsum(W, 0) - W
        # window j of read r starts at base starts[r] + j
        rid = torch.repeat_interleave(torch.arange(ends.size, device=self.device), W)
        at = starts_d[rid] + torch.arange(rid.numel(), device=self.device) - first[rid]
        cc = c & 3
        fwd = _pack(cc, k, False)[at] if at.numel() else at
        hf, uf, pf = self.lookup(fwd)
        if rc:
            hr, ur, pr = self.lookup(_pack(cc, k, True)[at] if at.numel() else at)
        else:
            hr = torch.zeros_like(hf)
            ur = pr = torch.full_like(uf, -1)
        u = torch.where(hf, uf, ur)
        p = torch.where(hf, pf, pr)
        per_read = torch.zeros(ends.size, dtype=torch.int64, device=self.device)
        found = per_read.clone().index_add_(0, rid, hf.to(torch.int64) + hr.to(torch.int64))
        nbytes = per_read.clone().index_add_(0, rid, 4 + _digits(u) + _digits(p))
        nbytes = nbytes + torch.where(W > 0, 0, 1)  # an empty line is "\n"
        return (W.cpu().numpy(), found.cpu().numpy(), nbytes.cpu().numpy(),
                u.to(torch.int32), p.to(torch.int32), first.cpu().numpy())


def _digits(x: torch.Tensor) -> torch.Tensor:
    """Characters of each value in decimal, a minus sign included."""
    x = x.to(torch.int64)
    n = torch.ones_like(x) + (x < 0).to(torch.int64)
    a = x.abs()
    p = 10
    while p <= 10 ** 10:
        n += (a >= p).to(torch.int64)
        p *= 10
    return n


def line(u: np.ndarray, p: np.ndarray) -> bytes:
    """One output line from a read's merged pairs."""
    return (" ".join(map("(%d,%d)".__mod__, zip(u.tolist(), p.tolist()))) + "\n").encode()
