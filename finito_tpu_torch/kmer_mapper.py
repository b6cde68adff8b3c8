"""kmer-mapper on a torch device: counterpart of finito_tpu/kmer_mapper.py.

    python -m finito_tpu_torch.kmer_mapper build -u unitigs.fna -k K [-m M] -o index
    python -m finito_tpu_torch.kmer_mapper query -i index -q reads.fna [-r] [--host-exact] [--device cuda]
    python -m finito_tpu_torch.kmer_mapper extract-index-unitigs -i index -o out.fna

build, extract-index-unitigs and the index loader (a KMIDXv01 file is
imported) are jax-free host code, shared with finito_tpu.kmer_mapper;
so is query's --host-exact scan. The default query runs the port's
minimizer locate with count_occurrences on ``--device`` (default cuda;
cpu runs the plain PyTorch versions): one batch per strand, the v1/v2
rule of query.engine, the host fwd/RC merge that skips self-RC k-mers,
and the reference's "occurs in N unitigs" error, exit code 1, whenever
a window's total occurrence count exceeds 1. Output bytes equal the JAX
CLI's.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np
import torch

from finito_tpu import kmer_mapper as host_km
from finito_tpu.index.minimizer import MinimizerIndex
from finito_tpu.kmer_mapper import _load_index, build, extract_index_unitigs
from finito_tpu_torch.query.engine import pick_v2
from finito_tpu_torch.query.minimizer_engine import (
    DeviceMinimizerIndex,
    make_minimizer_locate,
    make_minimizer_locate_v2,
)
from finito_tpu_torch.query.minimizer_tables import grow_capacities, initial_capacities


def _device_locate(index: MinimizerIndex, reads: List[bytes], rc: bool, device="cuda"):
    """Per-read lists of (u, p) with the fwd/RC merge, located on device.
    Exits with the reference's 'occurs in N unitigs' error whenever a
    k-mer's total occurrence count exceeds 1, forward-only duplicates
    included and with or without rc (main.rs:89-92)."""
    from finito_tpu.io.seqdb import decode_seq, encode_seq
    from finito_tpu.utils import tune_host_allocator

    tune_host_allocator()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but CUDA is not available")
    k = index.k
    dmi = DeviceMinimizerIndex(index, device)
    use_v2 = pick_v2(dmi)

    def locate_batch(codes: np.ndarray):
        B, L = codes.shape
        BW = B * (L - k + 1)
        codes = torch.from_numpy(codes).to(device)
        # 2x the engine's slow headroom: counting scans slots to the end
        K, KH = initial_capacities(BW, use_v2, slow_divisor=128 if use_v2 else 16)
        while True:
            if use_v2:
                uid, off, n_slow, n_heads, cnt = make_minimizer_locate_v2(
                    dmi, K, KH, count_occurrences=True)(codes)
                n_slow, n_heads = torch.stack([n_slow, n_heads]).tolist()
            else:
                uid, off, n_slow, cnt = make_minimizer_locate(dmi, K, count_occurrences=True)(codes)
                n_slow, n_heads = int(n_slow), 0
            grown = grow_capacities(K, KH, n_slow, n_heads, BW)
            if grown is None:
                return uid.cpu().numpy(), off.cpu().numpy(), cnt.cpu().numpy()
            K, KH = grown

    answers = []
    batch_idx, batch_codes = [], []
    for i, read in enumerate(reads):
        codes = encode_seq(read)
        answers.append(None)
        if codes.size < k:
            answers[i] = []
        else:
            batch_idx.append(i)
            batch_codes.append(codes)
    if not batch_idx:
        return answers
    L = max(c.size for c in batch_codes)
    B = len(batch_codes)
    fwd = np.full((B, L), 255, dtype=np.uint8)
    rcm = np.full((B, L), 255, dtype=np.uint8)
    for j, c in enumerate(batch_codes):
        fwd[j, : c.size] = c
        rcm[j, : c.size] = (3 - c)[::-1]
    uid_f, off_f, cnt_f = locate_batch(fwd)
    if rc:
        uid_r, off_r, cnt_r = locate_batch(rcm)
    for j, i in enumerate(batch_idx):
        n = batch_codes[j].size - k + 1
        u = uid_f[j, :n].astype(np.int64)
        o = off_f[j, :n].astype(np.int64)
        total = cnt_f[j, :n].astype(np.int64)
        if rc:
            ur = uid_r[j, :n][::-1].astype(np.int64)
            orr = off_r[j, :n][::-1].astype(np.int64)
            w_mat = np.lib.stride_tricks.sliding_window_view(batch_codes[j], k)
            self_rc = np.all(w_mat == (3 - w_mat)[:, ::-1], axis=1)
            total = total + np.where(self_rc, 0, cnt_r[j, :n][::-1].astype(np.int64))
            rc_hit = (ur != -1) & ~self_rc
            u = np.where(rc_hit & (u == -1), ur, u)
            o = np.where(rc_hit & (o == -1), orr, o)
        if np.any(total > 1):
            w = int(np.flatnonzero(total > 1)[0])
            kmer = decode_seq(batch_codes[j][w : w + k]).decode()
            sys.stderr.write(f"Error: k-mer {kmer} occurs in {int(total[w])} unitigs\n")
            raise SystemExit(1)
        answers[i] = list(zip(u.tolist(), o.tolist()))
    return answers


def query(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="kmer-mapper query", description="Mapping k-mers to unitigs")
    p.add_argument("-i", "--index", required=True, help="Index file")
    p.add_argument("-q", "--query", required=True, help="Input FASTA or FASTQ file, possibly gzipped")
    p.add_argument("-r", "--reverse-complements", action="store_true",
                   help="Whether to also report reverse complement matches")
    p.add_argument("--host-exact", action="store_true",
                   help="Per-window host lookup with full multi-occurrence detection")
    p.add_argument("-o", "--outfile", default=None, help="Output file (default stdout)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the query (default cuda; cpu runs the plain "
                   "PyTorch versions of the kernels)")
    args = p.parse_args(argv)
    if args.host_exact:  # the shared host scan; it never touches a device
        host_argv = ["-i", args.index, "-q", args.query, "--host-exact"]
        host_argv += ["-r"] if args.reverse_complements else []
        host_argv += ["-o", args.outfile] if args.outfile else []
        return host_km.query(host_argv)

    from finito_tpu.io.fastx import SequenceReader

    index = _load_index(args.index)
    out = open(args.outfile, "w") if args.outfile else sys.stdout
    try:
        with SequenceReader(args.query) as reader:
            reads = [bytes(s) for _h, s in reader]
        for line in _device_locate(index, reads, args.reverse_complements, args.device):
            out.write(" ".join(f"({u},{p})" for u, p in line) + "\n")
    finally:
        if args.outfile:
            out.close()
    return 0


COMMANDS = {
    "build": build,
    "query": query,
    "extract-index-unitigs": extract_index_unitigs,
}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        sys.stderr.write("kmer-mapper: Mapping k-mers to unitigs\n\nCommands:\n")
        for c in COMMANDS:
            sys.stderr.write(f"   kmer-mapper {c}\n")
        return 1
    fn = COMMANDS.get(argv[0])
    if fn is None:
        sys.stderr.write(f"Invalid command: {argv[0]}\n")
        return 1
    return fn(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
