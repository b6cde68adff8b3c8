"""kmer-mapper on a torch device: counterpart of finito_tpu/kmer_mapper.py,
the equivalent of the reference's Rust implementation
(ref_implementation/src/main.rs:133-305).

    python -m finito_tpu_torch.kmer_mapper build -u unitigs.fna -k K [-m M] -o index
    python -m finito_tpu_torch.kmer_mapper query -i index -q reads.fna [-r] [--host-exact] [--device cuda]
    python -m finito_tpu_torch.kmer_mapper extract-index-unitigs -i index -o out.fna

build permutes the unitigs by the colexicographic order of their first
k-mer (main.rs:42-61) and writes an FTMIDX02 index (index/minimizer.py);
-m above 16 is clamped (query answers are independent of m). query and
extract-index-unitigs also import a Rust KMIDXv01 file one-way
(io/kmidx.py). The default query runs the port's minimizer locate with
count_occurrences on ``--device`` (default cuda; cpu runs the plain
PyTorch versions): one batch per strand, the engine's v1/v2 rule
(query.minimizer_engine.pick_v2), the host fwd/RC merge that skips
self-RC k-mers, and the reference's "occurs in N unitigs" error, exit
code 1, whenever a window's total occurrence count exceeds 1.
--host-exact is the per-window host scan with full multi-occurrence
detection; it touches no device.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from finito_tpu_torch.index.minimizer import MinimizerIndex, default_m
from finito_tpu_torch.query.minimizer_engine import (
    DeviceMinimizerIndex,
    make_minimizer_locate_form,
    pick_v2,
)
from finito_tpu_torch.query.locators import Optimistic, minimizer_policy


def _colex_key(kmer: bytes) -> bytes:
    return kmer[::-1]


def permute_by_first_kmer(records: List[tuple], k: int) -> List[tuple]:
    """Sort records by colex order of their first k-mer (main.rs:42-61)."""
    return sorted(records, key=lambda rec: _colex_key(bytes(rec[1][:k])))


def build(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="kmer-mapper build", description="Mapping k-mers to unitigs")
    p.add_argument("-u", "--unitigs", required=True, help="Input FASTA or FASTQ file, possibly gzipped")
    p.add_argument("-t", "--nthreads", type=int, default=1, help="Number of host build threads (native sort kernels)")
    p.add_argument("-o", "--outfile", required=True, help="Output index file")
    p.add_argument("-k", type=int, required=True, help="k-mer length")
    p.add_argument("-m", type=int, default=None, help="minimizer length (default: auto; values above 16 are clamped)")
    args = p.parse_args(argv)
    if args.nthreads > 1:
        os.environ.setdefault("FINITO_THREADS", str(args.nthreads))

    from finito_tpu_torch.io.fastx import read_all_records
    from finito_tpu_torch.io.seqdb import encode_seq

    records = read_all_records(args.unitigs)
    sys.stderr.write(f"Read {len(records)} unitigs\n")
    sys.stderr.write("Sorting unitigs by first k-mer\n")
    records = permute_by_first_kmer(records, args.k)

    seqs = [encode_seq(bytes(s)) for _h, s in records]
    concat = np.concatenate(seqs) if seqs else np.zeros(0, np.uint8)
    ends = np.cumsum([s.size for s in seqs]).astype(np.int64)

    m = args.m
    if m is not None and m > 16:
        sys.stderr.write(f"m={m} clamped to 16 (query answers are independent of m)\n")
        m = 16
    if m is None:
        m = default_m(args.k)
    sys.stderr.write(f"k = {args.k}, m = {m}\n")

    index = MinimizerIndex.build(concat, ends, args.k, m=m)
    index.headers = [bytes(h) for h, _s in records]
    sys.stderr.write(f"Saving index to {args.outfile}\n")
    index.serialize(args.outfile)
    return 0


def _device_locate(index: MinimizerIndex, reads: List[bytes], rc: bool, device="cuda"):
    """Per-read lists of (u, p) with the fwd/RC merge, located on device.
    Exits with the reference's 'occurs in N unitigs' error whenever a
    k-mer's total occurrence count exceeds 1, forward-only duplicates
    included and with or without rc (main.rs:89-92)."""
    from finito_tpu_torch.io.seqdb import decode_seq, encode_seq
    from finito_tpu_torch.utils import tune_host_allocator

    tune_host_allocator()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but CUDA is not available")
    k = index.k
    dmi = DeviceMinimizerIndex(index, device)
    use_v2 = pick_v2(dmi)

    def locate_batch(codes: np.ndarray):
        B, L = codes.shape
        codes = torch.from_numpy(codes).to(device)
        # 2x the engine's slow headroom: counting scans slots to the end
        check = Optimistic(lambda caps: make_minimizer_locate_form(
            dmi, use_v2, *caps, count_occurrences=True)(codes),
            *minimizer_policy(B, L, k, use_v2, slow_divisor=128 if use_v2 else 16))
        check.verify()
        uid, off, _, cnt = check.out
        return uid.cpu().numpy(), off.cpu().numpy(), cnt.cpu().numpy()

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

    from finito_tpu_torch.io.fastx import SequenceReader, reverse_complement
    from finito_tpu_torch.io.seqdb import encode_seq

    index = _load_index(args.index)
    k = index.k
    out = open(args.outfile, "w") if args.outfile else sys.stdout

    def emit(line):
        out.write(" ".join(f"({u},{p})" for u, p in line) + "\n")

    try:
        if args.host_exact:
            with SequenceReader(args.query) as reader:
                for _h, read in reader:
                    read = bytes(read)
                    line = []
                    for w in range(max(0, len(read) - k + 1)):
                        kmer = read[w : w + k]
                        occs = index.lookup_kmer_host_all(encode_seq(kmer))
                        if args.reverse_complements:
                            rck = reverse_complement(kmer)
                            if rck != kmer:
                                occs = occs + index.lookup_kmer_host_all(encode_seq(rck))
                        if len(occs) > 1:
                            sys.stderr.write(
                                f"Error: k-mer {kmer.decode()} occurs in {len(occs)} unitigs\n"
                            )
                            raise SystemExit(1)
                        line.append(occs[0] if occs else (-1, -1))
                    emit(line)
        else:
            with SequenceReader(args.query) as reader:
                reads = [bytes(s) for _h, s in reader]
            for line in _device_locate(index, reads, args.reverse_complements, args.device):
                emit(line)
    finally:
        if args.outfile:
            out.close()
    return 0


def extract_index_unitigs(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="kmer-mapper extract-index-unitigs")
    p.add_argument("-i", "--index", required=True, help="Index file")
    p.add_argument("-o", "--outfile", required=True, help="Output fasta file")
    args = p.parse_args(argv)

    from finito_tpu_torch.io.fastx import SequenceWriter
    from finito_tpu_torch.io.seqdb import decode_seq

    index = _load_index(args.index)
    with SequenceWriter(args.outfile) as w:
        start = 0
        for uid, e in enumerate(index.ends):
            seq = decode_seq(index.concat[start : int(e)])
            header = (
                index.headers[uid]
                if index.headers is not None and uid < len(index.headers)
                else f"unitig_{uid}".encode()
            )
            w.write_record(header, seq)
            start = int(e)
    return 0


def _load_index(path: str):
    """Load a finito FTMIDX index, or import a Rust KMIDXv01 file
    (one-way; see io/kmidx.py for the verification status)."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic == b"KMIDXv01":
        from finito_tpu_torch.io.kmidx import import_kmidx

        sys.stderr.write("Importing Rust KMIDXv01 index (rebuilding hash-slot table)\n")
        return import_kmidx(path)
    return MinimizerIndex.load(path)


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
