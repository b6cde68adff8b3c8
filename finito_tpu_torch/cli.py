"""Command-line interface of the port: the host commands and
``search-fmin``/``kmer-mapper`` on a torch device.

    python -m finito_tpu_torch.cli unitigs -k K -i reads.fna -o unitigs.fna [--flip] [--mesh N]
    python -m finito_tpu_torch.cli flip-unitigs -k K -i unitigs.fna -o flipped.fna
    python -m finito_tpu_torch.cli sbwt-build -k K -i unitigs.fna -o index.sbwt
    python -m finito_tpu_torch.cli convert-sbwt -i in.sbwt -o out.sbwt --to algbio|finito
    python -m finito_tpu_torch.cli build-fmin -i index.sbwt -u unitigs.fna -o <prefix> [--type ...]
    python -m finito_tpu_torch.cli search-fmin -i <prefix> -q reads.fna -o out.txt [--device cuda] [--mesh DP,TP]
    python -m finito_tpu_torch.cli kmer-mapper query -i index -q reads.fna [-r] [--device cuda]

The flags, the `.txt` file-of-files fan-out, the output line format
`(u,p) (u,p)...` and the stats-file layouts are those of the reference
binary's dispatcher (including its stats file naming: `<index>.stats` and
`<index>stats.txt` without a dot). The host commands run on the CPU;
search-fmin and kmer-mapper take ``--device`` (default cuda; cpu runs the
plain PyTorch versions of the kernels); search-fmin takes ``--mesh DP,TP``
(minimizer engine); unitigs takes ``--mesh N`` (the sharded build,
parallel.shard_dbg, on N devices) and ``--device``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np

from finito_tpu_torch.utils.logging import LogLevel, cur_time_micros, set_log_level, write_log

AVAILABLE_TYPES = ["rarest", "shortest", "verify"]


def readlines(path: str) -> List[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def check_readable(path: str) -> None:
    if not os.path.isfile(path) or not os.access(path, os.R_OK):
        raise RuntimeError(f"Error: file not readable: {path}")


def check_writable(path: str) -> None:
    d = os.path.dirname(path) or "."
    if not os.access(d, os.W_OK):
        raise RuntimeError(f"Error: file not writable: {path}")


def _expand_file_list(arg: str) -> List[str]:
    """'.txt' extension = list of files, one per line (ref: build_fmin.hh:338-343)."""
    if len(arg) >= 4 and arg.endswith(".txt"):
        return readlines(arg)
    return [arg]


# --------------------------------------------------------------- sbwt-build


def sbwt_build(argv: List[str]) -> int:
    p = argparse.ArgumentParser(
        prog="finito sbwt-build",
        description="Build a plain-matrix SBWT from a FASTA/FASTQ string set "
        "(replaces the reference pipeline's external `sbwt build`).",
    )
    p.add_argument("-i", "--in-file", required=True, help="Input FASTA/FASTQ (possibly gzipped)")
    p.add_argument("-o", "--out-file", required=True, help="Output .sbwt path")
    p.add_argument("-k", type=int, required=True, help="k-mer length")
    args = p.parse_args(argv)

    from finito_tpu_torch.io import sdsl
    from finito_tpu_torch.io.fastx import read_all_records
    from finito_tpu_torch.sbwt.construct import build_plain_matrix_sbwt

    check_readable(args.in_file)
    seqs = [s for _h, s in read_all_records(args.in_file)]
    write_log(f"Building plain-matrix SBWT over {len(seqs)} sequences, k={args.k}", LogLevel.MAJOR)
    sbwt = build_plain_matrix_sbwt(seqs, args.k)
    with open(args.out_file, "wb") as f:
        sdsl.serialize_string(f, "plain-matrix")
        sbwt.serialize(f)
    write_log(
        f"Wrote {args.out_file}: {sbwt.number_of_subsets()} nodes, "
        f"{sbwt.number_of_kmers()} k-mers",
        LogLevel.MAJOR,
    )
    return 0


# ------------------------------------------------------------------ unitigs


def unitigs_cmd(argv: List[str]) -> int:
    p = argparse.ArgumentParser(
        prog="finito unitigs",
        description="Build canonical unitigs (a DSPSS) from raw FASTA/FASTQ "
        "-- the construction step the reference delegates to the external "
        "`ggcat build --min-multiplicity 1` (reference README 'Additional "
        "info'); here native, so the whole reads -> index pipeline needs "
        "no third-party tool.",
    )
    p.add_argument("-i", "--in-file", required=True,
                   help="Input FASTA/FASTQ (possibly gzipped); non-ACGT "
                   "characters split sequences")
    p.add_argument("-o", "--out-file", required=True, help="Output unitig FASTA")
    p.add_argument("-k", type=int, required=True, help="k-mer length (odd)")
    p.add_argument("--forward-only", action="store_true",
                   help="directed dBG over the exact k-mers seen "
                   "(default: canonical / bidirected, like ggcat)")
    p.add_argument("--flip", action="store_true",
                   help="re-orient the unitigs for head-to-tail chaining "
                   "(fewer SBWT dummy chains; the unitig_flipper step)")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="shard the node set + successor joins over an "
                   "N-device mesh (parallel.shard_dbg; 0 = host build)")
    p.add_argument("--device", default="cuda",
                   help="devices of --mesh N (default cuda: the first N "
                   "cards, or every card when fewer are visible; one "
                   "device such as cuda:0 or cpu holds all N shards)")
    p.add_argument("--min-multiplicity", type=int, default=1, metavar="M",
                   help="drop k-mers seen fewer than M times (like "
                   "ggcat; use >= 2 for raw sequencing reads)")
    p.add_argument("--mode", choices=["unitigs", "simplitigs"],
                   default="unitigs",
                   help="simplitigs: greedy maximal walks through branch "
                   "nodes -- same k-mer set, far fewer strings, smaller "
                   "downstream index (the eulertig-style space win)")
    args = p.parse_args(argv)

    from finito_tpu_torch.dbg import flip_unitigs, unitigs_from_fasta
    from finito_tpu_torch.io.fastx import SequenceWriter
    from finito_tpu_torch.io.seqdb import decode_seq

    check_readable(args.in_file)
    check_writable(args.out_file)
    write_log(f"Building unitigs k={args.k} from {args.in_file}", LogLevel.MAJOR)
    if args.mode == "simplitigs":
        if args.forward_only or args.mesh > 1:
            raise SystemExit("--mode simplitigs: host canonical build only")
        from finito_tpu_torch.dbg import build_simplitigs
        from finito_tpu_torch.io.fastx import SequenceReader
        from finito_tpu_torch.io.seqdb import encode_seq

        with SequenceReader(args.in_file) as r:
            seqs = [encode_seq(seq) for _h, seq in r]
        unis = build_simplitigs(seqs, args.k, min_mult=args.min_multiplicity)
    elif args.mesh > 1:
        if args.forward_only:
            raise SystemExit("--mesh supports canonical mode only")
        if args.min_multiplicity > 1:
            raise SystemExit("--min-multiplicity requires the host build (no --mesh)")
        from finito_tpu_torch.io.fastx import SequenceReader
        from finito_tpu_torch.io.seqdb import encode_seq
        from finito_tpu_torch.parallel.shard_build import shard_devices
        from finito_tpu_torch.parallel.shard_dbg import sharded_unitig_build

        devices = shard_devices(args.device, args.mesh, fewer_ok=True)
        if len(devices) < args.mesh:
            write_log(f"--mesh {args.mesh}: {len(devices)} card(s) visible, "
                      f"building on {len(devices)} shard(s)", LogLevel.MAJOR)
        with SequenceReader(args.in_file) as r:
            seqs = [encode_seq(seq) for _h, seq in r]
        unis = sharded_unitig_build(seqs, args.k, devices=devices)
    else:
        unis = unitigs_from_fasta(
            args.in_file, args.k, canonical=not args.forward_only,
            min_mult=args.min_multiplicity,
        )
    if args.flip:
        unis = flip_unitigs(unis, args.k)
    with SequenceWriter(args.out_file, fasta=True) as w:
        for i, u in enumerate(unis):
            w.write_record(str(i).encode(), decode_seq(u))
    n_kmers = sum(max(0, u.size - args.k + 1) for u in unis)
    write_log(
        f"Wrote {args.out_file}: {len(unis)} unitigs, {n_kmers} distinct "
        f"{'canonical ' if not args.forward_only else ''}k-mers",
        LogLevel.MAJOR,
    )
    return 0


# -------------------------------------------------------------- flip-unitigs


def flip_unitigs_cmd(argv: List[str]) -> int:
    p = argparse.ArgumentParser(
        prog="finito flip-unitigs",
        description="Re-orient unitigs so they chain head-to-tail, "
        "shrinking the SBWT's $-dummy chains -- the native equivalent "
        "of the external `unitig_flipper` the reference README "
        "recommends before `sbwt build`.",
    )
    p.add_argument("--input", "-i", required=True, help="Unitig FASTA/FASTQ")
    p.add_argument("--output", "-o", required=True, help="Output FASTA")
    p.add_argument("-k", type=int, required=True)
    args = p.parse_args(argv)

    from finito_tpu_torch.dbg import flip_unitigs
    from finito_tpu_torch.io.fastx import SequenceReader, SequenceWriter
    from finito_tpu_torch.io.seqdb import decode_seq, encode_seq

    check_readable(args.input)
    check_writable(args.output)
    seqs = []
    headers = []
    with SequenceReader(args.input) as r:
        for hdr, seq in r:
            headers.append(hdr)
            seqs.append(encode_seq(seq))
    flipped = flip_unitigs(seqs, args.k)
    n_flip = sum(
        0 if np.array_equal(a, b) else 1 for a, b in zip(seqs, flipped)
    )
    with SequenceWriter(args.output, fasta=True) as w:
        for hdr, u in zip(headers, flipped):
            w.write_record(hdr, decode_seq(u))
    write_log(
        f"Wrote {args.output}: {len(flipped)} unitigs, {n_flip} flipped",
        LogLevel.MAJOR,
    )
    return 0


# -------------------------------------------------------------- convert-sbwt


def convert_sbwt(argv: List[str]) -> int:
    p = argparse.ArgumentParser(
        prog="finito convert-sbwt",
        description="Convert a standalone .sbwt between finito's FINSBWT1 "
        "container and the algbio/SBWT plain-matrix layout.",
    )
    p.add_argument("-i", "--in-file", required=True)
    p.add_argument("-o", "--out-file", required=True)
    p.add_argument("--to", required=True, choices=["algbio", "finito"])
    args = p.parse_args(argv)

    from finito_tpu_torch.io import sdsl
    from finito_tpu_torch.io.algbio_sbwt import (
        read_algbio_sbwt,
        sniff_format,
        write_algbio_sbwt,
    )
    from finito_tpu_torch.sbwt.sbwt import PlainMatrixSBWT

    check_readable(args.in_file)
    fmt = sniff_format(args.in_file)
    if fmt == "finito":
        with open(args.in_file, "rb") as f:
            head = f.read(8)
            f.seek(0)
            if head != PlainMatrixSBWT.MAGIC:  # variant header precedes
                sdsl.load_string(f)
            sbwt = PlainMatrixSBWT.load(f)
    else:
        sbwt, _sgs = read_algbio_sbwt(
            args.in_file, variant_header=(fmt == "algbio")
        )
    write_log(
        f"Loaded {args.in_file} ({fmt}): {sbwt.number_of_subsets()} nodes, "
        f"k={sbwt.get_k()}",
        LogLevel.MAJOR,
    )
    if args.to == "algbio":
        write_algbio_sbwt(args.out_file, sbwt, variant_header=True)
    else:
        with open(args.out_file, "wb") as f:
            sdsl.serialize_string(f, "plain-matrix")
            sbwt.serialize(f)
    write_log(f"Wrote {args.out_file} ({args.to})", LogLevel.MAJOR)
    return 0


# --------------------------------------------------------------- build-fmin


def build_fmin(argv: List[str]) -> int:
    set_log_level(LogLevel.MINOR)
    p = argparse.ArgumentParser(
        prog="finito build-fmin", description="Find all Finimizers of all input reads."
    )
    p.add_argument("-o", "--out-file", required=True, help="Output index filename prefix.")
    p.add_argument("-i", "--index-file", required=True, help="SBWT file (plain-matrix binary).")
    p.add_argument(
        "-u", "--in-file", required=True,
        help="SPSS in FASTA/FASTQ, possibly gzipped; .txt = list of input files.",
    )
    p.add_argument("--type", default="rarest", choices=AVAILABLE_TYPES)
    p.add_argument("-t", type=int, default=1, help="Maximum finimizer frequency")
    p.add_argument("--lcs", default="", help="Optional precomputed LCS file")
    p.add_argument("--device", default="cuda",
                   help="torch device of the SBWT search that ranks the windows when the "
                   ".sbwt does not match the unitigs (default cuda; cpu runs it on the "
                   "CPU). The usual build ranks them on the host and touches no device.")
    args = p.parse_args(argv)

    from finito_tpu_torch import stats_modes
    from finito_tpu_torch.index.builder import FinimizerIndexBuilder, finimizer_stats_string
    from finito_tpu_torch.io import sdsl
    from finito_tpu_torch.io.fastx import SequenceReader
    from finito_tpu_torch.io.seqdb import SeqDB, encode_seq
    from finito_tpu_torch.sbwt.lcs import lcs_array
    from finito_tpu_torch.sbwt.sbwt import PlainMatrixSBWT

    # The reference truncates t through a char (build_fmin.hh:333).
    t = int(np.int64(args.t).astype(np.int8))

    input_files = _expand_file_list(args.in_file)
    for f in input_files:
        check_readable(f)
    out_prefix = args.out_file

    check_readable(args.index_file)
    with open(args.index_file, "rb") as f:
        variant = sdsl.load_string(f)
        if variant != "plain-matrix":
            sys.stderr.write(
                "Error loading index from file: unrecognized variant specified in the file\n"
            )
            return 1
        write_log("Loading the index variant " + variant, LogLevel.MAJOR)
        # payload auto-detect: finito's FINSBWT1 container or the
        # algbio/SBWT layout the reference pipeline produces
        pos = f.tell()
        magic = f.read(8)
        f.seek(pos)
        if magic == PlainMatrixSBWT.MAGIC:
            sbwt = PlainMatrixSBWT.load(f)
        else:
            from finito_tpu_torch.io.algbio_sbwt import read_algbio_sbwt

            sbwt, _sgs = read_algbio_sbwt(f, variant_header=False)

    lcs_file = args.lcs
    if not lcs_file:
        sys.stderr.write("LCS_file empty\n")
        lcs_file = out_prefix + ".LCS.sdsl"
        lcs = lcs_array(sbwt)
        from finito_tpu_torch.utils.bits import bit_width_for_max

        sdsl.save_int_vector(lcs_file, lcs, bit_width_for_max(sbwt.get_k() - 1))
    LCS = sdsl.load_int_vector(lcs_file).values.astype(np.int64)
    sys.stderr.write("LCS_file loaded\n")

    if len(input_files) > 1:
        # The reference's multi-file build is broken (moved-from SBWT on the
        # second file, build_fmin.hh:288-296); it is rejected explicitly.
        raise RuntimeError(
            "build-fmin supports a single input file (the reference's multi-file "
            "build path is non-functional); concatenate inputs or build per file."
        )
    infile = input_files[0]
    write_log(
        f"Searching Finimizers from input file {infile} to index prefix {out_prefix}",
        LogLevel.MAJOR,
    )

    result = ""
    if args.type == "rarest":
        if t != 1:
            raise RuntimeError("t != 1 does not make sense with rarest type")
        db = SeqDB.from_file(infile)
        # Recompute the sorted node keys from the unitigs so the builder
        # resolves window colex ranks by one key merge instead of
        # per-window SBWT search (the genome-scale fast path). The
        # reconstruction doubles as a consistency check: it must
        # reproduce the loaded SBWT bit-for-bit, else fall back.
        node_keys = None
        try:
            starts_u = np.concatenate([[0], np.asarray(db.ends[:-1], np.int64)])
            code_slices = [
                db.concat[a:b] for a, b in zip(starts_u, np.asarray(db.ends, np.int64))
            ]
            from finito_tpu_torch.sbwt.construct import build_plain_matrix_sbwt

            sbwt2, node_keys = build_plain_matrix_sbwt(
                code_slices, sbwt.get_k(), return_keys=True
            )
            if not (
                sbwt2.number_of_subsets() == sbwt.number_of_subsets()
                and np.array_equal(sbwt2.words, sbwt.words)
            ):
                write_log(
                    "input .sbwt does not match the unitig set; "
                    "falling back to SBWT-search rank resolution",
                    LogLevel.MAJOR,
                )
                node_keys = None
        except Exception as e:  # pragma: no cover - defensive
            write_log(f"node-key reconstruction failed ({e}); using SBWT search",
                      LogLevel.MAJOR)
            node_keys = None
        builder = FinimizerIndexBuilder(sbwt, LCS, db, node_keys=node_keys, device=args.device)
        index = builder.get_index()
        index.serialize(out_prefix)
        write_log(
            finimizer_stats_string(builder.finimizer_stats, sbwt.number_of_kmers()),
            LogLevel.MAJOR,
        )
        # NOTE: like the reference, the rarest path leaves the appended
        # stats result string empty (run_fmin_streaming never sets it).
    elif args.type == "shortest":
        with SequenceReader(infile) as reader:
            stats = stats_modes.shortest_finimizer_stats_string(sbwt, LCS, reader, t)
        result = finimizer_stats_string(stats, sbwt.number_of_kmers())
        write_log(result, LogLevel.MAJOR)
    elif args.type == "verify":
        stats = set()
        with SequenceReader(infile) as reader:
            for _h, seq in reader:
                for piece in stats_modes.remove_ns(bytes(seq).upper(), sbwt.get_k()):
                    stats |= stats_modes.verify_shortest_streaming_search(
                        sbwt, encode_seq(piece), t
                    )
        result = finimizer_stats_string(stats, sbwt.number_of_kmers())
        write_log(result, LogLevel.MAJOR)

    with open(out_prefix + "_stats.txt", "a") as outfile:
        outfile.write(f"{t},{result}\n")
    print("String appended to the file successfully.")
    return 0


# -------------------------------------------------------------- search-fmin


def _run_queries_streaming(reader, out, index, stats_filename: str, engine=None) -> int:
    """Per-read fwd+RC query, merge, and (u,p) output
    (ref: search_fmin.hh:33-84). With a device engine, reads are
    processed in chunked batches (one device dispatch per chunk, both
    strands stacked) instead of one dispatch per read; the output lines,
    ordering and stats are identical."""
    from finito_tpu_torch.io.fastx import reverse_complement

    k = index.sbwt.get_k()
    total_micros = 0
    number_of_queries = 0
    kmers_count = 0
    kmers_count_rev = 0
    total_positive = 0
    CHUNK = 4096

    def emit(read: bytes, result, r_result):
        nonlocal total_positive, kmers_count, kmers_count_rev, number_of_queries
        tot_kmers = len(result.local_offsets)
        str_len = len(read)
        parts = []
        for i in range(tot_kmers):
            if result.local_offsets[i][0] == -1:
                unitig, pos = r_result.local_offsets[str_len - k - i]
            else:
                unitig, pos = result.local_offsets[i]
            if unitig != -1:
                total_positive += 1
            parts.append(f"({unitig},{pos})")
        out.write(" ".join(parts) + "\n")
        kmers_count += result.n_found
        kmers_count_rev += r_result.n_found
        number_of_queries += tot_kmers

    if engine is not None:
        from finito_tpu_torch import native
        from finito_tpu_torch.utils import trace

        fmt = "(%d,%d)".__mod__

        def emit_batch(handle, chunk: int):
            nonlocal total_positive, kmers_count, kmers_count_rev, number_of_queries
            line_lens, u, p, kf, kr = engine.merged_pairs_flat_end(handle)
            with trace.span("serve.format", chunk):
                total_positive += int(np.count_nonzero(u != -1))
                kmers_count += kf
                kmers_count_rev += kr
                number_of_queries += int(u.size)
                blob = native.format_pairs(u, p, line_lens)
                if blob is not None:
                    buf = getattr(out, "buffer", None)
                    if buf is not None:
                        out.flush()
                        buf.write(blob)
                    else:
                        out.write(blob.decode("ascii"))
                    return
                # Python fallback: per-line join over the flat streams
                pos = 0
                for n in line_lens.tolist():
                    out.write(
                        " ".join(map(fmt, zip(u[pos : pos + n].tolist(),
                                              p[pos : pos + n].tolist())))
                        + "\n"
                    )
                    pos += n

        # Double-buffered serving loop: dispatch chunk n+1 (async device
        # work) before reading back and formatting chunk n, so the device
        # computes under the host's formatting and output writes.
        # in_flight: (handle, chunk ordinal) of the chunk dispatched last.
        trace.reset()
        pending: List[bytes] = []
        in_flight = None
        n_chunks = 0
        reading = trace.span("serve.read", n_chunks).open()
        for _h, read in reader:
            pending.append(bytes(read))
            if len(pending) >= CHUNK:
                reading.close()
                t0 = cur_time_micros()
                handle = engine.merged_pairs_flat_begin(pending)
                if in_flight is not None:
                    emit_batch(*in_flight)
                in_flight = (handle, n_chunks)
                n_chunks += 1
                total_micros += cur_time_micros() - t0
                pending = []
                reading = trace.span("serve.read", n_chunks).open()
        reading.close()
        t0 = cur_time_micros()
        if pending:
            handle = engine.merged_pairs_flat_begin(pending)
            if in_flight is not None:
                emit_batch(*in_flight)
            in_flight = (handle, n_chunks)
        if in_flight is not None:
            emit_batch(*in_flight)
        total_micros += cur_time_micros() - t0
        write_log("trace: " + trace.summary(), LogLevel.MINOR)
    else:
        for _h, read in reader:
            t0 = cur_time_micros()
            read = bytes(read)
            result = index.search(read)
            r_result = index.search(reverse_complement(read))
            emit(read, result, r_result)
            total_micros += cur_time_micros() - t0

    write_log("k " + str(k), LogLevel.MAJOR)
    us = total_micros / number_of_queries if number_of_queries else float("nan")
    write_log(f"us/query: {us} (excluding I/O etc)", LogLevel.MAJOR)
    write_log(f"Found kmers: {kmers_count}", LogLevel.MAJOR)
    write_log(f"Found kmers reverse : {kmers_count_rev}", LogLevel.MAJOR)
    write_log(f"Total found kmers: {total_positive}", LogLevel.MAJOR)
    with open(stats_filename, "a") as statsfile:
        statsfile.write(f"{k},{kmers_count + kmers_count_rev},{number_of_queries}")
    return number_of_queries


def search_fmin(argv: List[str]) -> int:
    micros_start = cur_time_micros()
    set_log_level(LogLevel.MINOR)
    p = argparse.ArgumentParser(
        prog="finito_tpu_torch search-fmin",
        description="Query all Finimizers of all input reads (PyTorch engine).",
    )
    p.add_argument("-o", "--out-file", default=None, help="Output filename, or stdout if not given.")
    p.add_argument("-i", "--index-file", required=True, help="Index filename prefix.")
    p.add_argument(
        "-q", "--query-file", required=True,
        help="Query FASTA/FASTQ, possibly gzipped; .txt = list of query files.",
    )
    p.add_argument(
        "--engine", default="minimizer",
        choices=["oracle", "dense", "stream", "minimizer", "replica"],
        help="Query engine (default: minimizer; dense, stream and replica "
        "are the other device engines, all with identical output; "
        "'oracle' is the host reference algorithm).",
    )
    p.add_argument(
        "--mesh", default="1,1", metavar="DP,TP",
        help="Device mesh for scale-out (minimizer engine): batch shards "
        "over DP, the unitig text over TP; DP must be a power of two and "
        "DP*TP cards must be visible with --device cuda (--device cpu or "
        "one card such as cuda:0 holds every shard). "
        "Default 1,1 (single device).",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (default cuda; cpu runs "
                   "the plain PyTorch versions of the kernels).")
    args = p.parse_args(argv)
    try:
        mesh_dp, mesh_tp = (int(x) for x in args.mesh.split(","))
    except ValueError:
        raise RuntimeError(f"--mesh must be DP,TP integers, got {args.mesh!r}")
    if mesh_dp * mesh_tp > 1 and (mesh_dp & (mesh_dp - 1)):
        raise RuntimeError("--mesh DP must be a power of two (batches pad to powers of two)")

    from finito_tpu_torch.index.index import FinimizerIndex
    from finito_tpu_torch.io.fastx import SequenceReader

    query_files = _expand_file_list(args.query_file)
    for f in query_files:
        check_readable(f)

    output_files: Optional[List[str]] = None
    if args.out_file is not None:
        multi = len(args.query_file) >= 4 and args.query_file.endswith(".txt")
        output_files = readlines(args.out_file) if multi else [args.out_file]
        for f in output_files:
            check_writable(f)
        if len(query_files) != len(output_files):
            raise RuntimeError(
                f"Number of input and output files does not match "
                f"({len(query_files)} vs {len(output_files)})"
            )
    else:
        write_log("No output file given, writing to stdout", LogLevel.MAJOR)

    index_prefix = args.index_file
    sys.stderr.write("Loading index...\n")
    index = FinimizerIndex.load(index_prefix)
    sys.stderr.write("Index loaded\n")

    engine = None
    if args.engine != "oracle":
        from finito_tpu_torch.query.engine import DeviceQueryEngine

        mesh = (mesh_dp, mesh_tp) if mesh_dp * mesh_tp > 1 else None
        engine = DeviceQueryEngine(index, mode=args.engine, device=args.device, mesh=mesh)
    elif mesh_dp * mesh_tp > 1:
        raise RuntimeError("--mesh requires --engine minimizer")

    k = index.sbwt.get_k()
    sys.stderr.write(
        f"k = {k} SBWT nodes: {index.sbwt.number_of_subsets()} "
        f"kmers: {index.sbwt.number_of_kmers()}\n"
    )

    number_of_queries = 0
    stats_filename = index_prefix + ".stats"
    for i, qf in enumerate(query_files):
        write_log("Running streaming queries from input file " + qf, LogLevel.MAJOR)
        with SequenceReader(qf) as reader:
            if output_files is not None:
                with open(output_files[i], "w") as out:
                    number_of_queries += _run_queries_streaming(
                        reader, out, index, stats_filename, engine
                    )
            else:
                number_of_queries += _run_queries_streaming(
                    reader, sys.stdout, index, stats_filename, engine
                )

    new_total_micros = cur_time_micros() - micros_start
    us_e2e = new_total_micros / number_of_queries if number_of_queries else float("nan")
    write_log(f"us/query end-to-end: {us_e2e}", LogLevel.MAJOR)
    write_log(f"total number of queries: {number_of_queries}", LogLevel.MAJOR)

    # Reference quirk kept: second stats file named `<prefix>stats.txt`
    # (missing dot, search_fmin.hh:197) with leading-comma CSV rows.
    nbytes = index.size_in_bytes()
    write_log(f"bytes: {nbytes}", LogLevel.MAJOR)
    n_kmers = index.sbwt.number_of_kmers()
    bits_per_kmer = nbytes * 8 / n_kmers if n_kmers else 0
    with open(index_prefix + "stats.txt", "a") as statsfile2:
        statsfile2.write(f",{us_e2e}")
        statsfile2.write(f",{nbytes}")
        statsfile2.write(f",{bits_per_kmer}\n")
        statsfile2.write(f",{n_kmers}\n")

    total_micros = cur_time_micros() - micros_start
    us_final = total_micros / number_of_queries if number_of_queries else float("nan")
    write_log(f"us/query end-to-end: {us_final}", LogLevel.MAJOR)
    return 0


# ------------------------------------------------------------------- main


def kmer_mapper(argv: List[str]) -> int:
    from finito_tpu_torch import kmer_mapper as km

    return km.main(argv)


COMMANDS = {
    "build-fmin": build_fmin,
    "search-fmin": search_fmin,
    "sbwt-build": sbwt_build,
    "unitigs": unitigs_cmd,
    "flip-unitigs": flip_unitigs_cmd,
    "convert-sbwt": convert_sbwt,
    "kmer-mapper": kmer_mapper,
}


def print_help(prog: str) -> None:
    sys.stderr.write("Available commands:\n")
    for c in COMMANDS:
        sys.stderr.write(f"   {prog} {c}\n")


def main(argv: Optional[List[str]] = None) -> int:
    from finito_tpu_torch.utils import tune_host_allocator

    tune_host_allocator()
    argv = list(sys.argv[1:] if argv is None else argv)
    prog = "python -m finito_tpu_torch.cli"
    if not argv or argv[0] in ("-h", "--help"):
        print_help(prog)
        return 1
    command, rest = argv[0], argv[1:]
    fn = COMMANDS.get(command)
    if fn is None:
        sys.stderr.write(f"Invalid command: {command}\n")
        print_help(prog)
        return 1
    try:
        return fn(rest)
    except RuntimeError as e:
        sys.stderr.write(f"Runtime error: {e}\n")
        return 1


if __name__ == "__main__":
    sys.exit(main())
