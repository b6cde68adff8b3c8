"""Command-line interface of the port: ``search-fmin`` and ``kmer-mapper``
on a torch device.

    python -m finito_tpu_torch.cli search-fmin -i <prefix> -q reads.fna -o out.txt [--device cuda]
    python -m finito_tpu_torch.cli kmer-mapper query -i index -q reads.fna [-r] [--device cuda]

search-fmin takes the flags of finito_tpu.cli's search-fmin plus
``--device`` (default cuda). The serving loop and every output byte come
from the shared finito_tpu.cli._run_queries_streaming, which duck-types
the engine, so the output file and ``<prefix>.stats`` are those of the
JAX CLI by construction. kmer-mapper is finito_tpu_torch.kmer_mapper.
The host-only commands (sbwt-build, build-fmin, unitigs, ...) pass
through to finito_tpu.cli.COMMANDS.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from finito_tpu import cli as host_cli
from finito_tpu.utils.logging import LogLevel, cur_time_micros, set_log_level, write_log


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
        help="Query engine (default: minimizer, the device engine of the "
        "port; 'oracle' is the host reference algorithm; dense/stream/"
        "replica are not ported yet).",
    )
    p.add_argument("--mesh", default="1,1", metavar="DP,TP",
                   help="Device mesh; only 1,1 (one device) is ported.")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (default cuda; cpu runs "
                   "the plain PyTorch versions of the kernels).")
    args = p.parse_args(argv)
    if args.mesh.replace(" ", "") != "1,1":
        raise RuntimeError(f"--mesh {args.mesh} is not ported yet (only 1,1)")
    if args.engine not in ("oracle", "minimizer"):
        raise RuntimeError(f"--engine {args.engine} is not ported yet (minimizer or oracle)")

    from finito_tpu.index.index import FinimizerIndex
    from finito_tpu.io.fastx import SequenceReader

    query_files = host_cli._expand_file_list(args.query_file)
    for f in query_files:
        host_cli.check_readable(f)

    output_files: Optional[List[str]] = None
    if args.out_file is not None:
        multi = len(args.query_file) >= 4 and args.query_file.endswith(".txt")
        output_files = host_cli.readlines(args.out_file) if multi else [args.out_file]
        for f in output_files:
            host_cli.check_writable(f)
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
    if args.engine == "minimizer":
        from finito_tpu_torch.query.engine import DeviceQueryEngine

        engine = DeviceQueryEngine(index, mode="minimizer", device=args.device)

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
                    number_of_queries += host_cli._run_queries_streaming(
                        reader, out, index, stats_filename, engine
                    )
            else:
                number_of_queries += host_cli._run_queries_streaming(
                    reader, sys.stdout, index, stats_filename, engine
                )

    # the tail of finito_tpu.cli.search_fmin: end-to-end timing and the
    # reference's second stats file, `<prefix>stats.txt` (no dot)
    new_total_micros = cur_time_micros() - micros_start
    us_e2e = new_total_micros / number_of_queries if number_of_queries else float("nan")
    write_log(f"us/query end-to-end: {us_e2e}", LogLevel.MAJOR)
    write_log(f"total number of queries: {number_of_queries}", LogLevel.MAJOR)
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


def kmer_mapper(argv: List[str]) -> int:
    from finito_tpu_torch import kmer_mapper as km

    return km.main(argv)


COMMANDS = {
    **host_cli.COMMANDS,
    "search-fmin": search_fmin,
    "kmer-mapper": kmer_mapper,
}


def print_help(prog: str) -> None:
    sys.stderr.write("Available commands:\n")
    for c in COMMANDS:
        sys.stderr.write(f"   {prog} {c}\n")


def main(argv: Optional[List[str]] = None) -> int:
    from finito_tpu.utils import tune_host_allocator

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
