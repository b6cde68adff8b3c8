"""Pangenome-scale pipeline verification (many related genomes -> one
sharded index): the port's twin of scripts/pangenome_verify.py.

  1. a base genome and N variants at SNP rate --snp: most k-mers shared,
     each variant adds bubbles;
  2. canonical unitigs of the distinct canonical k-mer set:
     dbg.build_unitigs, or parallel.shard_dbg.sharded_unitig_build over
     tp shards (--mesh-build), or dbg.build_simplitigs (--spss
     simplitigs);
  3. the host finimizer index over those strings;
  4. ShardedMinimizerIndex.build: the shard-local (1, tp) index, text
     and tables split over tp;
  5. the sharded locate for reads drawn from every variant (bubble-
     crossing) and across each seam, each read held to the host oracle
     FinimizerIndex.search.

  python -m finito_tpu_torch.tools.pangenome_verify --base 2000000 --variants 20 --k 63 \\
      --tp 8 --mesh-build --device cuda:0

--device as tools.genome_scale_verify's (the mesh build's shards too).
Prints one JSON line: the JAX script's fields, then the locate's
seconds, the host's peak resident set and the peak device memory.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from finito_tpu_torch.parallel.shard_build import shard_devices
from finito_tpu_torch.tools import (
    HOST_RSS_SOURCE,
    host_peak,
    log,
    peak_device_mib,
    reset_peak,
    sync,
)


def run(args) -> dict:
    from finito_tpu_torch.dbg import build_simplitigs, build_unitigs
    from finito_tpu_torch.index.builder import FinimizerIndexBuilder
    from finito_tpu_torch.io.seqdb import SeqDB, decode_seq
    from finito_tpu_torch.parallel.mesh import (
        ShardedMinimizerIndex,
        make_mesh,
        sharded_minimizer_locate_fn,
    )
    from finito_tpu_torch.parallel.shard_dbg import sharded_unitig_build
    from finito_tpu_torch.sbwt.construct import build_plain_matrix_sbwt
    from finito_tpu_torch.sbwt.lcs import lcs_array

    devs = shard_devices(args.device, args.tp)
    reset_peak(devs)
    k, L = args.k, args.read_len
    rng = np.random.default_rng(1000)

    # ---- 1. pangenome: base + SNP variants
    t0 = time.perf_counter()
    base = rng.integers(0, 4, size=args.base, dtype=np.uint8)
    genomes = [base]
    for _ in range(args.variants):
        v = base.copy()
        n_mut = int(args.snp * args.base)
        pos = rng.choice(args.base, size=n_mut, replace=False)
        v[pos] = (v[pos] + rng.integers(1, 4, size=n_mut)) % 4
        genomes.append(v)
    total_input = sum(g.size for g in genomes)
    log("pangenome", f"{len(genomes)} genomes, {total_input} input bases "
        f"in {time.perf_counter() - t0:.0f}s")

    # ---- 2. canonical unitigs (or simplitigs)
    t0 = time.perf_counter()
    if args.spss == "simplitigs":
        unitigs = build_simplitigs(genomes, k)
    elif args.mesh_build:
        unitigs = sharded_unitig_build(genomes, k, devices=devs)
    else:
        unitigs = build_unitigs(genomes, k, canonical=True)
    n_kmers = sum(u.size - k + 1 for u in unitigs)
    uni_s = time.perf_counter() - t0
    log("pangenome", f"{len(unitigs)} unitigs, {n_kmers} distinct canonical k-mers "
        f"({total_input / max(n_kmers, 1):.1f}x pangenome redundancy) in {uni_s:.0f}s")

    # ---- 3. host finimizer index
    t0 = time.perf_counter()
    useqs = [decode_seq(u) for u in unitigs]
    sbwt, node_keys = build_plain_matrix_sbwt(useqs, k, return_keys=True)
    index = FinimizerIndexBuilder(
        sbwt, lcs_array(sbwt), SeqDB.from_sequences(useqs), node_keys=node_keys
    ).get_index()
    build_s = time.perf_counter() - t0
    log("pangenome", f"finimizer index in {build_s:.0f}s: {sbwt.number_of_subsets()} nodes")

    # ---- 4. shard-local (tp) device index
    t0 = time.perf_counter()
    concat = np.asarray(index.unitigs.concat)
    ends = np.asarray(index.unitigs.ends, dtype=np.int64)
    sh = ShardedMinimizerIndex.build(concat, ends, k, tp=args.tp, slot_factor=args.slot_factor)
    shard_s = time.perf_counter() - t0
    per_shard_bytes = (sh.text_arr.nbytes + sh.occ_rows.nbytes + sh.desc.nbytes) // args.tp
    log("pangenome", f"shard-local build in {shard_s:.0f}s; "
        f"~{per_shard_bytes / 1e6:.1f} MB/shard device arrays")

    # ---- 5. sharded locate vs the host oracle: reads from every variant,
    # and seam straddlers
    starts = rng.integers(0, args.base - L, size=args.reads)
    gsel = rng.integers(0, len(genomes), size=args.reads)
    reads = np.stack([genomes[gi][s : s + L] for gi, s in zip(gsel, starts)])
    uid_base = np.asarray(sh.uid_base)
    for s in range(1, min(args.tp, len(ends))):
        b_uid = min(int(uid_base[s]), ends.size - 1)
        ustart = int(ends[b_uid - 1]) if b_uid > 0 else 0
        a = max(0, ustart - L // 2)
        if a + L <= concat.size:
            reads[s % args.reads] = concat[a : a + L]

    mesh = make_mesh(args.tp, tp=args.tp, devices=devs)
    W = L - k + 1
    t0 = time.perf_counter()
    locate = sharded_minimizer_locate_fn(mesh, sh, K_slow=args.reads * W)
    uid, off, n_slow = locate(reads)
    uid, off = uid.cpu().numpy(), off.cpu().numpy()
    sync(mesh.out_device)
    loc_s = time.perf_counter() - t0
    log("pangenome", f"sharded locate ({args.reads} reads x {W} windows) in {loc_s:.1f}s; "
        f"n_slow={int(n_slow)}")

    t0 = time.perf_counter()
    n_bad = 0
    for b in range(args.reads):
        exp = index.search(decode_seq(reads[b])).local_offsets
        got = list(zip(uid[b].tolist(), off[b].tolist()))
        if got != exp:
            n_bad += 1
            if n_bad <= 3:
                log("pangenome", f"MISMATCH read {b}")
    log("pangenome", f"host-oracle verification in {time.perf_counter() - t0:.0f}s")

    return {
        "metric": "pangenome_sharded_verify",
        "ok": n_bad == 0,
        "genomes": len(genomes),
        "input_bases": int(total_input),
        "distinct_canonical_kmers": int(n_kmers),
        "unitigs": len(unitigs),
        "k": k,
        "tp": args.tp,
        "verified_windows": int(uid.size),
        "found_windows": int(np.sum(uid >= 0)),
        "per_shard_mb": round(per_shard_bytes / 1e6, 1),
        "unitig_s": uni_s,
        "index_s": build_s,
        "shard_s": shard_s,
        "locate_s": loc_s,
        "n_slow": int(n_slow),
        "spss": args.spss,
        "mesh_build": bool(args.mesh_build),
        "device": args.device,
        "peak_device_mib": peak_device_mib(devs),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--base", type=int, default=2_000_000, help="base genome length")
    p.add_argument("--variants", type=int, default=20, help="number of variant genomes")
    p.add_argument("--k", type=int, default=63)
    p.add_argument("--tp", type=int, default=8)
    p.add_argument("--snp", type=float, default=0.002, help="per-base SNP rate per variant")
    p.add_argument("--reads", type=int, default=512)
    p.add_argument("--read-len", type=int, default=191)
    p.add_argument("--slot-factor", type=int, default=4)
    p.add_argument("--mesh-build", action="store_true",
                   help="build the unitigs on the mesh (parallel.shard_dbg) instead of the host")
    p.add_argument("--spss", choices=["unitigs", "simplitigs"], default="unitigs",
                   help="simplitigs: greedy maximal walks (fewer strings, a smaller index)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from finito_tpu_torch.utils import tune_host_allocator

    tune_host_allocator()
    t0 = time.perf_counter()
    with host_peak() as rss:
        out = run(args)
    out.update(wall_s=time.perf_counter() - t0, host_peak_rss_mib=rss["mib"],
               host_rss_source=HOST_RSS_SOURCE)
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
