"""Genome-scale shard-local build and sharded locate, verified against a
closed-form oracle (whole-genome scale, k=63): the port's twin of
scripts/genome_scale_verify.py.

Builds a ShardedMinimizerIndex directly from a synthetic DSPSS, shard by
shard (no single-host index, so no 2^31-base cap), runs the (1, tp)
sharded minimizer locate, and checks every window of every read against
the analytic oracle: in a DSPSS each k-mer occurs once, in the unitig
whose genome cut range holds its start, so the expected (uid, offset)
of a read sampled at genome position p is known in closed form (a
mutated window is absent: a random 63-mer meets a 10^9-base set with
probability ~1e-29). Reads are placed uniformly and 2 on each seam
between tp shards.

  python -m finito_tpu_torch.tools.genome_scale_verify --genome 1000000000 --k 63 --tp 8 \\
      --device cuda:0

--device cuda:0 puts every shard on that card, --device cuda one shard
on each card (tp cards needed), --device cpu runs the shards on the
host. Prints one JSON line: the JAX script's fields, then the locate's
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


def gen_dspss_cuts(rng, genome_len: int, k: int, mean_unitig: int = 2000):
    """utils.synth.gen_dspss without the unitig byte strings (decoding
    10^9 bases would double the peak): (genome, cuts), unitig i =
    genome[cuts[i] : cuts[i+1] + k - 1]."""
    from finito_tpu_torch.sbwt import keys as kw
    from finito_tpu_torch.utils.synth import draw_cuts

    t0 = time.perf_counter()
    while True:
        genome = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
        if k >= 32:
            # birthday bound: P(dup) <= n^2 / (2 * 4^k), ~6e-20 at k=63,
            # n=1e9; the O(n log n) sort would only measure the host
            log("genome-scale", f"genome drawn in {time.perf_counter() - t0:.0f}s; "
                "distinctness check skipped (P(dup) < n^2/4^k ~ 1e-19)")
            break
        log("genome-scale",
            f"genome drawn in {time.perf_counter() - t0:.0f}s; checking distinctness")
        wk = kw.sort_keys(kw.pack_windows(genome, k))
        dup = bool(np.any(kw.eq_adjacent(wk)))
        del wk
        if not dup:
            break
        log("genome-scale", "duplicate k-mer (astronomically unlikely); redrawing")
    cuts = draw_cuts(rng, genome_len, k, mean_unitig)
    log("genome-scale", f"DSPSS ready in {time.perf_counter() - t0:.0f}s: {cuts.size - 1} unitigs")
    return genome, cuts


def run(args) -> dict:
    from finito_tpu_torch.parallel.mesh import (
        ShardedMinimizerIndex,
        make_mesh,
        sharded_minimizer_locate_fn,
    )

    devs = shard_devices(args.device, args.tp)
    k, L = args.k, args.read_len
    rng = np.random.default_rng(63)
    genome, cuts = gen_dspss_cuts(rng, args.genome, k)

    # unitig concat layout: unitig i = genome[cuts[i] : cuts[i+1]+k-1]
    lens = np.diff(cuts) + (k - 1)
    ends = np.cumsum(lens)
    total_text = int(ends[-1])
    log("genome-scale", f"unitig text {total_text} bases ({total_text / (1 << 31):.2f}x "
        "the int32 cap of one device)")
    concat = np.empty(total_text, np.uint8)
    w = 0
    for i in range(cuts.size - 1):
        seg = genome[cuts[i] : cuts[i + 1] + k - 1]
        concat[w : w + seg.size] = seg
        w += seg.size

    t0 = time.perf_counter()
    sh = ShardedMinimizerIndex.build(concat, ends, k, tp=args.tp, slot_factor=args.slot_factor)
    build_s = time.perf_counter() - t0
    del concat
    per_shard_bytes = (sh.text_arr.nbytes + sh.occ_rows.nbytes + sh.desc.nbytes) // args.tp
    log("genome-scale", f"shard-local build in {build_s:.0f}s: {int(np.asarray(sh.n_occ).sum())} "
        f"occurrences, h={sh.h}, ~{per_shard_bytes / 1e9:.2f} GB/shard device arrays")

    # reads: uniform + 2 per tp seam (straddling the shard boundary)
    starts = list(rng.integers(0, args.genome - L, size=args.reads - 2 * (args.tp - 1)))
    for s in range(1, args.tp):
        b0 = int(cuts[min(int(sh.uid_base[s]), cuts.size - 2)])
        starts.append(int(np.clip(b0 - L // 2, 0, args.genome - L)))
        starts.append(int(np.clip(b0 - k, 0, args.genome - L)))
    starts = np.asarray(starts, np.int64)
    reads = genome[starts[:, None] + np.arange(L)[None, :]].copy()
    n_mut = int(args.mutate * starts.size)
    mb = rng.choice(starts.size, size=n_mut, replace=False)
    mj = rng.integers(0, L, size=n_mut)
    reads[mb, mj] = (reads[mb, mj] + rng.integers(1, 4, size=n_mut)) % 4
    del genome

    # analytic oracle: the k-mer at genome position g lives in unitig
    # i = searchsorted(cuts, g, 'right') - 1 at offset g - cuts[i]; a
    # window covering a mutated base is absent
    W = L - k + 1
    g = starts[:, None] + np.arange(W)[None, :]
    uid_exp = np.searchsorted(cuts, g.reshape(-1), side="right").reshape(g.shape) - 1
    uid_exp = np.minimum(uid_exp, cuts.size - 2).astype(np.int64)
    off_exp = g - cuts[uid_exp]
    absent = np.zeros(g.shape, bool)
    absent[mb] = (mj[:, None] - np.arange(W)[None, :] >= 0) & (
        mj[:, None] - np.arange(W)[None, :] < k)
    uid_exp = np.where(absent, -1, uid_exp)
    off_exp = np.where(absent, -1, off_exp)

    mesh = make_mesh(args.tp, tp=args.tp, devices=devs)
    reset_peak(devs)
    t0 = time.perf_counter()
    locate = sharded_minimizer_locate_fn(mesh, sh, K_slow=starts.size * W)
    place_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    uid, off, n_slow = locate(reads)
    uid, off = uid.cpu().numpy(), off.cpu().numpy()
    sync(mesh.out_device)
    locate_s = time.perf_counter() - t0
    log("genome-scale", f"tables placed in {place_s:.1f}s; sharded locate ({starts.size} reads x "
        f"{W} windows) in {locate_s:.1f}s; n_slow={int(n_slow)}")

    ok = np.array_equal(uid, uid_exp) and np.array_equal(off, off_exp)
    if not ok:
        bad = np.argwhere((uid != uid_exp) | (off != off_exp))
        log("genome-scale", f"MISMATCH at {bad.shape[0]} windows; first: {bad[:5].tolist()}")
    found = int(np.sum(uid >= 0))
    shard_of = np.searchsorted(np.asarray(sh.uid_base), uid[uid >= 0], side="right")
    return {
        "metric": "genome_scale_sharded_verify",
        "ok": bool(ok),
        "genome": args.genome,
        "text_bases": total_text,
        "k": k,
        "tp": args.tp,
        "verified_windows": int(uid.size),
        "found_windows": found,
        "shards_answering": int(np.unique(shard_of).size),
        "per_shard_gb": round(per_shard_bytes / 1e9, 3),
        "build_s": build_s,
        "place_s": place_s,
        "locate_s": locate_s,
        "n_slow": int(n_slow),
        "h": int(sh.h),
        "device": args.device,
        "peak_device_mib": peak_device_mib(devs),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--genome", type=int, default=1_000_000_000)
    p.add_argument("--k", type=int, default=63)
    p.add_argument("--tp", type=int, default=8)
    p.add_argument("--slot-factor", type=int, default=4,
                   help="per-shard table load factor (4 keeps 8 shards of a "
                   "1 Gbp k=63 index ~2 GB of descriptors in all)")
    p.add_argument("--reads", type=int, default=1024)
    p.add_argument("--read-len", type=int, default=191)
    p.add_argument("--mutate", type=float, default=0.3,
                   help="fraction of reads receiving one point mutation")
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
