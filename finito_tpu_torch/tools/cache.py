"""The benchmark index cache: the port's twin of bench.py's
load_or_build_index, on the port's sbwt, index, dbg and io.

A cache entry is a serialized FinimizerIndex and its genome per
(genome_len, k, workload), under build/finito_tpu_torch/bench_cache/ by
default (gitignored). The file names are bench.py's, so an entry is
readable by both packages, but this directory is never the JAX
package's .bench_cache/.
"""

from __future__ import annotations

import os
import time

import numpy as np

from finito_tpu_torch.tools import log
from finito_tpu_torch.utils.synth import REPEAT_PARAMS, draw_cuts, gen_dspss

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CACHE = os.path.join(ROOT, "build", "finito_tpu_torch", "bench_cache")


def cache_tag(genome_len: int, k: int, workload: str = "uniform") -> str:
    """The entry's tag in file names: g<len>_k<k>, or repg<len>_k<k>."""
    if workload not in ("uniform", "repeat"):
        raise ValueError(f"unknown workload {workload!r} (uniform or repeat)")
    return f"{'g' if workload == 'uniform' else 'repg'}{genome_len}_k{k}"


def load_or_build_index(genome_len: int, k: int, cache_dir: str | None, rng,
                        workload: str = "uniform"):
    """(genome, FinimizerIndex, build_seconds, cuts), the entry cached
    under cache_dir (None: no cache).

    workload "uniform" is the DSPSS (utils.synth.gen_dspss: a random
    genome cut into k-1-overlapping unitigs; cuts give the analytic
    oracle); "repeat" draws utils.synth.gen_repeat_genome with
    REPEAT_PARAMS and decomposes it with dbg.build_unitigs
    (non-canonical): repeated k-mers collapse, so cuts is None. On a
    load the uniform cuts are regenerated by replaying rng: equality of
    the replayed genome proves the replay tracked the build's rng
    stream, else cuts is None."""
    from finito_tpu_torch.index.builder import FinimizerIndexBuilder
    from finito_tpu_torch.index.index import FinimizerIndex
    from finito_tpu_torch.io.seqdb import SeqDB, decode_seq
    from finito_tpu_torch.sbwt.construct import build_plain_matrix_sbwt
    from finito_tpu_torch.sbwt.lcs import lcs_array

    tag = cache_tag(genome_len, k, workload)
    cache_prefix = genome_cache = None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        cache_prefix = os.path.join(cache_dir, f"idx_{tag}")
        genome_cache = os.path.join(cache_dir, f"genome_{tag}.npy")

    if cache_prefix and os.path.exists(cache_prefix + ".sbwt") and os.path.exists(genome_cache):
        genome = np.load(genome_cache)
        t0 = time.perf_counter()
        index = FinimizerIndex.load(cache_prefix)
        build_s = time.perf_counter() - t0
        cuts = None
        if workload == "uniform":
            replay = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
            cuts = draw_cuts(rng, genome_len, k) if np.array_equal(replay, genome) else None
            del replay
        log("cache", f"index loaded from cache in {build_s:.1f}s"
            + ("" if cuts is not None or workload != "uniform"
               else "; rng replay mismatch -> no analytic oracle"))
    else:
        if workload == "uniform":
            genome, unitigs, cuts = gen_dspss(rng, genome_len, k, return_cuts=True)
        else:
            from finito_tpu_torch.dbg import build_unitigs
            from finito_tpu_torch.utils.synth import gen_repeat_genome

            genome = gen_repeat_genome(rng, genome_len, **REPEAT_PARAMS)
            cuts = None
            unitigs = [decode_seq(u) for u in build_unitigs([genome], k, canonical=False)]
        t0 = time.perf_counter()
        sbwt, node_keys = build_plain_matrix_sbwt(unitigs, k, return_keys=True)
        index = FinimizerIndexBuilder(
            sbwt, lcs_array(sbwt), SeqDB.from_sequences(unitigs), node_keys=node_keys
        ).get_index()
        build_s = time.perf_counter() - t0
        if cache_prefix:
            index.serialize(cache_prefix)
            np.save(genome_cache, genome)
    sbwt = index.sbwt
    log("cache", f"index ready in {build_s:.1f}s: {sbwt.number_of_subsets()} nodes, "
        f"{sbwt.number_of_kmers()} kmers, {int(np.asarray(index.unitigs.ends).size)} unitigs")
    return genome, index, build_s, cuts
