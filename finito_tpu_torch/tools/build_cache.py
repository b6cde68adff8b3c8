"""Build one cache entry end to end on the host: the index, the genome
and the derived minimizer index (midx_<tag>.ftmidx), the port's twin of
scripts/build_cache.py. h_sweep and lane_sweep read the entry.

  python -m finito_tpu_torch.tools.build_cache --genome 16000000
  python -m finito_tpu_torch.tools.build_cache --genome 4000000 --workload repeat
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from finito_tpu_torch.tools import log
from finito_tpu_torch.tools.cache import DEFAULT_CACHE, cache_tag, load_or_build_index


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--genome", type=int, required=True)
    p.add_argument("--k", type=int, default=31)
    p.add_argument("--workload", default="uniform", choices=["uniform", "repeat"])
    p.add_argument("--cache-dir", default=DEFAULT_CACHE)
    args = p.parse_args(argv)

    from finito_tpu_torch.utils import tune_host_allocator

    tune_host_allocator()
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    _, index, _, _ = load_or_build_index(args.genome, args.k, args.cache_dir, rng,
                                         workload=args.workload)
    log("cache", f"index ready in {time.perf_counter() - t0:.1f}s")
    tag = cache_tag(args.genome, args.k, args.workload)
    mcache = os.path.join(args.cache_dir, f"midx_{tag}.ftmidx")
    if not os.path.exists(mcache):
        from finito_tpu_torch.index.minimizer import MinimizerIndex

        t0 = time.perf_counter()
        mindex = MinimizerIndex.from_finimizer_index(index)
        mindex.serialize(mcache)
        log("cache", f"midx built+serialized in {time.perf_counter() - t0:.1f}s "
            f"(n_occ={mindex.occ_key.size}, h={mindex.h})")
    log("cache", "done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
