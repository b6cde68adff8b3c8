"""chip_smoke.py's analytic DSPSS oracle (analytic_expected) on the CPU:
at k = 31 and at k = 63, where a unitig's first k bases do not fit one
uint64, every window of every sampled read equals the host oracle
FinimizerIndex.search of the port's host-built index. chip_smoke is
imported as a module; its main runs only as a script."""

from __future__ import annotations

import numpy as np
import pytest

import chip_smoke
from finito_tpu_torch.index.builder import FinimizerIndexBuilder
from finito_tpu_torch.io.seqdb import SeqDB, decode_seq
from finito_tpu_torch.sbwt.construct import build_plain_matrix_sbwt
from finito_tpu_torch.sbwt.lcs import lcs_array
from finito_tpu_torch.utils import synth


@pytest.mark.parametrize("k", [31, 63])
def test_analytic_expected_equals_host_oracle(k):
    rng = np.random.default_rng(k)
    genome, unitigs, cuts = synth.gen_dspss(rng, 6000, k, mean_unitig=300, return_cuts=True)
    sb = build_plain_matrix_sbwt(unitigs, k)
    index = FinimizerIndexBuilder(sb, lcs_array(sb), SeqDB.from_sequences(unitigs),
                                  device="cpu").get_index()
    read_len, n_reads = 2 * k + 10, 40
    starts = rng.integers(0, genome.size - read_len, size=n_reads)
    reads = genome[starts[:, None] + np.arange(read_len)].copy()
    mi = rng.integers(0, n_reads, size=30)
    mj = rng.integers(0, read_len, size=30)
    reads[mi, mj] = (reads[mi, mj] + rng.integers(1, 4, size=30)) % 4
    want = chip_smoke.analytic_expected(index.unitigs.concat, index.unitigs.ends, genome, cuts,
                                        starts, (mi, mj), k=k, read_len=read_len)
    assert want.shape == (n_reads, read_len - k + 1, 2)
    assert (want[..., 0] == -1).any() and (want[..., 0] >= 0).any()
    for i in range(n_reads):
        got = index.search(decode_seq(reads[i])).local_offsets
        assert [tuple(p) for p in want[i].tolist()] == got


def test_repeat_cell_parameters_equal_bench():
    """chip_smoke.py's repeat cell takes the port's copy of bench.py's
    REPEAT_PARAMS (it imports nothing of bench); the copy must not
    drift."""
    from bench import REPEAT_PARAMS

    assert chip_smoke.REPEAT_LEN == 4_000_000
    assert synth.REPEAT_PARAMS == REPEAT_PARAMS


def test_sample_reads_follows_bench():
    """The CLI queries and the pipeline batch draw their reads and
    mutations as bench.py's run_rung does, from the same rng calls in
    the same order."""
    genome = np.random.default_rng(1).integers(0, 4, 5000).astype(np.uint8)
    B, L = 300, chip_smoke.READ_LEN
    starts, reads, (mi, mj) = chip_smoke.sample_reads(np.random.default_rng(2), genome, B)
    rng = np.random.default_rng(2)
    s = rng.integers(0, genome.size - L, size=B)
    want = genome[s[:, None] + np.arange(L)[None, :]].copy()
    n_mut = int(chip_smoke.MUTATE * want.size)
    a, b = rng.integers(0, B, size=n_mut), rng.integers(0, L, size=n_mut)
    want[a, b] = (want[a, b] + rng.integers(1, 4, size=n_mut)) % 4
    assert np.array_equal(starts, s) and np.array_equal(reads, want)
    assert np.array_equal(mi, a) and np.array_equal(mj, b)


def test_bench_phase_arguments_parse():
    """Phase 6's tools.bench arguments parse as the tool's own flags, ask
    for the card, no watchdog and no profile, and check_ladder takes the
    rows they give: the head, the cached rung and each extra row."""
    from finito_tpu_torch.tools import bench as pbench

    argv = chip_smoke.bench_args("/cache")
    seen = {}
    real = pbench.argparse.ArgumentParser.parse_args

    def spy(self, args=None, namespace=None):
        seen["args"] = real(self, args, namespace)
        raise SystemExit(0)

    pbench.argparse.ArgumentParser.parse_args = spy
    try:
        with pytest.raises(SystemExit):
            pbench.main(argv)
    finally:
        pbench.argparse.ArgumentParser.parse_args = real
    a = seen["args"]
    assert a.device == "cuda:0" and a.ladder == "auto" and a.cache_dir == "/cache"
    assert a.stall_timeout == 0 and a.profile is None and a.genome == 400_000
    assert set(a.extra_rows.split(",")) == {"stream", "replica", "repeat"}
    assert a.repeat_genome == 1_000_000 and a.batch == chip_smoke.PIPE_BATCH

    def row(g, wl, eng="minimizer"):
        return {"genome": g, "k": 31, "workload": wl, "engine": eng,
                "analytic_verified_windows": chip_smoke.PIPE_BATCH * 98}

    rows = [row(400_000, "uniform"), row(4_641_652, "uniform"), row(400_000, "uniform", "replica"),
            row(400_000, "uniform", "stream"), row(1_000_000, "repeat")]
    chip_smoke.check_ladder({"ladder": rows}, [400_000, 4_641_652])
    for bad in ({"ladder": rows[:-1]}, {"ladder": rows, "error": "stalled"},
                {"ladder": rows[:-1] + [{**rows[-1], "analytic_verified_windows": 0}]}):
        with pytest.raises(AssertionError):
            chip_smoke.check_ladder(bad, [400_000, 4_641_652])
