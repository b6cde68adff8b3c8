"""The benchmark's data step and its reference over a unitig set: the cut
configurations give the arrays they gave before the data step took a
unitig set, the frozen repeat generator draws what the program's draws,
the canonical de Bruijn decomposition is a maximal DSPSS equal to the
program's own, and a repeat cell made only of data files runs end to end
on the CPU."""

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from bench_tiny import BENCH_DIR, ROOT, make_bench  # noqa: E402

if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import datagen, harness  # noqa: E402
from benchmark.reference import Reference, _pack  # noqa: E402

SEEDS = (2**31 + 4141, 2**31 + 4242)
REPEAT = {"tandem_frac": 0.2, "seg_frac": 0.35, "snp_rate": 0.004, "div_rate": 0.04}


class CutsReference(Reference):
    """The reference as it was built from (genome, cuts) before it took a
    unitig set: every genome window keyed, its unitig found among the
    cuts (the oracle of the identity check)."""

    def __init__(self, genome, cuts, k, device):
        self.k, self.device = k, torch.device(device)
        g = torch.from_numpy(np.ascontiguousarray(genome)).to(self.device)
        keys = _pack(g, k, False)
        pos = torch.arange(keys.numel(), dtype=torch.int64, device=self.device)
        cuts_d = torch.from_numpy(np.asarray(cuts, np.int64)).to(self.device)
        unitig = torch.searchsorted(cuts_d, pos, right=True) - 1
        first = genome[cuts[:-1, None] + np.arange(k)[None, :]].astype(np.uint64)
        key = np.zeros(first.shape[0], np.uint64)
        for j in range(k - 1, -1, -1):
            key = (key << np.uint64(2)) | first[:, j]
        ids = np.empty(key.size, np.int64)
        ids[np.argsort(key, kind="stable")] = np.arange(key.size)
        ids = torch.from_numpy(ids).to(self.device)
        self.keys, order = torch.sort(keys)
        self.uid = ids[unitig][order].to(torch.int32)
        self.off = (pos - cuts_d[unitig])[order].to(torch.int32)


def configs():
    out = []
    for path in sorted(glob.glob(os.path.join(BENCH_DIR, "configs", "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def traffic(name):
    with open(os.path.join(BENCH_DIR, "traffic", name + ".json")) as f:
        return json.load(f)


def check_identity(cfg: dict, seed: int, genome_len: int, n_bases: int, pool=None,
                   device="cpu"):
    """The data step of a cut configuration against the formula it replaced:
    the unitigs' bytes, each traffic mix's pool (of `pool` reads where
    given), the reference's arrays, and its answers over the pools' first
    reads, n_bases bases of them."""
    cfg = dict(cfg, genome_len=genome_len)
    k = int(cfg["k"])
    genome, (codes, ends) = datagen.genome_and_unitigs(seed, cfg)
    genome0, cuts = datagen.gen_dspss(np.random.default_rng([seed, 0]), genome_len, k,
                                      int(cfg["mean_unitig"]))
    assert np.array_equal(genome, genome0)
    assert datagen.unitig_bytes(codes, ends) == [
        datagen.DECODE[genome0[a : b + k - 1]].tobytes() for a, b in zip(cuts[:-1], cuts[1:])]
    ref = Reference.of_unitigs(codes, ends, k, device)
    old = CutsReference(genome0, cuts, k, device)
    for name in ("keys", "uid", "off"):
        assert torch.equal(getattr(ref, name), getattr(old, name)), name
    for mix in ("reads150", "hifi"):
        spec = dict(traffic(mix), **({"pool": pool} if pool else {}))
        reads = datagen.gen_reads(np.random.default_rng([seed, 1]), genome, spec)
        reads0 = datagen.gen_reads(np.random.default_rng([seed, 1]), genome0, spec)
        assert all(np.array_equal(a, b) for a, b in zip(reads, reads0)), mix
        rcodes, rends = reads
        n = max(1, int(np.searchsorted(rends, n_bases, "right")))
        sub = (rcodes[: rends[n - 1]], rends[:n])
        for a, b in zip(ref.answer(*sub), old.answer(*sub)):
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else np.array_equal(a, b)), mix


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cfg", configs(), ids=lambda c: c["name"])
def test_cut_configurations_give_the_same_arrays(cfg, seed):
    assert "genome" not in cfg
    check_identity(cfg, seed, 200_000, 300_000, pool=500)


@pytest.mark.parametrize("seed,length", [(0, 60_000), (7, 120_000), (2**31 + 99, 250_000)])
def test_repeat_generator_matches_the_programs(seed, length):
    from finito_tpu_torch.utils.synth import gen_repeat_genome

    for kw in ({}, REPEAT):
        a = datagen.gen_repeat_genome(np.random.default_rng(seed), length, **kw)
        b = gen_repeat_genome(np.random.default_rng(seed), length, **kw)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _split(codes, ends):
    return [codes[a:b] for a, b in zip([0] + ends[:-1].tolist(), ends.tolist())]


def _rc(s):
    return (3 - s[::-1]).astype(np.uint8)


def _canon(s):
    return min(s.tobytes(), _rc(s).tobytes())


def _windows(s, k):
    """Every k-window of a code array as an integer, first base most significant."""
    w = np.lib.stride_tricks.sliding_window_view(s.astype(np.uint64), k)
    return w @ (np.uint64(4) ** np.arange(k - 1, -1, -1, dtype=np.uint64))


def _rc_int(x, k):
    r = np.zeros_like(x)
    for j in range(k):
        r = (r << np.uint64(2)) | (np.uint64(3) - ((x >> np.uint64(2 * j)) & np.uint64(3)))
    return r


def _maximal_dspss(genome, unitigs, k):
    """Every canonical k-mer of the genome once; inside a unitig each k-mer
    runs into its one successor, which has one predecessor and another
    node; no unitig end runs on into a k-mer that way, except a cycle into
    its own start. Returns the number of such cycles."""
    def canon(x):
        return np.minimum(x, _rc_int(x, k))

    want = np.unique(canon(_windows(genome, k)))
    seen = np.concatenate([canon(_windows(u, k)) for u in unitigs])
    assert np.unique(seen).size == seen.size and np.array_equal(np.sort(seen), want)
    mask, top = np.uint64(4**k - 1), np.uint64(2 * (k - 1))

    def has(y):
        c = canon(y)
        return want[np.minimum(np.searchsorted(want, c), want.size - 1)] == c

    def degree(cands):
        found = [has(y) for y in cands]
        return sum(f.astype(int) for f in found), np.select(found, cands, 0)

    def runs_on(x):
        """Where x runs on to (its one successor, whose one predecessor is x,
        on another node), else -1."""
        out, y = degree([((x << np.uint64(2)) | np.uint64(c)) & mask for c in range(4)])
        into, _ = degree([(np.uint64(c) << top) | (y >> np.uint64(2)) for c in range(4)])
        ok = (out == 1) & (into == 1) & (canon(y) != canon(x))
        return np.where(ok, y.astype(np.int64), -1)

    x = [_windows(u, k) for u in unitigs]
    inner = np.concatenate([w[:-1] for w in x])
    assert np.array_equal(runs_on(inner), np.concatenate([w[1:] for w in x]).astype(np.int64))
    firsts, lasts = np.array([w[0] for w in x]), np.array([w[-1] for w in x])
    cycles = 0
    # each strand's last k-mer runs on nowhere, or into the same strand's first
    for last, first in ((lasts, firsts), (_rc_int(firsts, k), _rc_int(lasts, k))):
        y = runs_on(last)
        assert np.all((y == -1) | (y == first.astype(np.int64))), "two unitigs could be joined"
        cycles += int((y != -1).sum())
    return cycles


def _genomes(k):
    """Repeat genomes at the cell's parameters, a tandem repeat that closes
    into one cycle, and a low-entropy genome dense in branches."""
    out = [datagen.gen_repeat_genome(np.random.default_rng(s), n, **REPEAT)
           for s, n in ((1, 60_000), (3, 30_000), (2**31 + 5, 70_000))]
    rng = np.random.default_rng(k)
    out.append(np.tile(rng.integers(0, 4, 2 * k + 3, dtype=np.uint8), 4))
    out.append(rng.integers(0, 2, 3_000, dtype=np.uint8))
    return out


@pytest.mark.parametrize("k", [11, 31])
def test_dbg_unitigs_are_a_maximal_canonical_dspss(k):
    from finito_tpu_torch.dbg import build_unitigs

    cycles = 0
    for genome in _genomes(k):
        unitigs = _split(*datagen.dbg_unitigs(genome, k))
        cycles += _maximal_dspss(genome, unitigs, k)
        theirs = build_unitigs([genome], k, canonical=True)
        # equal up to orientation; a cycle may be broken at another k-mer
        mine = sorted(_canon(u) for u in unitigs)
        if mine != sorted(_canon(u) for u in theirs):
            def kset(us):
                return sorted(sorted(_canon(u[i : i + k]) for i in range(u.size - k + 1))
                              for u in us)
            assert kset(unitigs) == kset(theirs)
        # the order and orientation follow from the genome alone
        again = datagen.dbg_unitigs(genome.copy(), k)
        assert all(np.array_equal(a, b) for a, b in zip(again, datagen.dbg_unitigs(genome, k)))
    assert cycles >= 1  # the tandem repeat closes into a cycle


def test_repeat_cell_from_data_files_runs_correct(tmp_path):
    """The tiny repeat cell (canonical dbg unitigs of a repeat genome) through
    run_cell: the program is correct; the control and a chunk that drops
    half its reads are not; a genome of another kind is refused."""
    path = make_bench(str(tmp_path))
    bdir = os.path.join(str(tmp_path), "benchmark")

    def run(**kw):
        return harness.run_cell("tiny_repeat.reads", SEEDS[0], 0.2, False, device="cpu",
                                bench_json=path, bench_dir=bdir, **kw)

    spec = harness.load_cell("tiny_repeat.reads", path, bdir)
    genome, (codes, ends) = datagen.genome_and_unitigs(SEEDS[0], spec.config)
    assert ends.size > 100  # repeats branch the graph into many unitigs
    result, checks = run()
    assert result["correct"] and result["failed"] == 0, checks
    for variant, fails in (({"rc": False}, "found_diff"), ({"keep": 0.5}, "lines_missing")):
        result, checks = run(reference_engine=variant)
        assert not result["correct"] and checks[fails] > 0, (variant, checks)
    with pytest.raises(ValueError, match="tandem"):
        datagen.genome_and_unitigs(SEEDS[0], dict(spec.config, genome="tandem"))


def test_genome_seed_fixes_the_genome_for_every_run():
    """A file's "genome_seed" gives every run seed the same genome and
    unitigs; without it the run's seed draws them."""
    cfg = {"name": "r", "genome_len": 60_000, "k": 31, "genome": "repeat", "repeat": REPEAT}
    fixed = [datagen.genome_and_unitigs(s, dict(cfg, genome_seed=SEEDS[0])) for s in SEEDS]
    assert all(np.array_equal(a, b) for a, b in zip(fixed[0][1], fixed[1][1]))
    own = datagen.genome_and_unitigs(SEEDS[0], cfg)
    assert np.array_equal(own[0], fixed[1][0])
    assert not np.array_equal(datagen.genome_and_unitigs(SEEDS[1], cfg)[0], own[0])
