"""The benchmark's data step under the repository's own tests: the cut
configurations' arrays against the formula the data step replaced, the
frozen repeat generator against the program's, the canonical de Bruijn
unitigs a repeat configuration is built from, and a repeat cell made only
of data files, all from benchmark/tests/test_bench_unitigs.py. The
identity check runs over the configurations that cut a uniform genome:
a repeat genome (a file with a "genome" key) had no cuts to compare with."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "benchmark", "tests"))
from test_bench_unitigs import (  # noqa: E402,F401
    SEEDS,
    check_identity,
    configs,
    test_dbg_unitigs_are_a_maximal_canonical_dspss,
    test_genome_seed_fixes_the_genome_for_every_run,
    test_repeat_cell_from_data_files_runs_correct,
    test_repeat_generator_matches_the_programs,
)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cfg", [c for c in configs() if "genome" not in c],
                         ids=lambda c: c["name"])
def test_cut_configurations_give_the_same_arrays(cfg, seed):
    check_identity(cfg, seed, 200_000, 300_000, pool=500)
