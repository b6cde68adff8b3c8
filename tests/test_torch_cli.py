"""The port's CLI (finito_tpu_torch/cli.py, --device cpu) against the JAX
CLI's search-fmin --engine minimizer: byte-identical output and
<prefix>.stats, and <prefix>stats.txt equal in every field but the
timing. Also: the port, kmer-mapper included, runs with jax imports
blocked."""

from __future__ import annotations

import gzip
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from finito_tpu import cli as jax_cli
from finito_tpu_torch import cli as port_cli

# plain module names: pytest puts tests/ on sys.path, and a `tests` package
# installed elsewhere cannot shadow them
from test_cli import PAPER_UNITIGS, write_fasta
from test_device_engine import gen_dspss

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _build(tmp_path, unitigs, k):
    fna = tmp_path / "u.fna"
    write_fasta(fna, unitigs)
    sbwt = str(tmp_path / "x.sbwt")
    prefix = str(tmp_path / "idx")
    assert port_cli.main(["sbwt-build", "-i", str(fna), "-o", sbwt, "-k", str(k)]) == 0
    assert port_cli.main(["build-fmin", "-o", prefix, "-i", sbwt, "-u", str(fna)]) == 0
    return prefix


def _search(main, prefix, query, out, extra=()):
    """Run search-fmin and return (output bytes, .stats, stats.txt), with
    the appended stats files removed so the next run starts clean."""
    assert main(["search-fmin", "-o", str(out), "-i", prefix, "-q", str(query), *extra]) == 0
    files = [str(out), prefix + ".stats", prefix + "stats.txt"]
    got = [open(f, "rb").read() for f in files]
    for f in files[1:]:
        os.remove(f)
    return got


def _assert_same_run(prefix, query, tmp_path):
    j_out, j_stats, j_txt = _search(jax_cli.main, prefix, query, tmp_path / "j.txt",
                                    ["--engine", "minimizer"])
    p_out, p_stats, p_txt = _search(port_cli.main, prefix, query, tmp_path / "p.txt",
                                    ["--device", "cpu"])
    assert p_out == j_out
    assert p_stats == j_stats
    # ",<us e2e>,<bytes>,<bits/kmer>\n,<kmers>\n": all but the timing equal
    j_f = j_txt.decode().split(",")
    p_f = p_txt.decode().split(",")
    assert len(p_f) == len(j_f) == 5 and p_f[0] == j_f[0] == ""
    float(p_f[1])
    assert p_f[2:] == j_f[2:]
    return p_out


def test_paper_fixture(tmp_path):
    prefix = _build(tmp_path, PAPER_UNITIGS, 4)
    q = tmp_path / "q.fna"
    write_fasta(q, ["AAGTAA"])
    assert _assert_same_run(prefix, q, tmp_path) == b"(0,2) (-1,-1) (0,0)\n"


def test_rc_merge_fixture(tmp_path):
    prefix = _build(tmp_path, ["CGGT", "GGTT", "TACCCGTA"], 4)
    q = tmp_path / "q.fna"
    write_fasta(q, ["AACCGTACC"])
    assert _assert_same_run(prefix, q, tmp_path) == b"(2,0) (1,0) (0,3) (0,4) (-1,-1) (0,0)\n"


def test_gzip_and_txt_fanout(tmp_path):
    """Gzipped unitigs and `.txt` file-of-files fan-out, as in test_cli."""
    fna = tmp_path / "u.fna.gz"
    with gzip.open(fna, "wt") as f:
        for s in PAPER_UNITIGS:
            f.write(f">\n{s}\n")
    sbwt, prefix = str(tmp_path / "x.sbwt"), str(tmp_path / "idx")
    assert port_cli.main(["sbwt-build", "-i", str(fna), "-o", sbwt, "-k", "4"]) == 0
    assert port_cli.main(["build-fmin", "-o", prefix, "-i", sbwt, "-u", str(fna)]) == 0
    q1, q2 = tmp_path / "q1.fna", tmp_path / "q2.fna"
    write_fasta(q1, ["AAGTAA"])
    write_fasta(q2, ["GTAAGTCT"])
    qlist = tmp_path / "queries.txt"
    qlist.write_text(f"{q1}\n{q2}\n")
    outs = {}
    for name, main, extra in (("j", jax_cli.main, ["--engine", "minimizer"]),
                              ("p", port_cli.main, ["--device", "cpu"])):
        o1, o2 = tmp_path / f"{name}1.txt", tmp_path / f"{name}2.txt"
        olist = tmp_path / f"{name}outs.txt"
        olist.write_text(f"{o1}\n{o2}\n")
        assert main(["search-fmin", "-o", str(olist), "-i", prefix, "-q", str(qlist), *extra]) == 0
        outs[name] = (o1.read_bytes(), o2.read_bytes(), open(prefix + ".stats", "rb").read())
        os.remove(prefix + ".stats")
    assert outs["p"] == outs["j"]
    assert outs["p"][:2] == (b"(0,2) (-1,-1) (0,0)\n", b"(0,0) (0,1) (0,2) (0,3) (0,4)\n")


def test_random_dspss_k31(tmp_path):
    rng = np.random.default_rng(31)
    k = 31
    unitigs = gen_dspss(rng, 12, 60, 300, k)
    prefix = _build(tmp_path, unitigs, k)
    genome = "".join(unitigs)
    reads = []
    for i in range(40):
        s = int(rng.integers(0, len(genome) - 100))
        r = list(genome[s : s + int(rng.integers(k, 100))])
        if i % 3 == 0:
            r[len(r) // 2] = "ACGT"[("ACGT".index(r[len(r) // 2]) + 1) % 4]
        reads.append("".join(r))
    reads += ["ACGT", "ACGTN" * 10, unitigs[0], genome[:200]]
    q = tmp_path / "q.fna"
    write_fasta(q, reads)
    out = _assert_same_run(prefix, q, tmp_path)
    assert out.count(b"\n") == len(reads)


def test_unported_flags_fail(tmp_path, capsys):
    prefix = _build(tmp_path, PAPER_UNITIGS, 4)
    q = tmp_path / "q.fna"
    write_fasta(q, ["AAGTAA"])
    for extra in (["--mesh", "2,1"], ["--engine", "dense"]):
        assert port_cli.main(["search-fmin", "-i", prefix, "-q", str(q), "--device", "cpu",
                              *extra]) == 1
    # kmer-mapper without a subcommand: its usage, exit code 1
    capsys.readouterr()
    assert port_cli.main(["kmer-mapper"]) == 1
    assert "kmer-mapper query" in capsys.readouterr().err


BLOCKED = textwrap.dedent("""
    import sys

    class _NoJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib"):
                raise ImportError("jax is blocked: " + name)
            return None

    sys.meta_path.insert(0, _NoJax())
    import finito_tpu_torch.ops.minimizer_front, finito_tpu_torch.query.engine
    import finito_tpu_torch.kmer_mapper
    from finito_tpu_torch import cli
    tmp, = sys.argv[1:]
    open(tmp + "/u.fna", "w").write(">\\nGTAAGTCT\\n>\\nAGGAAA\\n>\\nACAGG\\n>\\nGTAGG\\n>\\nAGGTA\\n")
    open(tmp + "/q.fna", "w").write(">\\nAAGTAA\\n")
    assert cli.main(["sbwt-build", "-i", tmp + "/u.fna", "-o", tmp + "/x.sbwt", "-k", "4"]) == 0
    assert cli.main(["build-fmin", "-o", tmp + "/idx", "-i", tmp + "/x.sbwt", "-u", tmp + "/u.fna"]) == 0
    assert cli.main(["search-fmin", "-o", tmp + "/out.txt", "-i", tmp + "/idx",
                     "-q", tmp + "/q.fna", "--device", "cpu"]) == 0
    assert open(tmp + "/out.txt").read() == "(0,2) (-1,-1) (0,0)\\n"
    assert cli.main(["kmer-mapper", "build", "-u", tmp + "/u.fna", "-k", "4", "-o", tmp + "/km"]) == 0
    assert cli.main(["kmer-mapper", "query", "-i", tmp + "/km", "-q", tmp + "/q.fna",
                     "-o", tmp + "/km.txt", "--device", "cpu"]) == 0
    assert open(tmp + "/km.txt").read() == "(0,2) (-1,-1) (0,0)\\n"
    assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules)
    print("JAX-FREE OK")
""")


def test_port_runs_with_jax_blocked(tmp_path):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    env.pop("FINITO_JAX_PLATFORM", None)
    r = subprocess.run([sys.executable, "-c", BLOCKED, str(tmp_path)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "JAX-FREE OK" in r.stdout
