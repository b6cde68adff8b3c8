"""The port's CLI (finito_tpu_torch/cli.py, --device cpu) against the JAX
CLI's search-fmin --engine minimizer: byte-identical output and
<prefix>.stats, and <prefix>stats.txt equal in every field but the
timing, on one device and with --mesh 4,2; unitigs --mesh 4 byte-
identical to the JAX CLI's and to the host build. Also: the port,
kmer-mapper included, runs with jax imports blocked."""

from __future__ import annotations

import gzip
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax

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


def _assert_same_run(prefix, query, tmp_path, engine="minimizer"):
    j_out, j_stats, j_txt = _search(jax_cli.main, prefix, query, tmp_path / "j.txt",
                                    ["--engine", engine])
    p_out, p_stats, p_txt = _search(port_cli.main, prefix, query, tmp_path / "p.txt",
                                    ["--device", "cpu", "--engine", engine])
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


@pytest.mark.parametrize("engine", ["dense", "stream", "replica"])
def test_new_engines_random_dspss_k11(tmp_path, engine):
    """search-fmin --engine dense/stream/replica: the JAX CLI's bytes, on
    mutated, chimeric, short and N reads."""
    rng = np.random.default_rng(11)
    k = 11
    unitigs = gen_dspss(rng, 12, 30, 90, k)
    prefix = _build(tmp_path, unitigs, k)
    genome = "".join(unitigs)
    reads = []
    for i in range(30):
        s = int(rng.integers(0, len(genome) - 70))
        r = list(genome[s : s + int(rng.integers(k, 70))])
        for _ in range(i % 4):
            p = int(rng.integers(0, len(r)))
            r[p] = "ACGT"[("ACGT".index(r[p]) + 1) % 4]
        reads.append("".join(r))
    reads += [unitigs[0][-(k + 3):] + unitigs[1][: k + 3], "ACGT", "ACGTN" * 6, genome[:150]]
    q = tmp_path / "q.fna"
    write_fasta(q, reads)
    out = _assert_same_run(prefix, q, tmp_path, engine)
    assert out.count(b"\n") == len(reads)
    assert out == _assert_same_run(prefix, q, tmp_path, "minimizer")


def test_engines_default_to_cuda(tmp_path, capsys):
    """Without --device every device engine asks for the card; with no
    card the run fails (exit code 1) and writes no output."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    prefix = _build(tmp_path, PAPER_UNITIGS, 4)
    q = tmp_path / "q.fna"
    write_fasta(q, ["AAGTAA"])
    for engine in ("minimizer", "dense", "stream", "replica"):
        out = tmp_path / f"{engine}.txt"
        capsys.readouterr()
        assert port_cli.main(["search-fmin", "-o", str(out), "-i", prefix, "-q", str(q),
                              "--engine", engine]) == 1
        assert "CUDA is not available" in capsys.readouterr().err
        assert not out.exists()


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the virtual 8-device mesh")
def test_mesh_matches_single_and_jax(tmp_path):
    """search-fmin --device cpu --mesh 4,2: output and .stats byte-
    identical to the port's single-device run and to the JAX CLI's
    --mesh 4,2 on its 8 virtual devices (the JAX test_mesh case)."""
    rng = np.random.default_rng(31)
    k = 6
    unitigs = gen_dspss(rng, 12, 12, 60, k)
    prefix = _build(tmp_path, unitigs, k)
    reads = []
    for i in range(17):
        if i % 3 == 0:
            reads.append(unitigs[int(rng.integers(len(unitigs)))])
        else:
            reads.append("".join(rng.choice(list("ACGT"), int(rng.integers(k, 40)))))
    q = tmp_path / "q.fna"
    write_fasta(q, reads)
    j_out, j_stats, j_txt = _search(jax_cli.main, prefix, q, tmp_path / "j.txt",
                                    ["--engine", "minimizer", "--mesh", "4,2"])
    runs = [_search(port_cli.main, prefix, q, tmp_path / f"p{i}.txt", ["--device", "cpu", *extra])
            for i, extra in enumerate((["--mesh", "4,2"], []))]
    for p_out, p_stats, p_txt in runs:
        assert (p_out, p_stats) == (j_out, j_stats)
        assert p_txt.decode().split(",")[2:] == j_txt.decode().split(",")[2:]
    assert j_out.count(b"\n") == 17


@pytest.mark.parametrize("mesh", ["8,1", "4,2"])
def test_mesh_small_last_chunk(tmp_path, mesh):
    """search-fmin --mesh on a 1-read and a 2-read query file: B = 2 or 4
    rows, which dp = 8 or 4 does not divide. The JAX CLI raises; the port
    pads B to dp with absent rows (ROADMAP C7) and writes the single-
    device run's bytes, whose windows are the host oracle's."""
    from finito_tpu_torch.index.index import FinimizerIndex
    from finito_tpu_torch.io.fastx import reverse_complement

    rng = np.random.default_rng(8)
    k = 6
    unitigs = gen_dspss(rng, 12, 12, 60, k)
    prefix = _build(tmp_path, unitigs, k)
    index = FinimizerIndex.load(prefix)
    for reads in ([unitigs[0]], [unitigs[1][3:], "ACGTTGCAAGT"]):
        q = tmp_path / "q.fna"
        write_fasta(q, reads)
        got, single = (_search(port_cli.main, prefix, q, tmp_path / f"p{i}.txt",
                               ["--device", "cpu", *extra])[:2]
                       for i, extra in enumerate((["--mesh", mesh], [])))
        assert got == single
        lines = got[0].decode().splitlines()
        assert len(lines) == len(reads)
        for r, line in zip(reads, lines):
            fwd = index.search(r.encode()).local_offsets
            rc = index.search(reverse_complement(r.encode())).local_offsets
            want = [p if p[0] != -1 else rc[len(r) - k - i] for i, p in enumerate(fwd)]
            assert line == " ".join(f"({u},{o})" for u, o in want)


def test_unported_flags_fail(tmp_path, capsys):
    """The JAX CLI's --mesh checks, word for word; and unitigs --mesh N
    without --device asks for the cards, so with none visible it fails
    (exit code 1) and writes nothing, never building on the CPU."""
    prefix = _build(tmp_path, PAPER_UNITIGS, 4)
    q = tmp_path / "q.fna"
    write_fasta(q, ["AAGTAA"])
    for extra, msg in ((["--mesh", "3,1"], "--mesh DP must be a power of two"),
                       (["--mesh", "2"], "--mesh must be DP,TP integers"),
                       (["--mesh", "2,1", "--engine", "oracle"], "--mesh requires --engine minimizer")):
        capsys.readouterr()
        assert port_cli.main(["search-fmin", "-i", prefix, "-q", str(q), "--device", "cpu",
                              *extra]) == 1
        assert msg in capsys.readouterr().err
    with pytest.raises(ValueError, match="--mesh requires the minimizer engine"):
        port_cli.main(["search-fmin", "-i", prefix, "-q", str(q), "--device", "cpu",
                       "--engine", "dense", "--mesh", "2,1"])
    if not torch.cuda.is_available():
        capsys.readouterr()
        assert port_cli.main(["unitigs", "-k", "3", "-i", str(q), "-o", str(tmp_path / "um.fna"),
                              "--mesh", "2"]) == 1
        assert "none is visible" in capsys.readouterr().err
        assert not (tmp_path / "um.fna").exists()
    # kmer-mapper without a subcommand: its usage, exit code 1
    capsys.readouterr()
    assert port_cli.main(["kmer-mapper"]) == 1
    assert "kmer-mapper query" in capsys.readouterr().err


def _pangenome_fasta(path, seed, base_len, n_var, snp):
    """A base genome and n_var copies with point substitutions, and an N
    that splits one of them (tests/test_shard_dbg.py's shape)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=base_len, dtype=np.uint8)
    seqs = [base]
    for _ in range(n_var):
        v = base.copy()
        pos = rng.choice(base_len, size=max(1, int(snp * base_len)), replace=False)
        v[pos] = (v[pos] + rng.integers(1, 4, size=pos.size)) % 4
        seqs.append(v)
    strs = ["".join("ACGT"[c] for c in v) for v in seqs]
    strs[1] = strs[1][:700] + "N" + strs[1][701:]
    write_fasta(path, strs)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the virtual 8-device mesh")
def test_unitigs_mesh_matches_host_and_jax(tmp_path):
    """unitigs --mesh 4 --device cpu (4 shards on the CPU): the file is
    byte-identical to the JAX CLI's unitigs --mesh 4 (on its virtual
    devices) and to the port's host unitigs; with --flip, to the host
    unitigs --flip."""
    fna = tmp_path / "pan.fna"
    _pangenome_fasta(fna, 21, 1500, 3, 0.01)
    outs = {}
    for name, main, extra in (("jax", jax_cli.main, ["--mesh", "4"]),
                              ("mesh", port_cli.main, ["--mesh", "4", "--device", "cpu"]),
                              ("host", port_cli.main, []),
                              ("mesh_flip", port_cli.main, ["--mesh", "4", "--device", "cpu",
                                                            "--flip"]),
                              ("host_flip", port_cli.main, ["--flip"])):
        out = tmp_path / f"{name}.fna"
        assert main(["unitigs", "-k", "21", "-i", str(fna), "-o", str(out), *extra]) == 0
        outs[name] = out.read_bytes()
    assert outs["mesh"] == outs["jax"] == outs["host"]
    assert outs["mesh_flip"] == outs["host_flip"] != outs["host"]
    assert outs["mesh"].count(b">") > 10


def test_unitigs_mesh_refusals(tmp_path):
    """The JAX CLI's unitigs --mesh checks, word for word."""
    fna = tmp_path / "pan.fna"
    _pangenome_fasta(fna, 5, 200, 1, 0.01)
    base = ["unitigs", "-k", "11", "-i", str(fna), "-o", str(tmp_path / "u.fna"), "--mesh", "2"]
    for extra, msg in ((["--mode", "simplitigs"], "--mode simplitigs: host canonical build only"),
                       (["--forward-only"], "--mesh supports canonical mode only"),
                       (["--min-multiplicity", "2"],
                        "--min-multiplicity requires the host build (no --mesh)")):
        for main, device in ((port_cli.main, ["--device", "cpu"]), (jax_cli.main, [])):
            with pytest.raises(SystemExit, match=re.escape(msg)):
                main(base + device + extra)
    assert not (tmp_path / "u.fna").exists()


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
