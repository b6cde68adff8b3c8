"""The port's own host layers (finito_tpu_torch: utils, native, io, sbwt,
index, query/oracle, stats_modes, dbg, the CLI's host commands and
kmer-mapper build) held to the JAX package's originals: byte-identical
files from both CLIs, indexes that each package reads from the other's
files, equal searches, and equal host functions with the native library
and under FINITO_NO_NATIVE=1. Every comparison is exact."""

from __future__ import annotations

import importlib
import os
from types import SimpleNamespace

import numpy as np
import pytest

from finito_tpu import cli as jax_cli
from finito_tpu.index.index import FinimizerIndex as JaxIndex
from finito_tpu.io.fastx import reverse_complement
from finito_tpu_torch import cli as port_cli
from finito_tpu_torch.index.index import FinimizerIndex as PortIndex

# plain module name: pytest puts tests/ on sys.path, and a `tests` package
# installed elsewhere cannot shadow it
from test_device_engine import gen_dspss

K = 15


def _write_fasta(path, seqs):
    path.write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(seqs)))
    return str(path)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Raw reads (with mutations and an N), a DSPSS of k = 15 and, made by
    the JAX CLI, its .sbwt, the algbio form of it and an LCS file."""
    d = tmp_path_factory.mktemp("inputs")
    rng = np.random.default_rng(15)
    genome = "".join(rng.choice(list("ACGT"), 3000))
    reads = []
    for s in rng.integers(0, len(genome) - 100, 80):
        r = list(genome[s : s + 100])
        r[int(rng.integers(100))] = "ACGT"[int(rng.integers(4))]
        reads.append("".join(r))
    reads[3] = reads[3][:50] + "N" + reads[3][51:]
    dspss = gen_dspss(rng, 16, 20, 90, K)
    p = SimpleNamespace(dir=d, reads=_write_fasta(d / "reads.fna", reads),
                        dspss=_write_fasta(d / "dspss.fna", dspss), unitigs=dspss,
                        sbwt=str(d / "x.sbwt"), algbio=str(d / "a.sbwt"), lcs=str(d / "idx.LCS.sdsl"))
    assert jax_cli.main(["sbwt-build", "-k", str(K), "-i", p.dspss, "-o", p.sbwt]) == 0
    assert jax_cli.main(["convert-sbwt", "-i", p.sbwt, "-o", p.algbio, "--to", "algbio"]) == 0
    assert jax_cli.main(["build-fmin", "-i", p.sbwt, "-u", p.dspss, "-o", str(d / "idx")]) == 0
    return p


# each case: the arguments of one CLI call writing into directory o
CLI_CASES = {
    "unitigs": lambda p, o: ["unitigs", "-k", str(K), "-i", p.reads, "-o", f"{o}/u.fna"],
    "unitigs-flip": lambda p, o: ["unitigs", "-k", str(K), "-i", p.reads, "-o", f"{o}/u.fna",
                                  "--flip"],
    "unitigs-forward-only": lambda p, o: ["unitigs", "-k", str(K), "-i", p.reads,
                                          "-o", f"{o}/u.fna", "--forward-only"],
    "unitigs-min-multiplicity": lambda p, o: ["unitigs", "-k", str(K), "-i", p.reads,
                                              "-o", f"{o}/u.fna", "--min-multiplicity", "2"],
    "simplitigs": lambda p, o: ["unitigs", "-k", str(K), "-i", p.reads, "-o", f"{o}/u.fna",
                                "--mode", "simplitigs"],
    "flip-unitigs": lambda p, o: ["flip-unitigs", "-k", str(K), "-i", p.dspss,
                                  "-o", f"{o}/f.fna"],
    "sbwt-build": lambda p, o: ["sbwt-build", "-k", str(K), "-i", p.dspss, "-o", f"{o}/x.sbwt"],
    "convert-sbwt-to-algbio": lambda p, o: ["convert-sbwt", "-i", p.sbwt, "-o", f"{o}/a.sbwt",
                                            "--to", "algbio"],
    "convert-sbwt-to-finito": lambda p, o: ["convert-sbwt", "-i", p.algbio, "-o", f"{o}/f.sbwt",
                                            "--to", "finito"],
    "build-fmin": lambda p, o: ["build-fmin", "-i", p.sbwt, "-u", p.dspss, "-o", f"{o}/idx"],
    "build-fmin-algbio-sbwt": lambda p, o: ["build-fmin", "-i", p.algbio, "-u", p.dspss,
                                            "-o", f"{o}/idx"],
    "build-fmin-given-lcs": lambda p, o: ["build-fmin", "-i", p.sbwt, "-u", p.dspss,
                                          "-o", f"{o}/idx", "--lcs", p.lcs],
    "build-fmin-shortest": lambda p, o: ["build-fmin", "-i", p.sbwt, "-u", p.dspss,
                                         "-o", f"{o}/idx", "--type", "shortest", "-t", "3"],
    "build-fmin-verify": lambda p, o: ["build-fmin", "-i", p.sbwt, "-u", p.dspss,
                                       "-o", f"{o}/idx", "--type", "verify", "-t", "3"],
    "kmer-mapper-build": lambda p, o: ["kmer-mapper", "build", "-u", p.dspss, "-k", str(K),
                                       "-o", f"{o}/km.idx"],
    "kmer-mapper-build-m": lambda p, o: ["kmer-mapper", "build", "-u", p.dspss, "-k", str(K),
                                         "-m", "6", "-o", f"{o}/km.idx"],
}


def _files(d):
    return {name: open(os.path.join(d, name), "rb").read() for name in sorted(os.listdir(d))}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_files_equal_jax(inputs, tmp_path, case):
    got = {}
    for name, main in (("jax", jax_cli.main), ("port", port_cli.main)):
        out = tmp_path / name
        out.mkdir()
        assert main(CLI_CASES[case](inputs, out)) == 0
        got[name] = _files(out)
    assert got["port"].keys() == got["jax"].keys() and got["jax"]
    for f in got["jax"]:
        assert got["port"][f] == got["jax"][f], f


def _same(a, b, where="") -> None:
    """Recursive exact equality of index objects, arrays and containers."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for key in a:
            _same(a[key], b[key], f"{where}.{key}")
    elif hasattr(a, "__dict__") and not callable(a):
        assert type(a).__name__ == type(b).__name__, where
        _same(vars(a), vars(b), where or type(a).__name__)
    else:
        assert a == b, where


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_index_load_reads_the_other_package(inputs, tmp_path, writer):
    """Each package's FinimizerIndex.load reads the files either CLI
    writes to equal arrays, and both answer every read equally."""
    main = jax_cli.main if writer == "jax" else port_cli.main
    prefix = str(tmp_path / "idx")
    assert main(["build-fmin", "-i", inputs.sbwt, "-u", inputs.dspss, "-o", prefix]) == 0
    j, p = JaxIndex.load(prefix), PortIndex.load(prefix)
    _same(vars(p), vars(j))
    genome_reads = [u[a : a + 30] for u in inputs.unitigs for a in (0, 5)]
    reads = [r.encode() for r in genome_reads]
    reads += [reverse_complement(r) for r in reads[:6]]
    reads += [b"ACGTACGTACGTACGTACGT", b"ACG", inputs.unitigs[0][:20].encode() + b"N" * 3,
              inputs.unitigs[1].encode()]
    for r in reads:
        jr, pr = j.search(r), p.search(r)
        assert (pr.local_offsets, pr.n_found) == (jr.local_offsets, jr.n_found), r


def test_builder_host_rank_path_equals_key_merge(inputs, tmp_path):
    """Without node keys the port's builder ranks the windows by SBWT
    search on its device (here the CPU; the JAX builder's accelerator
    fallback): the same index arrays and files as with the key merge,
    and as the JAX builder's without node keys."""
    from finito_tpu.index.builder import FinimizerIndexBuilder as JaxBuilder
    from finito_tpu.io.seqdb import SeqDB as JaxSeqDB
    from finito_tpu.sbwt.construct import build_plain_matrix_sbwt as jax_build_sbwt
    from finito_tpu.sbwt.lcs import lcs_array as jax_lcs
    from finito_tpu_torch.index.builder import FinimizerIndexBuilder
    from finito_tpu_torch.io.seqdb import SeqDB
    from finito_tpu_torch.sbwt.construct import build_plain_matrix_sbwt
    from finito_tpu_torch.sbwt.lcs import lcs_array

    seqs = [u.encode() for u in inputs.unitigs]
    out = {}
    sbwt, keys = build_plain_matrix_sbwt(seqs, K, return_keys=True)
    lcs = lcs_array(sbwt).astype(np.int64)
    built = {}
    for name, nk in (("port-host", None), ("port-keys", keys)):
        built[name] = FinimizerIndexBuilder(sbwt, lcs, SeqDB.from_sequences(seqs), node_keys=nk,
                                            device="cpu").get_index()
        built[name].serialize(str(tmp_path / name))
    _same(vars(built["port-host"]), vars(built["port-keys"]))
    jsbwt = jax_build_sbwt(seqs, K)
    JaxBuilder(jsbwt, jax_lcs(jsbwt).astype(np.int64), JaxSeqDB.from_sequences(seqs)) \
        .get_index().serialize(str(tmp_path / "jax"))
    for name in ("port-host", "port-keys", "jax"):
        out[name] = {f[len(name):]: open(tmp_path / f, "rb").read()
                     for f in os.listdir(tmp_path) if f.startswith(name)}
    assert out["port-host"] == out["port-keys"] == out["jax"] and out["jax"]


@pytest.fixture(scope="module")
def superset_sbwt(inputs):
    """A .sbwt of the DSPSS plus one more sequence, made by the JAX CLI:
    build-fmin's reconstruction from the unitigs does not reproduce it,
    so the builder ranks the windows by SBWT search."""
    extra = "".join(np.random.default_rng(3).choice(list("ACGT"), 200))
    fna = _write_fasta(inputs.dir / "superset.fna", inputs.unitigs + [extra])
    out = str(inputs.dir / "superset.sbwt")
    assert jax_cli.main(["sbwt-build", "-k", str(K), "-i", fna, "-o", out]) == 0
    return out


def test_build_fmin_device_fallback_equals_jax(inputs, superset_sbwt, tmp_path, capfd):
    """build-fmin --device cpu where the .sbwt does not match the
    unitigs: the fallback runs, and the files equal the JAX CLI's."""
    got = {}
    for name, main, extra in (("jax", jax_cli.main, []), ("port", port_cli.main,
                                                         ["--device", "cpu"])):
        (tmp_path / name).mkdir()
        capfd.readouterr()
        assert main(["build-fmin", "-i", superset_sbwt, "-u", inputs.dspss,
                     "-o", str(tmp_path / name / "idx"), *extra]) == 0
        assert "does not match the unitig set" in capfd.readouterr().err
        got[name] = _files(tmp_path / name)
    assert got["port"] == got["jax"] and len(got["jax"]) == 8


def test_build_fmin_cuda_without_card_raises_only_in_fallback(inputs, superset_sbwt, tmp_path,
                                                               capfd):
    """build-fmin defaults to --device cuda: without a card the usual
    build (node keys reproduced) runs on the host, and only the SBWT
    search fallback fails, naming the device; it never falls back to
    the host search."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert port_cli.main(["build-fmin", "-i", inputs.sbwt, "-u", inputs.dspss,
                          "-o", str(tmp_path / "ok")]) == 0
    capfd.readouterr()
    assert port_cli.main(["build-fmin", "-i", superset_sbwt, "-u", inputs.dspss,
                          "-o", str(tmp_path / "fb"), "--device", "cuda"]) == 1
    assert "device 'cuda' requested" in capfd.readouterr().err
    assert not os.path.exists(tmp_path / "fb.O.sdsl")


def _pkg(name):
    mods = ("native", "sbwt.keys", "utils.bits", "index.minimizer", "io.fastx", "io.seqdb", "dbg")
    return SimpleNamespace(**{m.split(".")[-1]: importlib.import_module(f"{name}.{m}")
                              for m in mods})


def _fasta(tmp_path, rng):
    seqs = ["".join(rng.choice(list("ACGTN" if i == 2 else "ACGT"), int(rng.integers(30, 120))))
            for i in range(12)]
    return _write_fasta(tmp_path / "h.fna", seqs)


# each case: one host function of a package on seeded inputs
HOST_CASES = {
    "keys.pack_windows": lambda m, c, r, t: m.keys.pack_windows(c, 21),
    "keys.sort_keys": lambda m, c, r, t: m.keys.sort_keys(m.keys.pack_windows(c, 21)),
    "keys.sort_order": lambda m, c, r, t: m.keys.sort_order(m.keys.pack_windows(c, 40)),
    "keys.match_into": lambda m, c, r, t: m.keys.match_into(
        m.keys.sort_keys(m.keys.pack_windows(c[:1500], 21)),
        m.keys.dedup_sorted(m.keys.sort_keys(m.keys.pack_windows(c[700:], 21)))),
    "keys.merge_sorted_unique": lambda m, c, r, t: m.keys.merge_sorted_unique(
        m.keys.dedup_sorted(m.keys.sort_keys(m.keys.pack_windows(c[:1500], 21))),
        m.keys.dedup_sorted(m.keys.sort_keys(m.keys.pack_windows(c[700:], 21)))),
    "keys.rc_keys": lambda m, c, r, t: m.keys.rc_keys(m.keys.pack_windows(c, 33), 33),
    "bits.pack_values": lambda m, c, r, t: m.bits.pack_values(r.integers(0, 1 << 13, 999), 13),
    "bits.unpack_values": lambda m, c, r, t: m.bits.unpack_values(
        r.integers(0, 1 << 62, 40, dtype=np.uint64), 150, 13, np.int32),
    "minimizer.build": lambda m, c, r, t: m.minimizer.MinimizerIndex.build(
        c, np.array([400, 1000, 1300, 3000], np.int64), 15, m=7),
    "fastx.read_all_records": lambda m, c, r, t: m.fastx.read_all_records(_fasta(t, r)),
    "seqdb.from_file": lambda m, c, r, t: m.seqdb.SeqDB.from_file(_fasta(t, r)),
    "native.format_pairs": lambda m, c, r, t: m.native.format_pairs(
        r.integers(-1, 90, 50), r.integers(-1, 4000, 50), np.array([10, 0, 25, 15])),
    "dbg.unitigs_from_fasta": lambda m, c, r, t: m.dbg.unitigs_from_fasta(_fasta(t, r), 11),
    "dbg.build_simplitigs": lambda m, c, r, t: m.dbg.build_simplitigs(
        [c[:800], c[500:1900], c[2500:]], 11),
    "dbg.flip_unitigs": lambda m, c, r, t: m.dbg.flip_unitigs(
        m.dbg.unitigs_from_fasta(_fasta(t, r), 11), 11),
}


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_function_equals_jax(tmp_path, monkeypatch, case, native):
    if not native:
        monkeypatch.setenv("FINITO_NO_NATIVE", "1")
    jax_mods, port_mods = _pkg("finito_tpu"), _pkg("finito_tpu_torch")
    assert (port_mods.native.get_lib() is None) == (jax_mods.native.get_lib() is None)
    if native:
        assert port_mods.native.get_lib() is not None, "the port's host library did not build"
    out = []
    for mods in (jax_mods, port_mods):
        rng = np.random.default_rng(77)
        codes = rng.integers(0, 4, 3000).astype(np.uint8)
        sub = tmp_path / mods.native.__name__.split(".")[0]
        sub.mkdir()
        out.append(HOST_CASES[case](mods, codes, rng, sub))
    _same(out[1], out[0], case)
