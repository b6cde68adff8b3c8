"""The port's kmer-mapper (finito_tpu_torch/kmer_mapper.py) against the JAX
package's finito_tpu.kmer_mapper: query output bytes with and without -r,
under both locate forms, with --host-exact and from a KMIDXv01 file; the
multi-occurrence error (exit code and stderr line). Fixtures are written
inline. Every comparison is exact."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from finito_tpu import kmer_mapper as jax_km
from finito_tpu.io.fastx import reverse_complement
from finito_tpu.io.kmidx import write_kmidx
from finito_tpu.index.minimizer import MinimizerIndex
from finito_tpu_torch import cli as port_cli
from finito_tpu_torch import kmer_mapper as port_km

torch.set_num_threads(1)


def _rc_free_dspss(rng, n, k, lo, hi):
    """Unitigs whose k-mers are distinct and whose k-mer set holds no
    reverse complement of its own k-mers: with -r each k-mer then occurs
    once, so the reference answers instead of erroring."""
    seen, unitigs = set(), []
    while len(unitigs) < n:
        L = int(rng.integers(lo, hi + 1))
        s = "".join(rng.choice(list("ACGT"), L))
        kmers = {s[i : i + k] for i in range(L - k + 1)}
        rcs = {reverse_complement(x.encode()).decode() for x in kmers}
        if len(kmers) != L - k + 1 or (kmers | rcs) & seen or kmers & rcs:
            continue
        seen |= kmers | rcs
        unitigs.append(s)
    return unitigs


def _write_fasta(path, seqs, prefix="s"):
    path.write_text("".join(f">{prefix}{i}\n{s}\n" for i, s in enumerate(seqs)))
    return str(path)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """An index of k=9, m=4 (multi-occurrence slots, so slow runs) and
    queries: unitigs, their substrings and reverse complements, mutated
    and random reads, short reads and reads with an N."""
    tmp = tmp_path_factory.mktemp("km")
    rng = np.random.default_rng(21)
    k = 9
    unitigs = _rc_free_dspss(rng, 12, k, 12, 60)
    idx = str(tmp / "km.idx")
    assert jax_km.main(["build", "-u", _write_fasta(tmp / "u.fna", unitigs, "u"),
                        "-k", str(k), "-m", "4", "-o", idx]) == 0
    queries = list(unitigs[:4])
    for u in unitigs[4:10]:
        a = int(rng.integers(0, len(u) - k))
        queries.append(u[a:])
        queries.append(reverse_complement(u[a:].encode()).decode())
    for u in unitigs[:3]:
        b = list(u)
        b[len(b) // 2] = "ACGT"[("ACGT".index(b[len(b) // 2]) + 1) % 4]
        queries.append("".join(b))
    queries += ["".join(rng.choice(list("ACGT"), int(rng.integers(k, 40)))) for _ in range(4)]
    queries += ["ACG", unitigs[0][: k - 1], unitigs[1][:5] + "N" + unitigs[1][6:]]
    return tmp, idx, _write_fasta(tmp / "q.fna", queries)


def _run(main, idx, q, out, extra=()):
    assert main(["query", "-i", idx, "-q", q, "-o", str(out), *extra]) == 0
    return out.read_bytes()


@pytest.mark.parametrize("v2", ["0", "1"])
@pytest.mark.parametrize("rc", [False, True])
def test_query_bytes_equal_jax(fixture, monkeypatch, rc, v2):
    tmp, idx, q = fixture
    monkeypatch.setenv("FINITO_MINIMIZER_V2", v2)
    extra = ["-r"] if rc else []
    want = _run(jax_km.main, idx, q, tmp / "j.txt", extra)
    got = _run(port_km.main, idx, q, tmp / "p.txt", [*extra, "--device", "cpu"])
    assert got == want
    assert want.count(b"\n") == 26 and b"(-1,-1)" in want
    # the port's CLI passes kmer-mapper to the same module
    got_cli = _run(lambda a: port_cli.main(["kmer-mapper", *a]), idx, q, tmp / "c.txt",
                   [*extra, "--device", "cpu"])
    assert got_cli == want


@pytest.mark.parametrize("rc", [False, True])
def test_host_exact_equals_jax_and_device(fixture, rc):
    tmp, idx, q = fixture
    extra = ["-r"] if rc else []
    want = _run(jax_km.main, idx, q, tmp / "j.txt", [*extra, "--host-exact"])
    assert _run(port_km.main, idx, q, tmp / "p.txt", [*extra, "--host-exact"]) == want
    assert _run(port_km.main, idx, q, tmp / "d.txt", [*extra, "--device", "cpu"]) == want


@pytest.mark.parametrize("v2", ["0", "1"])
def test_kmidx_file_equals_jax(tmp_path, monkeypatch, v2):
    """A KMIDXv01 file (the Rust binary's container) is imported and
    answered as the JAX CLI answers it."""
    monkeypatch.setenv("FINITO_MINIMIZER_V2", v2)
    rng = np.random.default_rng(8)
    k = 15  # long enough that no k-mer of the random text repeats
    ends = np.cumsum(rng.integers(k, 120, size=20)).astype(np.int64)
    concat = rng.integers(0, 4, size=int(ends[-1]), dtype=np.uint8)
    index = MinimizerIndex.build(concat, ends, k)
    index.headers = [f"u{i}".encode() for i in range(ends.size)]
    p = str(tmp_path / "rust.kmidx")
    write_kmidx(p, index)
    from finito_tpu.io.seqdb import decode_seq

    text = decode_seq(concat).decode()
    q = _write_fasta(tmp_path / "q.fna", [text[: 3 * k], text[100:160], "A" * (k + 3)])
    want = _run(jax_km.main, p, q, tmp_path / "j.txt", ["-r"])
    assert _run(port_km.main, p, q, tmp_path / "p.txt", ["-r", "--device", "cpu"]) == want
    assert want.count(b"\n") == 3


def _error_run(main, argv, capsys):
    with pytest.raises(SystemExit) as e:
        main(argv)
    return e.value.code, capsys.readouterr().err.splitlines()[-1]


@pytest.mark.parametrize("v2", ["0", "1"])
@pytest.mark.parametrize("case", ["duplicated_unitig", "forward_duplicate"])
def test_multi_occurrence_error_equals_jax(tmp_path, monkeypatch, capsys, case, v2):
    """A k-mer stored twice: in two unitigs (one unitig stored twice), or
    twice inside one unitig. Both CLIs exit 1 with the same error line,
    with and without -r ('occurs in 2 unitigs' but for -r on the forward
    duplicate, whose reverse complement occurs as well)."""
    monkeypatch.setenv("FINITO_MINIMIZER_V2", v2)
    if case == "duplicated_unitig":
        u = _rc_free_dspss(np.random.default_rng(3), 5, 9, 15, 40)
        unitigs, k, read = u + [u[2]], 9, u[2][3:20]
    else:
        unitigs, k, read = ["AACGTTTAACGTC"], 5, "TTAACGT"
    idx = str(tmp_path / "idx")
    assert jax_km.main(["build", "-u", _write_fasta(tmp_path / "u.fna", unitigs),
                        "-k", str(k), "-o", idx]) == 0
    capsys.readouterr()
    q = _write_fasta(tmp_path / "q.fna", [read])
    for extra in ([], ["-r"]):
        base = ["query", "-i", idx, "-q", q, *extra]
        want = _error_run(jax_km.main, base, capsys)
        got = _error_run(port_km.main, [*base, "--device", "cpu"], capsys)
        assert got == want
        assert want[0] == 1 and "occurs in" in want[1]
        assert "occurs in 2 unitigs" in want[1] or (extra and case == "forward_duplicate")


def test_cuda_without_card_raises(fixture):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, idx, _ = fixture
    with pytest.raises(RuntimeError):
        port_km._device_locate(port_km._load_index(idx), [b"ACGTACGTACGT"], False, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("v2", ["0", "1"])
def test_query_on_card_equals_cpu(fixture, monkeypatch, v2):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tmp, idx, q = fixture
    monkeypatch.setenv("FINITO_MINIMIZER_V2", v2)
    want = _run(port_km.main, idx, q, tmp / "cpu.txt", ["-r", "--device", "cpu"])
    assert _run(port_km.main, idx, q, tmp / "cuda.txt", ["-r", "--device", "cuda"]) == want


# The reference's example.fna (three unitigs under headers 2, 3, 1), written
# inline: the twins of tests/test_kmer_mapper.py's checks that read it from
# the reference checkout.
EXAMPLE_FNA = ">2\nACAGGTA\n>3\nGTAGGAAA\n>1\nGTAAGTCT\n"


@pytest.fixture(scope="module")
def example_index(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("example")
    (tmp / "example.fna").write_text(EXAMPLE_FNA)
    idx = str(tmp / "idx")
    assert port_km.main(["build", "-u", str(tmp / "example.fna"), "-k", "4", "-o", idx]) == 0
    return idx


def test_example_permutation_matches_colex(example_index):
    """Unitigs in colex order of their first 4-mers (GTAA < ACAG < GTAG),
    headers carried along."""
    from finito_tpu_torch.index.minimizer import MinimizerIndex as PortMinimizerIndex
    from finito_tpu_torch.io.seqdb import decode_seq

    mi = PortMinimizerIndex.load(example_index)
    start, seqs = 0, []
    for e in mi.ends:
        seqs.append(decode_seq(mi.concat[start : int(e)]).decode())
        start = int(e)
    assert seqs == ["GTAAGTCT", "ACAGGTA", "GTAGGAAA"]
    assert mi.headers == [b"1", b"2", b"3"]


@pytest.mark.parametrize("extra", [["--device", "cpu"], ["--host-exact"]])
def test_example_query_output(example_index, tmp_path, extra):
    q = tmp_path / "q.fna"
    q.write_text(">q1\nACAGGTAAGT\n>q2\nTTTT\n")
    lines = _run(port_km.main, example_index, str(q), tmp_path / "o.txt", extra).decode().splitlines()
    # ACAGGTAAGT: windows map into ACAGGTA (uid 1) then GTAAGTCT (uid 0)
    assert lines == ["(1,0) (1,1) (1,2) (1,3) (0,0) (0,1) (0,2)", "(-1,-1)"]


@pytest.mark.parametrize("extra", [["--device", "cpu"], ["--host-exact"]])
def test_example_query_rc_merge(example_index, tmp_path, extra):
    """The reverse complement of GTAAGTCT is found only with -r, its
    window w at forward window W-1-w."""
    q = tmp_path / "q.fna"
    q.write_text(">r\n" + reverse_complement(b"GTAAGTCT").decode() + "\n")
    fwd = _run(port_km.main, example_index, str(q), tmp_path / "f.txt", extra).decode()
    assert all(p == "(-1,-1)" for p in fwd.splitlines()[0].split())
    merged = _run(port_km.main, example_index, str(q), tmp_path / "r.txt", [*extra, "-r"])
    assert merged.decode().splitlines()[0] == "(0,4) (0,3) (0,2) (0,1) (0,0)"


def test_example_extract_index_unitigs(example_index, tmp_path):
    out = tmp_path / "out.fna"
    assert port_km.main(["extract-index-unitigs", "-i", example_index, "-o", str(out)]) == 0
    assert out.read_text() == ">1\nGTAAGTCT\n>2\nACAGGTA\n>3\nGTAGGAAA\n"
