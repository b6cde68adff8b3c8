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
