"""The port's device-resident query step, DeviceQueryEngine
.make_device_pipeline (finito_tpu_torch/query/engine.py), on the CPU
against the JAX engine's make_device_pipeline: for every mode, on a small
k = 6 index and on a 120 kbp repeat-dense k = 21 index, the same (uid,
off, count) for the same (batch, read_len, unknown_frac), with the same
capacities K and K_heads; the v1/v2 rule by descriptor size alone, as
JAX's (FINITO_MINIMIZER_V2 is the engine's variable); the v2 form
(forced by a zero size threshold) against JAX's
make_minimizer_locate_v2 at the pipeline's capacities; an
undersized K reported by count > K as in JAX; every window of the repeat
batch equal to the index-free oracle. The port reads the other package's
index files with its own loader. Every comparison is exact."""

from __future__ import annotations

import inspect

import numpy as np
import pytest
import torch

from finito_tpu.index.index import FinimizerIndex as JaxIndex
from finito_tpu.io.seqdb import encode_seq
from finito_tpu.query import minimizer_engine as jme
from finito_tpu.query.engine import DeviceQueryEngine as JaxEngine
from finito_tpu_torch.index.index import FinimizerIndex as PortIndex
from finito_tpu_torch.query import minimizer_engine as port_mini
from finito_tpu_torch.query.engine import DeviceQueryEngine

# plain module names: pytest puts tests/ on sys.path, and a `tests` package
# installed elsewhere cannot shadow it
from test_device_engine import build_index, gen_dspss
from test_torch_synth import build_repeat_index, sample_reads

torch.set_num_threads(1)

MODES = ["minimizer", "dense", "stream", "replica"]


def _small(tmp):
    """k = 6: mutation-heavy reads from the unitigs, pads and invalid codes."""
    rng = np.random.default_rng(52)
    k = 6
    unitigs = gen_dspss(rng, 12, 12, 60, k)
    build_index(unitigs, k).serialize(str(tmp / "idx"))
    B, L = 16, 40
    reads = np.full((B, L), 255, np.uint8)
    for b in range(B):
        u = encode_seq(unitigs[int(rng.integers(len(unitigs)))].encode())
        n = min(u.size, L)
        reads[b, :n] = u[:n]
        for _ in range(int(rng.integers(0, 5))):
            p = int(rng.integers(0, n))
            reads[b, p] = (reads[b, p] + int(rng.integers(1, 4))) % 4
        if b % 4 == 0:
            reads[b, int(rng.integers(0, L))] = 255
    return k, reads, None


def _repeat(tmp):
    """k = 21, the 120 kbp repeat genome, reads with 1% point mutations."""
    genome, index, _ = build_repeat_index()
    index.serialize(str(tmp / "idx"))
    reads = sample_reads(genome, np.random.default_rng(21), B=32, L=96)
    return 21, reads, genome


class Cell:
    """One index in both packages, its reads and engines built on demand."""

    def __init__(self, tmp, make):
        self.k, self.reads, self.genome = make(tmp)
        self.prefix = str(tmp / "idx")
        self.jindex, self.pindex = JaxIndex.load(self.prefix), PortIndex.load(self.prefix)
        self._engines = {}

    def engines(self, mode):
        if mode not in self._engines:
            self._engines[mode] = (JaxEngine(self.jindex, mode=mode),
                                   DeviceQueryEngine(self.pindex, mode=mode, device="cpu"))
        return self._engines[mode]


@pytest.fixture(scope="module", params=["small", "repeat"])
def cell(request, tmp_path_factory):
    make = {"small": _small, "repeat": _repeat}[request.param]
    return Cell(tmp_path_factory.mktemp(request.param), make)


def _equal_outputs(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("mode", MODES)
def test_pipeline_equals_jax(cell, mode):
    jeng, peng = cell.engines(mode)
    B, L = cell.reads.shape
    frac = 0.02 if mode in ("stream", "replica") else 0.10
    want_pipe = jeng.make_device_pipeline(B, L, unknown_frac=frac)
    pipe = peng.make_device_pipeline(B, L, unknown_frac=frac)
    assert pipe.K == want_pipe.K
    assert pipe.K_heads == getattr(want_pipe, "K_heads", None)
    got = pipe(torch.from_numpy(cell.reads))
    want = want_pipe(cell.reads)
    assert got[0].dtype == got[1].dtype == torch.int32
    _equal_outputs(got, want)
    assert int(got[2]) <= pipe.K
    if mode == "dense":
        assert int(got[2]) == 0 and pipe.K == B * (L - cell.k + 1)
    if cell.genome is not None:  # every window against the index-free oracle
        from finito_tpu_torch.utils.synth import kmer_location_oracle

        uid, off = kmer_location_oracle(np.asarray(cell.pindex.unitigs.concat),
                                        np.asarray(cell.pindex.unitigs.ends), cell.reads, cell.k)
        assert np.array_equal(got[0].numpy(), uid) and np.array_equal(got[1].numpy(), off)


def _force_v2(monkeypatch):
    """The pipeline picks v2 by descriptor size alone (FINITO_MINIMIZER_V2
    is not its variable, as it is not JAX's): a zero threshold forces it."""
    monkeypatch.setattr(port_mini, "V2_MIN_DESC_BYTES", 0)


@pytest.mark.parametrize("v2", ["0", "1"])
def test_pipeline_ignores_minimizer_v2_variable(cell, monkeypatch, v2):
    """FINITO_MINIMIZER_V2 forces the engine's locate form, not the
    pipeline's: in both packages the pipeline stays v1 on this small
    index, with equal output, while the port's engine takes the form the
    variable names."""
    monkeypatch.setenv("FINITO_MINIMIZER_V2", v2)
    B, L = cell.reads.shape
    jeng, peng = cell.engines("minimizer")
    pipe = peng.make_device_pipeline(B, L, unknown_frac=0.1)
    want_pipe = jeng.make_device_pipeline(B, L, unknown_frac=0.1)
    assert pipe.K_heads is None and want_pipe.K_heads is None
    _equal_outputs(pipe(torch.from_numpy(cell.reads)), want_pipe(cell.reads))
    assert DeviceQueryEngine(cell.pindex, device="cpu").use_v2 == (v2 == "1")


def test_forced_v2_equals_jax_locate_v2(cell, monkeypatch):
    """The v2 form forced (a zero size threshold) with JAX's pipeline
    capacities, equal to JAX's make_minimizer_locate_v2 at those
    capacities and to the v1 pipeline's windows."""
    jeng, peng = cell.engines("minimizer")
    B, L = cell.reads.shape
    v1 = peng.make_device_pipeline(B, L, unknown_frac=0.1)
    assert v1.K_heads is None
    _force_v2(monkeypatch)
    pipe = peng.make_device_pipeline(B, L, unknown_frac=0.1)
    BW = B * (L - cell.k + 1)
    assert pipe.K == max(256, int(BW * 0.1))
    assert pipe.K_heads == max(1024, int(BW * 2.8 / (cell.k - peng._dmi.m + 2)))
    got = pipe(torch.from_numpy(cell.reads))
    want = jme.make_minimizer_locate_v2(jeng._dmi, pipe.K, pipe.K_heads)(cell.reads)
    assert len(got) == 4
    _equal_outputs(got, want)
    codes = torch.from_numpy(cell.reads)
    _equal_outputs(got[:2], v1(codes)[:2])


@pytest.mark.parametrize("mode", ["minimizer", "minimizer v2", "stream", "replica"])
def test_undersized_capacity_reported(cell, monkeypatch, mode):
    """unknown_frac 0 gives the smallest K: where the batch needs more,
    the count exceeds K, the same count as JAX's."""
    if mode == "minimizer v2":
        _force_v2(monkeypatch)
    jeng, peng = cell.engines(mode.split()[0])
    if cell.genome is None:
        reads = np.concatenate([cell.reads] * 64)
    else:  # dense mutations: many repair segments; enough slow runs for v2
        reads = sample_reads(cell.genome, np.random.default_rng(4), B=768, L=96, mutate=0.06)
    B, L = reads.shape
    pipe = peng.make_device_pipeline(B, L, unknown_frac=0.0)
    got = pipe(torch.from_numpy(reads))
    if mode == "minimizer v2":
        want = jme.make_minimizer_locate_v2(jeng._dmi, pipe.K, pipe.K_heads)(reads)
        assert int(got[3]) == int(want[3])
    else:
        want_pipe = jeng.make_device_pipeline(B, L, unknown_frac=0.0)
        assert want_pipe.K == pipe.K
        want = want_pipe(reads)
    assert int(got[2]) == int(want[2])
    if mode in ("stream", "replica") or cell.genome is not None:
        assert int(got[2]) > pipe.K, (mode, int(got[2]), pipe.K)
    if int(got[2]) <= pipe.K:  # within capacity the windows agree too
        _equal_outputs(got[:2], want[:2])


def test_mesh_engine_has_no_pipeline(cell):
    eng = DeviceQueryEngine(cell.pindex, mesh=(2, 1), device="cpu")
    with pytest.raises(ValueError, match="no mesh form"):
        eng.make_device_pipeline(*cell.reads.shape)


def test_pipeline_defaults_to_cuda(cell):
    """The engine, and so its pipeline, runs on the card by default;
    without a card the engine raises before it builds anything."""
    assert inspect.signature(DeviceQueryEngine).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceQueryEngine(cell.pindex, mode="dense")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES + ["minimizer v2"])
def test_pipeline_on_card_equals_cpu(cell, monkeypatch, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if mode == "minimizer v2":
        _force_v2(monkeypatch)
    mode = mode.split()[0]
    B, L = cell.reads.shape
    codes = torch.from_numpy(cell.reads)
    want = cell.engines(mode)[1].make_device_pipeline(B, L, unknown_frac=0.1)(codes)
    eng = DeviceQueryEngine(cell.pindex, mode=mode, device="cuda")
    got = eng.make_device_pipeline(B, L, unknown_frac=0.1)(codes.cuda())
    assert all(t.device.type == "cuda" for t in got)
    _equal_outputs([t.cpu() for t in got], want)
