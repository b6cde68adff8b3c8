"""The port's multi-process read split (finito_tpu_torch/parallel/
distributed.py): contiguous splits and the rank-ordered merge are
byte-equal to a single-process run, simulated with sequential
"processes" and in a real 2-process torch.distributed run (gloo,
localhost, one subprocess per rank). The helpers equal the JAX
package's.

This file is also the worker of the real run:

    python tests/test_torch_distributed.py PID NPROC PORT PREFIX READS OUT

joins the process group, loads the index at PREFIX with the port's
loader, runs its slice of READS (one read per line) on the CPU and
writes its part; rank 0 merges after the barrier."""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reads(rng, unitigs, k, n):
    reads = []
    for _ in range(n):
        if rng.random() < 0.5:
            reads.append(unitigs[int(rng.integers(len(unitigs)))].encode())
        else:
            reads.append("".join(rng.choice(list("ACGT"), int(rng.integers(k, 30)))).encode())
    return reads


def _index(tmp_path, seed, n_unitigs):
    """(the port's index, the JAX index, reads, index prefix)"""
    from finito_tpu_torch.index.index import FinimizerIndex

    from test_device_engine import build_index, gen_dspss

    rng = np.random.default_rng(seed)
    k = 6
    unitigs = gen_dspss(rng, n_unitigs, 10, 40, k)
    jindex = build_index(unitigs, k)
    prefix = str(tmp_path / "idx")
    jindex.serialize(prefix)
    return FinimizerIndex.load(prefix), jindex, _reads(rng, unitigs, k, 25), prefix


def test_process_slice_partition():
    from finito_tpu.parallel import distributed as jdist
    from finito_tpu_torch.parallel import distributed as dist

    for n in (0, 1, 7, 100):
        for np_ in (1, 2, 3, 8):
            spans = [dist.process_slice(n, p, np_) for p in range(np_)]
            assert spans == [jdist.process_slice(n, p, np_) for p in range(np_)]
            assert spans[0][0] == 0 and spans[-1][1] == n
            for (a, b), (c, d) in zip(spans, spans[1:]):
                assert b == c and b >= a
            items = list(range(n))
            assert sum((dist.split_for_process(items, p, np_) for p in range(np_)), []) == items
    assert dist.part_path("o.txt", 3) == jdist.part_path("o.txt", 3) == "o.txt.part00003"


def test_distributed_equals_single(tmp_path):
    """A simulated 3-process split merges byte-equal to the single run,
    and the single run equals the JAX package's."""
    from finito_tpu.parallel import distributed as jdist
    from finito_tpu.query.engine import DeviceQueryEngine as JaxEngine
    from finito_tpu_torch.parallel import distributed as dist
    from finito_tpu_torch.query.engine import DeviceQueryEngine

    index, jindex, reads, _ = _index(tmp_path, 17, 10)
    engine = DeviceQueryEngine(index, device="cpu")
    single = str(tmp_path / "single.txt")
    dist.run_distributed_queries(engine, reads, single, 0, 1)
    multi = str(tmp_path / "multi.txt")
    NP = 3
    for pid in range(NP):
        dist.run_distributed_queries(engine, reads, multi, pid, NP)
    dist.merge_parts(multi, NP)
    jax_single = str(tmp_path / "jax.txt")
    jdist.run_distributed_queries(JaxEngine(jindex, mode="minimizer"), reads, jax_single, 0, 1)
    got = open(multi, "rb").read()
    assert got == open(single, "rb").read() == open(jax_single, "rb").read()
    assert got.count(b"\n") == len(reads)
    assert not any(os.path.exists(dist.part_path(multi, p)) for p in range(NP))


def test_init_distributed_single_process(monkeypatch):
    """Without a coordinator or with one process: no process group, and
    the barrier is a no-op."""
    import torch.distributed as tdist

    from finito_tpu_torch.parallel import distributed as dist

    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert dist.init_distributed() == (0, 1)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert dist.init_distributed() == (0, 1)
    assert not tdist.is_initialized()
    dist.distributed_barrier("nothing to wait for")


def test_two_process_gloo(tmp_path):
    """Two OS processes join a localhost gloo group, each runs its
    contiguous slice on the CPU, they meet at the barrier and rank 0
    merges: byte-equal to the single-process run."""
    from finito_tpu_torch.parallel import distributed as dist
    from finito_tpu_torch.query.engine import DeviceQueryEngine

    index, _, reads, prefix = _index(tmp_path, 99, 12)
    qpath = tmp_path / "reads.txt"
    qpath.write_bytes(b"".join(r + b"\n" for r in reads))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out_multi = str(tmp_path / "multi.txt")
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(pid), "2",
                               str(port), prefix, str(qpath), out_multi],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=REPO)
             for pid in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]
    assert b"rank0: merged" in outs[0][0]

    out_single = str(tmp_path / "single.txt")
    dist.run_distributed_queries(DeviceQueryEngine(index, device="cpu"), reads, out_single, 0, 1)
    got = open(out_multi, "rb").read()
    assert got == open(out_single, "rb").read()
    assert got.count(b"\n") == len(reads)


def _worker(argv) -> int:
    import torch
    import torch.distributed as tdist

    from finito_tpu_torch.index.index import FinimizerIndex
    from finito_tpu_torch.parallel import distributed as dist
    from finito_tpu_torch.query.engine import DeviceQueryEngine

    pid, nproc, port, prefix, qpath, out = argv
    pid, nproc = int(pid), int(nproc)
    torch.set_num_threads(1)
    assert dist.init_distributed(f"localhost:{port}", nproc, pid) == (pid, nproc)
    assert tdist.get_backend() == "gloo"
    with open(qpath, "rb") as f:
        reads = f.read().splitlines()
    engine = DeviceQueryEngine(FinimizerIndex.load(prefix), device="cpu")
    dist.run_distributed_queries(engine, reads, out, pid, nproc, barrier=True)
    # after the merged barrier the final file exists for every rank
    assert os.path.exists(out)
    if pid == 0:
        sys.stdout.write("rank0: merged\n")
    tdist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1:]))
