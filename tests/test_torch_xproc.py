"""The port's mesh layer across OS processes (finito_tpu_torch/parallel/
{distributed,mesh,shard_build}.py over torch.distributed): two processes
x 2 CPU shards each, joined by a gloo group on localhost, form one
4-shard mesh, each process holding only its own shards. Every output is
held exactly (integers, tolerance 0) to the host oracle and builders, to
the port's one-process mesh and to the JAX package (its functions on 4
of tests/conftest.py's virtual CPU devices), as the JAX package's own
2-process workers (tests/distributed_tp_worker.py,
tests/distributed_build_worker.py) hold it:

  (a) sharded_minimizer_locate_fn on (1, 4), tp across the processes,
      and (2, 2), dp across them, at k = 8 (the JAX worker's 30 unitigs)
      and k = 33 (two-word keys);
  (b) sharded_locate_fn on (1, 4), over ShardedIndex.build of the
      cross-process index build;
  (c) sharded_sbwt_build and sharded_index_build (the JAX worker's
      3,000 bp genome at k = 9, and k = 33), also with 3 + 1 shards a
      process; each rank packs only its own shards, and the index files
      are byte-identical to the host build's;
  (d) a forced overflow retry (slack = 0.02) that every rank takes
      together;
  (e) sharded_lcs_fn;
  (f) no fallback: backend nccl with two ranks on one card raises.

This file is also the worker, which imports nothing of JAX, of
finito_tpu or of bench (the workers run with them blocked):

    python tests/test_torch_xproc.py xproc PID NPROC PORT OUTDIR
    python tests/test_torch_xproc.py nccl-shared PID NPROC PORT OUTDIR

makes its inputs from the seeds below, runs every case and writes
OUTDIR/rank<PID>.npz and OUTDIR/r<PID>_<build>.* (the serialized indexes)."""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPROC = 2
WORKER_TIMEOUT = 240  # seconds a worker may take; gloo's own timeout is below it
GLOO_TIMEOUT = 90
# (a): k -> (seed, unitigs, min len, max len, B, L); k = 8 is the JAX tp worker's
LOCATES = {8: (123, 30, 20, 60, 16, 40), 33: (133, 30, 40, 90, 16, 60)}
MESHES = ((1, 4), (2, 2))
# (c): k -> (seed, genome bp, min cut, max cut); k = 9 is the JAX build worker's
BUILDS = {9: (321, 3000, 60, 200), 33: (333, 3000, 80, 240)}
INDEX_FILES = (".O.sdsl", ".FBV.sdsl", ".packed_unitigs.sdsl", ".unitig_endpoints.sdsl",
               ".Ustart.sdsl", ".LCS.sdsl", ".sbwt")
FOREIGN = ("finito_tpu", "jax", "jaxlib", "bench")
# runs the worker file with the foreign modules blocked: any import of them raises
BLOCKED_RUN = ("import runpy, sys\n"
               f"for name in {FOREIGN!r}:\n"
               "    sys.modules[name] = None\n"
               "sys.argv = sys.argv[1:]\n"
               "runpy.run_path(sys.argv[0], run_name='__main__')\n")


# ------------------------------------------------------------ inputs (numpy)


def gen_dspss(rng, n_unitigs, min_len, max_len, k):
    """tests/test_device_engine.py's gen_dspss: random unitigs whose
    k-mers are globally distinct (the same strings for one seed)."""
    seen, unitigs, tries = set(), [], 0
    while len(unitigs) < n_unitigs and tries < 10000:
        tries += 1
        L = int(rng.integers(min_len, max_len + 1))
        s = "".join(rng.choice(list("ACGT"), L))
        kmers = {s[i : i + k] for i in range(L - k + 1)}
        if len(kmers) != L - k + 1 or kmers & seen:
            continue
        seen |= kmers
        unitigs.append(s)
    assert len(unitigs) == n_unitigs
    return unitigs


def locate_case(k):
    """(unitigs, rng) of locate case k; the rng then draws the reads."""
    seed, n, lo, hi, _, _ = LOCATES[k]
    rng = np.random.default_rng(seed)
    return gen_dspss(rng, n, lo, hi, k), rng


def locate_reads(rng, concat, k):
    """The JAX tp worker's reads: even rows from the (permuted) unitig
    text, which may straddle unitig ends, odd rows random."""
    _, _, _, _, B, L = LOCATES[k]
    reads = np.zeros((B, L), np.uint8)
    for b in range(B):
        if b % 2 == 0 and concat.size > L:
            a = int(rng.integers(0, concat.size - L))
            reads[b] = concat[a : a + L]
        else:
            reads[b] = rng.integers(0, 4, size=L)
    return reads


def build_case(k):
    """The JAX build worker's input: a random genome cut into pieces
    overlapping by k - 1, as strings."""
    seed, n, lo, hi = BUILDS[k]
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=n, dtype=np.uint8)
    cuts = [0]
    while cuts[-1] < genome.size - k:
        cuts.append(min(genome.size - k + 1, cuts[-1] + int(rng.integers(lo, hi))))
    return ["".join("ACGT"[c] for c in genome[a : b + k - 1]) for a, b in zip(cuts[:-1], cuts[1:])]


def host_index(unitigs, k):
    """The port's host build-fmin path: (SBWT, node keys, index)."""
    from finito_tpu_torch.index.builder import FinimizerIndexBuilder
    from finito_tpu_torch.io.seqdb import SeqDB
    from finito_tpu_torch.sbwt.construct import build_plain_matrix_sbwt
    from finito_tpu_torch.sbwt.lcs import lcs_array

    seqs = [u.encode() for u in unitigs]
    sb, keys = build_plain_matrix_sbwt(seqs, k, return_keys=True)
    index = FinimizerIndexBuilder(sb, lcs_array(sb), SeqDB.from_sequences(seqs),
                                  node_keys=keys).get_index()
    return sb, keys, index


def text(index):
    return np.asarray(index.unitigs.concat, np.uint8), np.asarray(index.unitigs.ends, np.int64)


# ------------------------------------------------------------------ worker


def _worker(mode, pid, nproc, port, out) -> int:
    import torch

    from finito_tpu_torch.parallel import distributed as dist
    from finito_tpu_torch.parallel import mesh as pm
    from finito_tpu_torch.parallel import shard_build as sb
    from finito_tpu_torch.utils import trace

    torch.set_num_threads(1)
    backend = "nccl" if mode == "nccl-shared" else "gloo"
    assert dist.init_distributed(f"localhost:{port}", nproc, pid, backend=backend,
                                 timeout=GLOO_TIMEOUT) == (pid, nproc)
    if mode == "nccl-shared":
        try:
            dist.global_devices(["cuda:0"])
        except ValueError as e:
            print(f"rank{pid}: raised: {e}")
            return 0
        raise AssertionError("nccl with two ranks on one card did not raise")

    devs = dist.global_devices(["cpu"] * 2)
    res = {"owners": np.array(devs.owners), "process": np.array(
        [dist.process_index(), dist.process_count()])}

    # (a) the minimizer locate, tp and dp across the processes
    for k in LOCATES:
        unitigs, rng = locate_case(k)
        concat, ends = text(host_index(unitigs, k)[2])
        reads = locate_reads(rng, concat, k)
        W = reads.shape[1] - k + 1
        for dp, tp in MESHES:
            mesh = pm.make_mesh(4, tp=tp, devices=devs)
            sh = pm.ShardedMinimizerIndex.build(concat, ends, k, tp=tp)
            tables = pm.place_minimizer_shards(mesh, sh)
            placed = {id(t): t for t in tables.reshape(-1) if t is not None}
            fn = pm.sharded_minimizer_locate_fn(mesh, sh, K_slow=reads.shape[0] * W, tables=tables)
            r0 = trace.counts.get("host_reads.locate.trips", 0)
            uid, off, n_slow = fn(reads)
            n_reads = trace.counts.get("host_reads.locate.trips", 0) - r0
            key = f"loc{k}_{dp}x{tp}"
            res[key + "_uid"], res[key + "_off"] = uid.numpy(), off.numpy()
            res[key + "_n_slow"] = np.array(int(n_slow))
            res[key + "_rows"] = np.array([sum(t["text"].shape[0] for t in placed.values()),
                                           sh.text_arr.shape[0] * sh.text_arr.shape[1]])
            res[key + "_host_reads"] = np.array([n_reads, int((mesh.owners == pid).sum())])

    # (c) the builds; every block this rank packs is one of its shards
    calls = []
    real_put = sb._put_shard_blocks

    def counting(devs_, block_fn):
        def wrapped(s):
            calls.append(s)
            return block_fn(s)

        return real_put(devs_, wrapped)

    sb._put_shard_blocks = counting
    try:
        builds = [(f"b{k}", k, build_case(k), devs) for k in BUILDS]
        # 3 shards in rank 0 and 1 in rank 1: uneven blocks in every exchange
        builds.append(("b9u", 9, build_case(9), dist.global_devices(["cpu"] * (3 - 2 * pid))))
        for name, k, unitigs, d in builds:
            del calls[:]
            sbwt, keys = sb.sharded_sbwt_build(unitigs, k, devices=d, return_keys=True)
            index = sb.sharded_index_build(unitigs, k, devices=d)
            res[name + "_calls"] = np.array(sorted(set(calls)))
            res[name + "_local"] = np.array(d.local)
            res[name + "_bits"] = sbwt.bit_rows()
            res[name + "_keys"] = np.stack(keys)
            for f in ("fmin", "global_offsets", "LCS", "Ustart"):
                res[f"{name}_{f}"] = np.asarray(getattr(index, f))
            index.serialize(os.path.join(out, f"r{pid}_{name}"))
            if name == "b9":
                # (e) the LCS alone, and (b) the dense locate on this index
                res["lcs9"] = pm.sharded_lcs_fn(d, sbwt)
                res["stats"] = np.array([d.stats["collectives"], d.stats["staged_bytes"]])
    finally:
        sb._put_shard_blocks = real_put
    unitigs, rng = locate_case(8)
    index = sb.sharded_index_build(unitigs, 8, devices=devs)
    reads = locate_reads(rng, text(index)[0], 8)
    uid, off = pm.sharded_locate_fn(pm.make_mesh(4, tp=4, devices=devs),
                                    pm.ShardedIndex.build(index, tp=4))(reads)
    res["dense_uid"], res["dense_off"] = uid.numpy(), off.numpy()

    # (d) a forced overflow retry: every rank reads the same summed counts
    sums = []
    real_sum = sb._sum_all

    def recorded(devs_, n):
        sums.append(real_sum(devs_, n))
        return sums[-1]

    sb._sum_all = recorded
    try:
        unitigs = build_case(9)
        sbwt, keys = sb.sharded_sbwt_build(unitigs, 9, devices=devs, slack=0.02, return_keys=True)
        res["retry_sbwt_sums"] = np.array(sums)
        res["retry_bits"] = sbwt.bit_rows()
        del sums[:]
        from finito_tpu_torch.index.packed_strings import permute_unitigs
        from finito_tpu_torch.io.seqdb import SeqDB

        packed = permute_unitigs(sbwt, SeqDB.from_sequences([u.encode() for u in unitigs]))[0]
        fmin, goff, _ = sb.sharded_finimizer_select(sbwt, pm.sharded_lcs_fn(devs, sbwt), packed,
                                                    keys, devs, slack=0.02)
        res["retry_select_sums"] = np.array(sums)
        res["retry_fmin"], res["retry_goff"] = fmin, goff
    finally:
        sb._sum_all = real_sum

    foreign = [m for m in sys.modules if m.split(".")[0] in FOREIGN and sys.modules[m] is not None]
    assert not foreign, foreign
    np.savez(os.path.join(out, f"rank{pid}.npz"), **res)
    import torch.distributed as tdist

    tdist.destroy_process_group()
    print(f"rank{pid}: done")
    return 0


def launch_workers(out, mode="xproc", nproc=NPROC):
    """Start the worker processes with the foreign modules blocked;
    returns them (run_workers waits)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen([sys.executable, "-c", BLOCKED_RUN, os.path.abspath(__file__), mode,
                              str(pid), str(nproc), str(port), str(out)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=REPO)
            for pid in range(nproc)]


def wait_workers(procs):
    """Every worker's (stdout, stderr); a worker that fails or outlives
    WORKER_TIMEOUT fails the caller, and none is left running."""
    try:
        outs = [p.communicate(timeout=WORKER_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, (_so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank{pid} exit {p.returncode}:\n{se.decode()[-3000:]}"
    return [(so.decode(), se.decode()) for so, se in outs]


# ------------------------------------------------------------------- tests


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-process run's per-rank results, and the references computed
    meanwhile in this process: the host oracle and builders, the port's
    one-process mesh and the JAX package's functions on 4 virtual CPU
    devices."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual JAX CPU devices (tests/conftest.py)")
    from finito_tpu.index.builder import FinimizerIndexBuilder as JaxBuilder
    from finito_tpu.io.seqdb import SeqDB as JaxSeqDB
    from finito_tpu.parallel import mesh as jmesh
    from finito_tpu.parallel import shard_build as jsb
    from finito_tpu.sbwt.construct import build_plain_matrix_sbwt as jax_sbwt
    from finito_tpu.sbwt.lcs import lcs_array as jax_lcs
    from finito_tpu_torch.io.seqdb import decode_seq
    from finito_tpu_torch.ops.bitvec import DeviceSBWT
    from finito_tpu_torch.parallel import mesh as pm
    from finito_tpu_torch.parallel import shard_build as sb
    from finito_tpu_torch.query.locators import build_position_table

    out = tmp_path_factory.mktemp("xproc")
    procs = launch_workers(out)
    try:
        ref = {}
        cpu4 = ["cpu"] * 4
        for k in LOCATES:
            unitigs, rng = locate_case(k)
            _, _, index = host_index(unitigs, k)
            concat, ends = text(index)
            reads = locate_reads(rng, concat, k)
            ref[f"oracle{k}"] = np.array([index.search(decode_seq(r)).local_offsets for r in reads])
            K_slow = reads.shape[0] * (reads.shape[1] - k + 1)
            for dp, tp in MESHES:
                key = f"loc{k}_{dp}x{tp}"
                sh = pm.ShardedMinimizerIndex.build(concat, ends, k, tp=tp)
                u, o, n = pm.sharded_minimizer_locate_fn(pm.make_mesh(4, tp=tp, devices=cpu4),
                                                         sh, K_slow)(reads)
                ref[key + "_one"] = (u.numpy(), o.numpy(), int(n))
                jsh = jmesh.ShardedMinimizerIndex.build(concat, ends, k, tp=tp)
                ju, jo, jn = jmesh.sharded_minimizer_locate_fn(jmesh.make_mesh(4, tp=tp), jsh,
                                                               K_slow)(reads)
                ref[key + "_jax"] = (np.asarray(ju), np.asarray(jo), int(np.asarray(jn)))
            if k == 8:  # (b): the same index, the dense tables from its position table
                pos = build_position_table(DeviceSBWT.from_host(index.sbwt, "cpu"), concat, ends)
                u, o = pm.sharded_locate_fn(pm.make_mesh(4, tp=4, devices=cpu4),
                                            pm.ShardedIndex.from_index(index, pos, 4))(reads)
                ref["dense_one"] = (u.numpy(), o.numpy())
                jsbwt = jax_sbwt([u.encode() for u in unitigs], k)
                jidx = JaxBuilder(jsbwt, jax_lcs(jsbwt),
                                  JaxSeqDB.from_sequences([u.encode() for u in unitigs])).get_index()
                ju, jo = jmesh.sharded_locate_fn(
                    jmesh.make_mesh(4, tp=4),
                    jmesh.ShardedIndex.from_index(jidx, pos.numpy(), tp=4))(reads)
                ref["dense_jax"] = (np.asarray(ju), np.asarray(jo))
        for k in BUILDS:
            unitigs = build_case(k)
            sbwt, keys, index = host_index(unitigs, k)
            prefix = str(out / f"host_k{k}")
            index.serialize(prefix)
            ref[f"b{k}_host"] = (sbwt, keys, index, prefix)
        jidx = jsb.sharded_index_build(build_case(9), 9, n_devices=4)
        ref["b9_jax"] = jidx
        ranks = wait_workers(procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = [dict(np.load(out / f"rank{pid}.npz")) for pid in range(NPROC)]
    return {"ref": ref, "got": got, "out": out, "logs": ranks}


@pytest.mark.parametrize("k", sorted(LOCATES))
@pytest.mark.parametrize("dp,tp", MESHES)
def test_minimizer_locate_across_processes(runs, k, dp, tp):
    """(a) Every rank holds only its shards' text rows (tp across the
    processes: half of them; dp across them: one whole copy a rank),
    reads each local shard's trip count once, and gets every window,
    equal to the host oracle, the port's one-process mesh and JAX's."""
    key = f"loc{k}_{dp}x{tp}"
    ref = runs["ref"]
    for pid, got in enumerate(runs["got"]):
        local_rows, all_rows = got[key + "_rows"]
        assert local_rows * (NPROC if dp == 1 else 1) == all_rows, (pid, local_rows, all_rows)
        reads, local_shards = got[key + "_host_reads"]
        assert reads == local_shards == 2
        for u, o, n in (ref[key + "_one"], ref[key + "_jax"]):
            np.testing.assert_array_equal(got[key + "_uid"], u)
            np.testing.assert_array_equal(got[key + "_off"], o)
            assert int(got[key + "_n_slow"]) == n
        oracle = ref[f"oracle{k}"]
        np.testing.assert_array_equal(got[key + "_uid"], oracle[..., 0])
        np.testing.assert_array_equal(got[key + "_off"], oracle[..., 1])
    assert (ref[f"oracle{k}"][..., 0] >= 0).sum() > 0  # found windows are exercised


def test_dense_locate_across_processes(runs):
    """(b) sharded_locate_fn on (1, 4) over ShardedIndex.build of the
    cross-process index build equals the host oracle, the one-process
    mesh over from_index and JAX's."""
    ref = runs["ref"]
    for got in runs["got"]:
        for u, o in (ref["dense_one"], ref["dense_jax"]):
            np.testing.assert_array_equal(got["dense_uid"], u)
            np.testing.assert_array_equal(got["dense_off"], o)
        np.testing.assert_array_equal(got["dense_uid"], ref["oracle8"][..., 0])
        np.testing.assert_array_equal(got["dense_off"], ref["oracle8"][..., 1])


@pytest.mark.parametrize("name", ["b9", "b33", "b9u"])
def test_index_build_across_processes(runs, name):
    """(c) Each rank packs only its own shards; the SBWT's bit rows and
    node keys, fmin, global offsets, LCS and Ustart equal the host
    builders' (and JAX's one-process sharded_index_build at k = 9) on
    every rank, and the serialized files are byte-identical."""
    k = int(name[1:].rstrip("u"))
    sbwt, keys, index, prefix = runs["ref"][f"b{k}_host"]
    for pid, got in enumerate(runs["got"]):
        assert set(got[name + "_calls"].tolist()) <= set(got[name + "_local"].tolist())
        assert got[name + "_calls"].size > 0
        np.testing.assert_array_equal(got[name + "_bits"], sbwt.bit_rows())
        np.testing.assert_array_equal(got[name + "_keys"], np.stack(keys))
        for f in ("fmin", "global_offsets", "LCS", "Ustart"):
            np.testing.assert_array_equal(got[f"{name}_{f}"], np.asarray(getattr(index, f)))
            if k == 9:
                np.testing.assert_array_equal(got[f"{name}_{f}"],
                                              np.asarray(getattr(runs["ref"]["b9_jax"], f)))
        for suffix in INDEX_FILES:
            with open(runs["out"] / f"r{pid}_{name}{suffix}", "rb") as a, \
                    open(prefix + suffix, "rb") as b:
                assert a.read() == b.read(), (pid, suffix)
    if name == "b9u":  # 3 shards in rank 0, 1 in rank 1
        assert [g["b9u_local"].tolist() for g in runs["got"]] == [[0, 1, 2], [3]]


def test_forced_retry_across_processes(runs):
    """(d) slack = 0.02: the SBWT build and the finimizer selection
    overflow and retry, every rank reading the same summed counts (so
    taking the same branches), and still equal the host build."""
    sbwt, _, index, _ = runs["ref"]["b9_host"]
    g0, g1 = runs["got"]
    for name in ("retry_sbwt_sums", "retry_select_sums"):
        np.testing.assert_array_equal(g0[name], g1[name])
    assert (g0["retry_sbwt_sums"] > 0).sum() >= 3
    assert (g0["retry_select_sums"] > 0).sum() >= 1
    fmin = np.asarray(index.fmin)
    for got in runs["got"]:
        np.testing.assert_array_equal(got["retry_bits"], sbwt.bit_rows())
        np.testing.assert_array_equal(got["retry_fmin"], fmin)
        np.testing.assert_array_equal(got["retry_goff"][fmin == 1], index.global_offsets)


def test_lcs_across_processes(runs):
    """(e) sharded_lcs_fn over the 2-process mesh equals lcs_array."""
    from finito_tpu_torch.sbwt.lcs import lcs_array

    want = lcs_array(runs["ref"]["b9_host"][0])
    for got in runs["got"]:
        assert got["lcs9"].dtype == np.int64
        np.testing.assert_array_equal(got["lcs9"], want)


def test_global_device_view(runs):
    """The global device list in rank order (process 0's devices first),
    jax.process_index/process_count twins, and the collectives counted;
    CPU shards stage no bytes."""
    for pid, got in enumerate(runs["got"]):
        assert got["owners"].tolist() == [0, 0, 1, 1]
        assert got["process"].tolist() == [pid, NPROC]
        collectives, staged = got["stats"].tolist()
        assert collectives > 0 and staged == 0
    assert all(f"rank{pid}: done" in so for pid, (so, _) in enumerate(runs["logs"]))


def test_nccl_refuses_a_shared_card():
    """(f) nccl moves CUDA tensors card to card: a CPU device, or one
    card held by two ranks, raises; gloo takes both."""
    from finito_tpu_torch.parallel.distributed import check_backend, init_distributed

    shared = [[("cuda:0", "cuda GPU-1")], [("cuda:0", "cuda GPU-1")]]
    with pytest.raises(ValueError, match="one card a rank"):
        check_backend("nccl", shared)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        check_backend("nccl", [[("cpu", "cpu")], [("cpu", "cpu")]])
    check_backend("nccl", [[("cuda:0", "cuda GPU-1")], [("cuda:0", "cuda GPU-2")]])
    check_backend("gloo", shared)
    with pytest.raises(ValueError, match="backend must be one of"):
        init_distributed("localhost:1", 2, 0, backend="mpi")


@pytest.mark.cuda
def test_nccl_two_ranks_on_one_card_raise(tmp_path):
    """(f) on the card: two processes of an nccl group, both on cuda:0,
    raise in global_devices with a plain message."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    logs = wait_workers(launch_workers(tmp_path, mode="nccl-shared"))
    for pid, (so, _) in enumerate(logs):
        assert f"rank{pid}: raised: backend nccl needs one card a rank" in so


def test_one_process_calls_no_distributed(monkeypatch):
    """Without a process group the mesh layer never calls
    torch.distributed: the mesh build, the LCS and both locates on 4
    CPU shards run with every collective replaced by a failure."""
    import torch.distributed as tdist

    from finito_tpu_torch.io.seqdb import decode_seq
    from finito_tpu_torch.parallel import distributed as dist
    from finito_tpu_torch.parallel import mesh as pm
    from finito_tpu_torch.parallel import shard_build as sb

    assert not tdist.is_initialized()

    def refuse(*_a, **_k):
        raise AssertionError("torch.distributed called in one process")

    for name in ("all_reduce", "all_gather", "all_gather_object", "all_to_all_single",
                 "new_group", "get_rank", "get_world_size", "get_backend", "barrier"):
        monkeypatch.setattr(tdist, name, refuse)
    devs = dist.global_devices(["cpu"] * 4)
    assert devs.owners == [0] * 4 and not devs.spans and devs.backend is None
    assert (dist.process_index(), dist.process_count()) == (0, 1)
    unitigs, rng = locate_case(8)
    _, _, host = host_index(unitigs, 8)
    index = sb.sharded_index_build(unitigs, 8, devices=devs)
    np.testing.assert_array_equal(index.fmin, host.fmin)
    np.testing.assert_array_equal(pm.sharded_lcs_fn(devs, index.sbwt), host.LCS)
    concat, ends = text(host)
    reads = locate_reads(rng, concat, 8)
    want = np.array([host.search(decode_seq(r)).local_offsets for r in reads])
    mesh = pm.make_mesh(4, tp=2, devices=devs)
    u, o, _ = pm.sharded_minimizer_locate_fn(mesh, pm.ShardedMinimizerIndex.build(
        concat, ends, 8, tp=2))(reads)
    np.testing.assert_array_equal(np.stack([u.numpy(), o.numpy()], -1), want)
    u, o = pm.sharded_locate_fn(mesh, pm.ShardedIndex.build(index, tp=2))(reads)
    np.testing.assert_array_equal(np.stack([u.numpy(), o.numpy()], -1), want)
    assert devs.stats == {"collectives": 0, "staged_bytes": 0}


if __name__ == "__main__":
    mode, pid, nproc, port, out = sys.argv[1:]
    sys.exit(_worker(mode, int(pid), int(nproc), port, out))
