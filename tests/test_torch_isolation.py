"""The port shares no code with the JAX package: with finito_tpu, jax,
jaxlib and bench.py blocked, every module of finito_tpu_torch imports,
and the whole tiny pipeline runs through ``python -m
finito_tpu_torch.cli`` on the CPU, each command with exit code 0
(search-fmin with the minimizer and the stream engine, byte-identical;
unitigs --mesh 2 and the mesh index build on 2 CPU shards, byte-identical
to the host builds); then the repeat-dense workload, the device-resident
pipeline of every engine mode and the in-scan replica twin, against the
index-free oracle; then the entry step, tools.micro,
tools.genome_scale_verify and one tools.bench rung at tiny sizes (every
tools module and the
entry module import). The cross-process mesh's workers
(tests/test_torch_xproc.py: 2 processes in a gloo group, every locate,
build and LCS case) run with the same modules blocked."""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKED = textwrap.dedent("""
    import sys

    FOREIGN = ("finito_tpu", "jax", "jaxlib", "bench")
    for name in FOREIGN:
        sys.modules[name] = None  # any import of them raises ImportError

    import importlib
    import pkgutil
    import runpy

    import numpy as np

    import finito_tpu_torch

    names = [m.name for m in pkgutil.walk_packages(finito_tpu_torch.__path__, "finito_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    print("imported", len(names), "modules")
    tools = {"cache", "build_cache", "micro", "h_sweep", "lane_sweep", "genome_scale_verify",
             "pangenome_verify", "bench"}
    assert {"finito_tpu_torch.entry"} | {"finito_tpu_torch.tools." + t for t in tools} <= set(names)

    tmp, = sys.argv[1:]

    def cli(*argv):
        sys.argv = ["finito_tpu_torch.cli", *argv]
        try:
            runpy.run_module("finito_tpu_torch.cli", run_name="__main__", alter_sys=True)
            code = None
        except SystemExit as e:
            code = e.code
        assert code in (0, None), (argv, code)

    rng = np.random.default_rng(0)
    genome = "".join(rng.choice(list("ACGT"), 1500))
    reads = [genome[s : s + 80] for s in rng.integers(0, len(genome) - 80, 30)]
    reads += ["ACGTNACGTACGTAC", "ACG"]
    with open(tmp + "/reads.fna", "w") as f:
        f.writelines(f">r{i}\\n{r}\\n" for i, r in enumerate(reads))
    p = lambda name: tmp + "/" + name
    cli("unitigs", "-k", "11", "-i", p("reads.fna"), "-o", p("u.fna"))
    cli("unitigs", "-k", "11", "-i", p("reads.fna"), "-o", p("um.fna"), "--mesh", "2",
        "--device", "cpu")
    cli("flip-unitigs", "-k", "11", "-i", p("u.fna"), "-o", p("f.fna"))
    cli("sbwt-build", "-k", "11", "-i", p("f.fna"), "-o", p("x.sbwt"))
    cli("convert-sbwt", "-i", p("x.sbwt"), "-o", p("a.sbwt"), "--to", "algbio")
    cli("convert-sbwt", "-i", p("a.sbwt"), "-o", p("b.sbwt"), "--to", "finito")
    cli("build-fmin", "-i", p("x.sbwt"), "-u", p("f.fna"), "-o", p("idx"))
    cli("search-fmin", "-i", p("idx"), "-q", p("reads.fna"), "-o", p("out.txt"), "--device", "cpu")
    cli("search-fmin", "-i", p("idx"), "-q", p("reads.fna"), "-o", p("stream.txt"),
        "--engine", "stream", "--device", "cpu")
    cli("search-fmin", "-i", p("idx"), "-q", p("reads.fna"), "-o", p("mesh.txt"),
        "--device", "cpu", "--mesh", "2,2")
    cli("kmer-mapper", "build", "-u", p("f.fna"), "-k", "11", "-o", p("km"))
    cli("kmer-mapper", "query", "-i", p("km"), "-q", p("reads.fna"), "-r", "-o", p("km.txt"),
        "--device", "cpu")
    cli("kmer-mapper", "query", "-i", p("km"), "-q", p("reads.fna"), "-r", "--host-exact",
        "-o", p("kmh.txt"))
    cli("kmer-mapper", "extract-index-unitigs", "-i", p("km"), "-o", p("ex.fna"))

    out = open(p("out.txt")).read().splitlines()
    assert len(out) == len(reads) and out[-1] == "" and "(-1,-1)" not in out[0], out[:2]
    assert open(p("stream.txt"), "rb").read() == open(p("out.txt"), "rb").read()
    assert open(p("mesh.txt"), "rb").read() == open(p("out.txt"), "rb").read()
    assert open(p("km.txt")).read() == open(p("kmh.txt")).read()
    assert open(p("b.sbwt"), "rb").read() == open(p("x.sbwt"), "rb").read()
    assert open(p("um.fna"), "rb").read() == open(p("u.fna"), "rb").read()
    # the mesh index build, on 2 CPU shards, writes build-fmin's files
    from finito_tpu_torch.io.fastx import read_all_records
    from finito_tpu_torch.parallel.shard_build import sharded_index_build

    seqs = [bytes(s) for _h, s in read_all_records(p("f.fna"))]
    sharded_index_build(seqs, 11, devices=["cpu"] * 2).serialize(p("midx"))
    for suffix in (".O.sdsl", ".FBV.sdsl", ".LCS.sdsl", ".sbwt", ".Ustart.sdsl"):
        assert open(p("midx") + suffix, "rb").read() == open(p("idx") + suffix, "rb").read(), suffix
    # the repeat workload, the device-resident pipeline of every mode and
    # the in-scan replica twin, each held to the index-free oracle
    import torch

    from finito_tpu_torch.dbg import build_unitigs
    from finito_tpu_torch.index.builder import FinimizerIndexBuilder
    from finito_tpu_torch.io.seqdb import SeqDB, decode_seq
    from finito_tpu_torch.query.engine import DeviceQueryEngine
    from finito_tpu_torch.query.replica import make_replica_locate
    from finito_tpu_torch.sbwt.construct import build_plain_matrix_sbwt
    from finito_tpu_torch.sbwt.lcs import lcs_array
    from finito_tpu_torch.utils.synth import gen_repeat_genome, kmer_location_oracle

    g = gen_repeat_genome(rng, 60_000)
    useqs = [decode_seq(u) for u in build_unitigs([g], 15, canonical=False)]
    sb = build_plain_matrix_sbwt(useqs, 15)
    rindex = FinimizerIndexBuilder(sb, lcs_array(sb), SeqDB.from_sequences(useqs),
                                   device="cpu").get_index()
    rreads = g[rng.integers(0, g.size - 64, 16)[:, None] + np.arange(64)]
    want = kmer_location_oracle(rindex.unitigs.concat, rindex.unitigs.ends, rreads, 15)
    for mode in ("minimizer", "dense", "stream", "replica"):
        pipe = DeviceQueryEngine(rindex, mode=mode, device="cpu").make_device_pipeline(16, 64)
        out = pipe(torch.from_numpy(rreads))
        assert np.array_equal(out[0].numpy(), want[0]) and np.array_equal(out[1].numpy(), want[1])
    twin = make_replica_locate(rindex, device="cpu")(rreads)
    assert np.array_equal(twin[0].numpy(), want[0]) and np.array_equal(twin[1].numpy(), want[1])
    # the tooling and the entry step, at tiny sizes
    import contextlib
    import io

    from finito_tpu_torch.entry import entry
    from finito_tpu_torch.tools import genome_scale_verify, micro

    fn, ex = entry(device="cpu")
    assert (fn(*ex)[0] >= 0).any()
    rows = micro.run(torch.device("cpu"), 10, b_log2=8, lanes_log2=(6,), steps=40, reps=1,
                     trials=1)
    assert rows[-1]["metric"] == "chain_scan_us_per_step_0k_lanes"
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert genome_scale_verify.main(["--genome", "300000", "--tp", "4", "--reads", "16",
                                         "--device", "cpu"]) == 0
    assert '"ok": true' in out.getvalue()
    from finito_tpu_torch.tools import bench

    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert bench.main(["--device", "cpu", "--genome", "20000", "--ladder", "off",
                           "--extra-rows", "", "--batch", "16", "--read-len", "64", "--reps", "1",
                           "--trials", "1", "--cache-dir", tmp + "/bench_cache"]) == 0
    assert '"ladder": [{"genome": 20000' in out.getvalue()
    foreign = [m for m in sys.modules if m.split(".")[0] in FOREIGN and sys.modules[m] is not None]
    assert not foreign, foreign
    print("ISOLATED OK")
""")


def test_port_runs_with_jax_package_blocked(tmp_path):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-c", BLOCKED, str(tmp_path)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "ISOLATED OK" in r.stdout


def test_cross_process_workers_with_jax_package_blocked(tmp_path):
    from test_torch_xproc import launch_workers, wait_workers

    logs = wait_workers(launch_workers(tmp_path))
    for pid, (so, _) in enumerate(logs):
        assert f"rank{pid}: done" in so
