"""The port's tooling (finito_tpu_torch/tools/ and the bench data helpers
in utils/synth.py) on the CPU against the JAX package's scripts and
bench.py: the same DSPSS genome, unitigs and cuts for one seed; the same
cached index files and arrays, built and then loaded, for both
workloads; genome_scale_verify and pangenome_verify (with and without
--mesh-build, and with --spss simplitigs) printing ok and every field of
the JAX script's JSON other than its timings, at the sizes
tests/test_scale_verify.py uses, on 8 CPU shards; micro, h_sweep and
lane_sweep at tiny sizes, with their keys and row counts; and --device
resolution, which never falls back to the host. Every comparison is
exact."""

from __future__ import annotations

import json
import os
import re
import runpy
import sys

import numpy as np
import pytest
import torch

import bench
from finito_tpu_torch.index.index import FinimizerIndex as PortFinimizerIndex
from finito_tpu_torch.parallel.shard_build import shard_devices
from finito_tpu_torch.tools import build_cache, genome_scale_verify, h_sweep, lane_sweep, micro
from finito_tpu_torch.tools import pangenome_verify
from finito_tpu_torch.tools.cache import load_or_build_index
from finito_tpu_torch.utils import synth

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX's --mesh-build run prints its host build's fields (its unitigs are
# the host build's, held by tests/test_shard_dbg.py) and takes ~50 s here,
# so the port's --mesh-build run is held to JAX's host-build JSON
JAX_ARGS_OF = {"unitigs": [], "mesh-build": [], "simplitigs": ["--spss", "simplitigs"]}
PORT_ARGS_OF = {"unitigs": [], "mesh-build": ["--mesh-build"],
                "simplitigs": ["--spss", "simplitigs"]}
SCALE_ARGS = ["--genome", "2000000", "--k", "63", "--tp", "8", "--reads", "48",
              "--read-len", "191"]
PAN_ARGS = ["--base", "200000", "--variants", "5", "--k", "31", "--reads", "48", "--tp", "8"]
JAX_TIMINGS = {"build_s", "unitig_s", "index_s"}


def _last_json(text: str):
    return json.loads(text.strip().splitlines()[-1])


def _jax_script(script: str, args, monkeypatch, capsys) -> dict:
    """A JAX script run in this process (JAX is on its 8 virtual CPU
    devices, tests/conftest.py); its last stdout line."""
    monkeypatch.setattr(sys, "argv", [script, *args])
    with pytest.raises(SystemExit) as e:
        runpy.run_path(os.path.join(ROOT, "scripts", script), run_name="__main__")
    assert e.value.code == 0
    return _last_json(capsys.readouterr().out)


def _port_tool(module, args, capsys):
    rc = module.main(args)
    return rc, capsys.readouterr().out


def _equal_but_timings(got: dict, want: dict):
    assert got["ok"] is True and want["ok"] is True
    for key in set(want) - JAX_TIMINGS:
        assert got[key] == want[key], key


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("k", [15, 31])
def test_gen_dspss_and_cuts_equal_bench(seed, k):
    g1, u1, c1 = synth.gen_dspss(np.random.default_rng(seed), 30_000, k, return_cuts=True)
    g2, u2, c2 = bench.gen_dspss(np.random.default_rng(seed), 30_000, k, return_cuts=True)
    assert np.array_equal(g1, g2) and u1 == u2 and np.array_equal(c1, c2)
    g3, u3 = synth.gen_dspss(np.random.default_rng(seed), 30_000, k, mean_unitig=300)
    g4, u4 = bench.gen_dspss(np.random.default_rng(seed), 30_000, k, mean_unitig=300)
    assert np.array_equal(g3, g4) and u3 == u4 and all(isinstance(u, bytes) for u in u3)
    r1, r2 = np.random.default_rng(seed + 1), np.random.default_rng(seed + 1)
    assert np.array_equal(synth.draw_cuts(r1, 50_000, k, 500), bench.draw_cuts(r2, 50_000, k, 500))
    assert synth.REPEAT_PARAMS == bench.REPEAT_PARAMS


def _index_arrays(index):
    return [index.sbwt.bit_rows(), index.LCS, index.fmin, index.global_offsets, index.Ustart,
            np.asarray(index.unitigs.concat), np.asarray(index.unitigs.ends)]


@pytest.mark.parametrize("workload,genome_len", [("uniform", 40_000), ("repeat", 60_000)])
def test_load_or_build_index_equals_bench(tmp_path, workload, genome_len):
    """A build into the port's cache, then a load from it, against
    bench.load_or_build_index's build: the same genome, cuts and index
    arrays, and byte-identical cache files."""
    k = 31
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    g1, idx1, _, cuts1 = load_or_build_index(genome_len, k, str(mine), np.random.default_rng(0),
                                             workload=workload)
    g2, idx2, _, cuts2 = bench.load_or_build_index(genome_len, k, str(theirs),
                                                   np.random.default_rng(0), workload=workload)
    assert np.array_equal(g1, g2)
    assert (cuts1 is None) == (cuts2 is None) == (workload == "repeat")
    if cuts1 is not None:
        assert np.array_equal(cuts1, cuts2)
    for a, b in zip(_index_arrays(idx1), _index_arrays(idx2)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs))
    for name in os.listdir(mine):
        assert (mine / name).read_bytes() == (theirs / name).read_bytes(), name
    g3, idx3, _, cuts3 = load_or_build_index(genome_len, k, str(mine), np.random.default_rng(0),
                                             workload=workload)
    assert isinstance(idx3, PortFinimizerIndex) and np.array_equal(g3, g1)
    assert (cuts3 is None) == (workload == "repeat")
    if cuts3 is not None:
        assert np.array_equal(cuts3, cuts1)
    for a, b in zip(_index_arrays(idx3), _index_arrays(idx1)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    # another rng stream cannot replay the genome: no analytic cuts
    if workload == "uniform":
        assert load_or_build_index(genome_len, k, str(mine), np.random.default_rng(1))[3] is None


def test_genome_scale_verify_equals_jax(monkeypatch, capsys):
    rc, out = _port_tool(genome_scale_verify, SCALE_ARGS + ["--device", "cpu"], capsys)
    got = _last_json(out)
    assert rc == 0 and got["verified_windows"] > 0 and got["shards_answering"] == 8
    assert got["host_peak_rss_mib"] > 0 and got["peak_device_mib"] is None
    _equal_but_timings(got, _jax_script("genome_scale_verify.py", SCALE_ARGS, monkeypatch, capsys))


@pytest.fixture(scope="module")
def jax_pangenome():
    return {}


@pytest.mark.parametrize("variant", ["unitigs", "mesh-build", "simplitigs"])
def test_pangenome_verify_equals_jax(variant, jax_pangenome, monkeypatch, capsys):
    rc, out = _port_tool(pangenome_verify, PAN_ARGS + PORT_ARGS_OF[variant] + ["--device", "cpu"],
                         capsys)
    got = _last_json(out)
    assert rc == 0 and got["verified_windows"] > 0
    assert got["mesh_build"] == (variant == "mesh-build")
    key = tuple(JAX_ARGS_OF[variant])
    if key not in jax_pangenome:
        jax_pangenome[key] = _jax_script("pangenome_verify.py", PAN_ARGS + list(key),
                                         monkeypatch, capsys)
    _equal_but_timings(got, jax_pangenome[key])


def test_micro_rows(capsys, monkeypatch):
    """micro's rows at tiny sizes (its main fixes bench_micro's B, lanes
    and steps, so run() takes them here)."""
    run = micro.run
    monkeypatch.setattr(micro, "run", lambda dev, n_log2: run(
        dev, n_log2, b_log2=8, lanes_log2=(6, 7), steps=40, reps=2, trials=1))
    rc, out = _port_tool(micro, ["--device", "cpu", "--n-log2", "10"], capsys)
    rows = [json.loads(line) for line in out.strip().splitlines()]
    assert rc == 0
    assert [r["metric"] for r in rows] == [
        "hbm_gather_scalar", "hbm_gather_row4", "sbwt_interval_extension",
        "chain_scan_us_per_step_0k_lanes", "chain_scan_us_per_step_0k_lanes"]
    assert [r["unit"] for r in rows] == ["Mlookups/sec"] * 2 + ["Mext/sec"] + ["us/step"] * 2
    assert [r.get("lanes") for r in rows[3:]] == [64, 128]
    assert all(r["value"] > 0 and r["device"] == "cpu" and r["n_log2"] == 10 for r in rows)
    assert rows[0]["table_bytes"] == 4 << 10 and rows[1]["table_bytes"] == 16 << 10
    assert rows[1]["gather_only"] > 0 and rows[1]["index_select"] > 0
    # device times come from the card only
    assert rows[0]["device_us"] is None and rows[1]["gather_only_device_us"] is None
    assert all(r["batch"] == 256 and r["reps"] == 2 for r in rows)


def test_h_sweep_rows(tmp_path, capsys):
    cache = str(tmp_path)
    assert build_cache.main(["--genome", "50000", "--cache-dir", cache]) == 0
    assert sorted(os.listdir(cache))[-1] == "midx_g50000_k31.ftmidx"
    capsys.readouterr()
    rc, out = _port_tool(h_sweep, ["--genome", "50000", "--hs", "14,12", "--engines", "v1,v2",
                                   "--batch", "32", "--reps", "1", "--trials", "1",
                                   "--cache-dir", cache, "--device", "cpu"], capsys)
    rows = _last_json(out)
    assert rc == 0
    assert [(r["h"], r["engine"]) for r in rows] == [(12, "v1"), (12, "v2"), (14, "v1"), (14, "v2")]
    keys = {"h", "engine", "qps", "slow_frac", "K", "KH", "desc_mb", "slot_rows_mb",
            "device_init_s", "peak_device_mib", "host_peak_rss_mib"}
    assert all(set(r) == keys and r["qps"] > 0 and 0 <= r["slow_frac"] <= 1 for r in rows)
    # a smaller table puts more windows on the slow path
    assert rows[0]["slow_frac"] >= rows[2]["slow_frac"]


def test_lane_sweep_rows(tmp_path, capsys, monkeypatch):
    cache, out_path = str(tmp_path / "cache"), str(tmp_path / "lanes.json")
    args = ["--genome", "40000", "--batches", "16,32", "--chunks", "0,auto,40", "--reps", "1",
            "--trials", "1", "--cache-dir", cache, "--device", "cpu"]
    rc, out = _port_tool(lane_sweep, args + ["--out", out_path], capsys)
    art = _last_json(out)
    assert rc == 0 and json.load(open(out_path)) == art
    assert len(art["rows"]) == 2 * 2 * 3
    assert [(r["engine"], r["B"], r["chunk"]) for r in art["rows"][:3]] == [
        ("stream", 16, "0"), ("stream", 16, "auto"), ("stream", 16, "40")]
    assert all(r["n_unknown"] <= r["K"] and r["qps"] > 0 for r in art["rows"])
    assert art["device"] == "cpu" and art["genome"] == 40000 and art["host_peak_rss_mib"] > 0
    # the default artifact sits under build/, never on the JAX record
    assert lane_sweep.DEFAULT_OUT != lane_sweep.JAX_RECORD
    assert lane_sweep.DEFAULT_OUT.startswith(os.path.join(ROOT, "build") + os.sep)
    with pytest.raises(ValueError, match="JAX package's sweep record"):
        lane_sweep.main(args + ["--out", os.path.join(ROOT, "SWEEP_lanes.json")])


def test_devices_never_fall_back(monkeypatch):
    """One rule maps --device to a mesh's shard devices
    (shard_build.shard_devices, which the tools, the CLI's --mesh and
    the engine's mesh share); a card asked for and missing raises."""
    assert shard_devices("cpu", 3) == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            shard_devices(name, 2)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            micro.main(["--device", name])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert shard_devices("cuda:0", 3) == [torch.device("cuda", 0)] * 3
    assert shard_devices("cuda", 2) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(RuntimeError, match=re.escape("needs 8 devices, found 2 card(s)")):
        shard_devices("cuda", 8)
    # a build whose output does not depend on the shard count takes fewer
    assert shard_devices("cuda", 8, fewer_ok=True) == shard_devices("cuda", 2)
    with pytest.raises(RuntimeError, match="'cuda:2': 2 CUDA device"):
        shard_devices("cuda:2", 8)
