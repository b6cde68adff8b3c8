"""The port's ladder, finito_tpu_torch/tools/bench.py, on the CPU against
bench.py: run_rung in-process against JAX's bench.run_rung for the same
arguments and rng(0), every row field but the times exactly equal, for
the minimizer engine (v1, also with FINITO_MINIMIZER_V2=1 set, and v2
forced in both packages), dense, stream and the repeat workload; _emit's
line against JAX's, with and without
an error; main's ladder choices (auto over a cache built by
tools.build_cache, off, an explicit list), its extra rows, its rung
isolation and its k63 skip; the stall watchdog in a subprocess; and the
refusal of --device cuda without a card. JAX's bench.main is not called:
it writes a compilation cache into the repository."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import bench
from finito_tpu_torch.tools import bench as pbench
from finito_tpu_torch.tools import build_cache

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMINGS = {"qps", "vs_baseline", "build_or_load_s"}
ROW_FIELDS = {"genome", "k", "qps", "vs_baseline", "found_frac", "oracle_verified_reads",
              "analytic_verified_windows", "verified_windows", "n_nodes", "build_or_load_s",
              "engine", "workload", "slow_frac"}
GENOME = 20_000


def _args(engine="minimizer", k=31, **kw):
    a = dict(k=k, batch=32, read_len=64, reps=1, trials=1, profile=None, mutate=0.005,
             engine=engine, chunk=None, cache_dir=None, verify=8)
    a.update(kw)
    return argparse.Namespace(**a)


# replica is left out: JAX's replica pipeline does not finish compiling on
# the CPU within the test's time (its row is run by the port in test_main_*)
@pytest.mark.parametrize("engine,workload,v2_env", [
    ("minimizer", "uniform", False), ("minimizer", "uniform", True), ("dense", "uniform", False),
    ("stream", "uniform", False), ("minimizer", "repeat", False)])
def test_run_rung_equals_jax(engine, workload, v2_env, monkeypatch):
    if v2_env:
        # both pipelines pick their form by descriptor size alone: the
        # variable, set for both, changes neither row
        monkeypatch.setenv("FINITO_MINIMIZER_V2", "1")
    want = bench.run_rung(GENOME, _args(engine), np.random.default_rng(0), workload=workload,
                          engine_mode=engine)
    got = pbench.run_rung(GENOME, _args(engine, device="cpu"), np.random.default_rng(0),
                          workload=workload, engine_mode=engine)
    assert set(got) == set(want) == ROW_FIELDS
    for key in ROW_FIELDS - TIMINGS:
        assert got[key] == want[key], key
    assert got["verified_windows"] > got["oracle_verified_reads"]


def test_run_rung_v2_forced_equals_jax(monkeypatch):
    """The minimizer row in the v2 form, forced in both packages at the
    pipeline's capacities: the port's size threshold at 0, JAX's v1
    factory pointed at make_minimizer_locate_v2 with the pipeline's head
    capacity for B = 32, W = 34 (the port's v2 factory is seen to run).
    Every field but the times equal."""
    from finito_tpu.query import minimizer_engine as jme
    from finito_tpu_torch.query import engine as port_engine

    monkeypatch.setattr(port_engine, "V2_MIN_DESC_BYTES", 0)
    built = []
    v2_factory = port_engine.make_minimizer_locate_v2
    monkeypatch.setattr(port_engine, "make_minimizer_locate_v2",
                        lambda *a: built.append(a[2]) or v2_factory(*a))
    monkeypatch.setattr(jme, "make_minimizer_locate", lambda dmi, K: jme.make_minimizer_locate_v2(
        dmi, K, max(1024, int(32 * 34 * (2.8 / (31 - dmi.m + 2))))))
    want = bench.run_rung(GENOME, _args(), np.random.default_rng(0))
    got = pbench.run_rung(GENOME, _args(device="cpu"), np.random.default_rng(0))
    assert built  # the port ran its v2 locate
    for key in ROW_FIELDS - TIMINGS:
        assert got[key] == want[key], key
    assert got["verified_windows"] > got["oracle_verified_reads"]


@pytest.mark.parametrize("error", [None, "stalled: no progress for 9s"])
def test_emit_equals_jax(error, capsys):
    ladder = [{"genome": 400000, "qps": 1.5e6, "vs_baseline": 0.24},
              {"genome": 16000000, "error": "RuntimeError: x"}]
    bench._emit(ladder, error=error)
    want = capsys.readouterr().out
    pbench._emit(ladder, error=error)
    got = capsys.readouterr().out
    assert got == want and json.loads(got)["value"] == 1.5e6
    pbench._emit([], error=error)
    bench._emit([], error=error)
    a, b = capsys.readouterr().out.splitlines()
    assert a == b


def _main(argv, capsys):
    rc = pbench.main(["--device", "cpu", "--batch", "16", "--read-len", "64", "--reps", "1",
                      "--trials", "1", "--stall-timeout", "0", *argv])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    return rc, json.loads(out[0])


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("bench_cache"))
    assert build_cache.main(["--genome", "30000", "--cache-dir", d]) == 0
    return d


def test_main_ladder_auto_off_and_list(cache, capsys):
    rc, res = _main(["--genome", "20000", "--ladder", "auto", "--cache-dir", cache,
                     "--extra-rows", ""], capsys)
    assert rc == 0 and set(res) == {"metric", "value", "unit", "vs_baseline", "ladder"}
    assert [r["genome"] for r in res["ladder"]] == [20000, 30000]
    assert res["value"] == res["ladder"][0]["qps"]
    assert all(set(r) == ROW_FIELDS and r["analytic_verified_windows"] == 16 * 34
               for r in res["ladder"])
    _, res = _main(["--genome", "20000", "--ladder", "off", "--cache-dir", cache,
                    "--extra-rows", "off"], capsys)
    assert [r["genome"] for r in res["ladder"]] == [20000]
    _, res = _main(["--genome", "20000", "--ladder", "25000,20000", "--cache-dir", cache,
                    "--extra-rows", ""], capsys)
    assert [r["genome"] for r in res["ladder"]] == [20000, 25000]


def test_main_extra_rows_and_k63_skip(cache, capsys):
    rc, res = _main(["--genome", "20000", "--ladder", "off", "--cache-dir", cache,
                     "--extra-rows", "stream,replica,k63"], capsys)
    assert rc == 0 and "error" not in res
    rows = res["ladder"]
    assert [(r["engine"], r["workload"]) for r in rows] == [
        ("minimizer", "uniform"), ("replica", "uniform"), ("stream", "uniform")]
    assert all(r["analytic_verified_windows"] == 16 * 34 for r in rows)


def test_main_rung_isolation(cache, capsys, monkeypatch):
    """A later rung that fails becomes an error row; a failing head rung
    raises; a failing extra row becomes an error row."""
    real = pbench.load_or_build_index

    def failing(genome_len, *a, **kw):
        if genome_len == 30000:
            raise RuntimeError("no room")
        return real(genome_len, *a, **kw)

    monkeypatch.setattr(pbench, "load_or_build_index", failing)
    rc, res = _main(["--genome", "20000", "--ladder", "20000,30000", "--cache-dir", cache,
                     "--extra-rows", "repeat", "--repeat-genome", "40"], capsys)
    assert rc == 0 and "error" not in res
    head, bad, extra = res["ladder"]
    assert set(head) == ROW_FIELDS and res["value"] == head["qps"]
    assert bad == {"genome": 30000, "error": "RuntimeError: no room"}
    assert set(extra) == {"genome", "k", "engine", "workload", "error"}
    assert extra["workload"] == "repeat" and extra["genome"] == 40
    with pytest.raises(RuntimeError, match="no room"):
        _main(["--genome", "30000", "--ladder", "off", "--cache-dir", cache,
               "--extra-rows", ""], capsys)


WATCHDOG = textwrap.dedent("""
    import time
    from finito_tpu_torch.tools import bench
    ladder = [{"genome": 1, "qps": 2.0, "vs_baseline": 0.5}]
    bench._LAST_PROGRESS[0] = time.monotonic()
    bench.start_stall_watchdog(ladder, 0.3, poll_s=0.05)
    time.sleep(30)
""")


def test_watchdog_exits_3_with_partial_ladder():
    r = subprocess.run([sys.executable, "-c", WATCHDOG], cwd=ROOT, capture_output=True,
                       text=True, timeout=60, env={**os.environ, "PYTHONPATH": ROOT})
    assert r.returncode == 3, r.stderr[-2000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["error"].startswith("stalled:") and last["value"] == 2.0


def test_watchdog_stops_when_set():
    """main sets the watchdog's Event when it returns; a stopped watchdog
    never fires, though its stall time has long passed."""
    code = WATCHDOG.replace("bench.start_stall_watchdog(ladder, 0.3, poll_s=0.05)",
                            "bench.start_stall_watchdog(ladder, 0.3, poll_s=0.05).set()")
    code = code.replace("time.sleep(30)", "time.sleep(1.0); print('alive')")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=60, env={**os.environ, "PYTHONPATH": ROOT})
    assert r.returncode == 0 and r.stdout.strip() == "alive", r.stderr[-2000:]


def test_cuda_without_card_is_refused(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal is for a machine without one")
    rc = pbench.main(["--device", "cuda", "--ladder", "off", "--extra-rows", ""])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 1 and len(out) == 1
    res = json.loads(out[0])
    assert res["value"] == 0.0 and res["error"].startswith("device unreachable:")
    assert set(res) == {"metric", "value", "unit", "vs_baseline", "error"}
