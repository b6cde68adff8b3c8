"""Entry points of the port: the single-device locate step and the
multi-device dry run, twins of __graft_entry__.py's entry and
dryrun_multichip.

The flagship step is the minimizer seed-and-verify locate (the v1 form)
over a batch of reads. The dry run drives every mesh path of the port on
tiny and 10^6-base inputs and checks each against its single-device or
host counterpart:

  * dp: query reads sharded along the batch axis;
  * tp: the index sharded (colex ranges for the dense locate, unitig-
    text ranges for the minimizer locate).

    python -c "from finito_tpu_torch.entry import dryrun_multichip; \\
        dryrun_multichip(8, devices=['cuda:0'] * 8)"
"""

from __future__ import annotations

import contextlib
import io
import tempfile

import numpy as np
import torch

from finito_tpu_torch import tools

TINY_SPSS = [b"GTAAGTCT", b"AGGAAA", b"ACAGG", b"GTAGG", b"AGGTA"]


def _tiny_index(k: int = 4):
    from finito_tpu_torch.index.builder import FinimizerIndexBuilder
    from finito_tpu_torch.io.seqdb import SeqDB
    from finito_tpu_torch.sbwt.construct import build_plain_matrix_sbwt
    from finito_tpu_torch.sbwt.lcs import lcs_array

    sbwt, keys = build_plain_matrix_sbwt(TINY_SPSS, k, return_keys=True)
    return FinimizerIndexBuilder(sbwt, lcs_array(sbwt), SeqDB.from_sequences(TINY_SPSS),
                                 node_keys=keys).get_index()


def entry(device="cuda"):
    """(fn, example_args): the v1 minimizer locate of the tiny index on
    `device`, and a (8, 32) batch of codes on it; fn(*example_args) ->
    (uid, off, n_slow)."""
    from finito_tpu_torch.index.minimizer import MinimizerIndex
    from finito_tpu_torch.query.minimizer_engine import DeviceMinimizerIndex, make_minimizer_locate

    dev = tools.device(device)
    dmi = DeviceMinimizerIndex(MinimizerIndex.from_finimizer_index(_tiny_index()), dev)
    fn = make_minimizer_locate(dmi, K_slow=256)
    rng = np.random.default_rng(0)
    example_codes = rng.integers(0, 4, size=(8, 32)).astype(np.uint8)
    return fn, (torch.from_numpy(example_codes).to(dev),)


def _same(a, b) -> bool:
    return np.array_equal(torch.as_tensor(a).cpu().numpy(), torch.as_tensor(b).cpu().numpy())


def _cli_mesh_matches_single(td: str, device: str, dp: int, tp: int) -> None:
    """search-fmin through the port's CLI on the tiny index, single
    device and --mesh dp,tp: the same bytes."""
    from finito_tpu_torch.cli import main as cli_main

    fna, q = f"{td}/u.fna", f"{td}/q.fna"
    with open(fna, "w") as f:
        f.writelines(f">u{i}\n{u.decode()}\n" for i, u in enumerate(TINY_SPSS))
    with open(q, "w") as f:
        f.write(">q0\nACAGGTAAGT\n>q1\nGTAGGAAAC\n")
    runs = [["sbwt-build", "-k", "4", "-i", fna, "-o", f"{td}/x.sbwt"],
            ["build-fmin", "-o", f"{td}/p", "-i", f"{td}/x.sbwt", "-u", fna],
            ["search-fmin", "-o", f"{td}/one.txt", "-i", f"{td}/p", "-q", q,
             "--engine", "minimizer", "--device", device],
            ["search-fmin", "-o", f"{td}/mesh.txt", "-i", f"{td}/p", "-q", q,
             "--engine", "minimizer", "--device", device, "--mesh", f"{dp},{tp}"]]
    for argv in runs:
        with contextlib.redirect_stderr(io.StringIO()), contextlib.redirect_stdout(io.StringIO()):
            rc = cli_main(argv)
        if rc != 0:
            raise AssertionError(f"{argv[0]} exited {rc}")
    with open(f"{td}/one.txt", "rb") as f1, open(f"{td}/mesh.txt", "rb") as f2:
        if f1.read() != f2.read():
            raise AssertionError("CLI --mesh output differs from single-device")


def dryrun_multichip(n_devices: int, devices=None) -> str:
    """Run every mesh path of the port once over n_devices devices and
    check it: the sharded dense and minimizer locates against the
    single-device engines; a 10^6-base DSPSS built shard-locally
    with reads on every seam; the build step that scatters the position
    table (search_batch_device per device shard, an amax scatter onto a
    sink row); sharded_lcs_fn and sharded_index_build against the host;
    ShardedIndex.build's locate against the host oracle; the CLI's
    --mesh output against single-device bytes. devices: the mesh's
    devices (may repeat one, e.g. ["cuda:0"] * 8); by default the first
    n_devices cards. Raises on any disagreement; returns a summary."""
    from finito_tpu_torch.index.builder import FinimizerIndexBuilder
    from finito_tpu_torch.index.minimizer import MinimizerIndex
    from finito_tpu_torch.io.seqdb import SeqDB, decode_seq, encode_seq
    from finito_tpu_torch.ops.bitvec import DeviceSBWT, search_batch_device
    from finito_tpu_torch.parallel.mesh import (
        ShardedIndex,
        ShardedMinimizerIndex,
        make_mesh,
        sharded_lcs_fn,
        sharded_locate_fn,
        sharded_minimizer_locate_fn,
    )
    from finito_tpu_torch.parallel.shard_build import shard_devices, sharded_index_build
    from finito_tpu_torch.query.engine import DeviceQueryEngine
    from finito_tpu_torch.query.locators import build_position_table
    from finito_tpu_torch.query.minimizer_engine import DeviceMinimizerIndex, make_minimizer_locate
    from finito_tpu_torch.sbwt.construct import build_plain_matrix_sbwt
    from finito_tpu_torch.sbwt.lcs import lcs_array
    from finito_tpu_torch.utils.synth import gen_dspss

    if devices is None:
        devices = shard_devices("cuda", n_devices)
    devs = [torch.device(d) for d in devices[:n_devices]]
    if len(devs) < n_devices:
        raise RuntimeError(f"need {n_devices} devices, given {len(devs)}")
    dev0 = devs[0]

    index = _tiny_index()
    engine = DeviceQueryEngine(index, mode="dense", device=dev0)
    dsbwt = engine.locator.dsbwt
    pos = build_position_table(dsbwt, index.unitigs.concat, index.unitigs.ends)

    tp = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_devices, tp=tp, devices=devs)
    dp = n_devices // tp
    sh = ShardedIndex.from_index(index, pos, tp=tp)
    locate = sharded_locate_fn(mesh, sh)
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=(dp * 4, 32)).astype(np.uint8)
    uid, off = locate(codes)
    uid1, off1 = engine.locate_batch(codes)
    if not (_same(uid, uid1) and _same(off, off1)):
        raise AssertionError("sharded locate disagrees with the single-device engine")

    # the minimizer locate sharded the same way: batch over dp,
    # minimizer-value ranges over tp, owner-shard psum combine
    shm = ShardedMinimizerIndex.from_minimizer_index(
        MinimizerIndex.from_finimizer_index(index), tp=tp)
    um, om, ns = sharded_minimizer_locate_fn(mesh, shm, K_slow=256)(codes)
    if not (_same(um, uid1) and _same(om, off1)):
        raise AssertionError("sharded minimizer locate disagrees with the single-device engine")
    if int(ns) > 256:
        raise AssertionError(f"sharded minimizer locate: {int(ns)} slow windows past K_slow 256")

    # a 10^6-base DSPSS built shard-locally, reads on every tp seam,
    # against the single-device minimizer engine
    kk = 31
    rngb = np.random.default_rng(7)
    genome, unitigs = gen_dspss(rngb, 1_000_000, kk)
    concat = np.concatenate([encode_seq(u) for u in unitigs])
    ends = np.cumsum([len(u) for u in unitigs])
    big = ShardedMinimizerIndex.build(concat, ends, kk, tp=tp)
    L = 128
    B2 = ((dp * 4 + 2 * max(tp - 1, 1)) // dp + 1) * dp  # dp-divisible
    starts = list(rngb.integers(0, genome.size - L, size=B2 - 2 * (tp - 1)))
    # unitig i begins at genome coordinate cumsum(len - (k-1)); a read
    # centred on a shard's first unitig start covers both neighbours
    glens = np.asarray([len(u) - (kk - 1) for u in unitigs], np.int64)
    gstarts = np.concatenate([[0], np.cumsum(glens)[:-1]])
    for s in range(1, tp):
        b0 = int(gstarts[min(int(big.uid_base[s]), len(unitigs) - 1)])
        starts.append(int(np.clip(b0 - L // 2, 0, genome.size - L)))
        starts.append(int(np.clip(b0 - kk, 0, genome.size - L)))
    starts = np.asarray(starts[:B2], np.int64)
    reads_big = genome[starts[:, None] + np.arange(L)[None, :]].copy()
    mut = rngb.integers(0, L, size=starts.size)
    reads_big[np.arange(starts.size), mut] = (reads_big[np.arange(starts.size), mut] + 1) % 4
    ub, ob, nsb = sharded_minimizer_locate_fn(mesh, big, K_slow=4096)(reads_big)
    dmi1 = DeviceMinimizerIndex(MinimizerIndex.build(concat, ends, kk), dev0)
    ub1, ob1, _ = make_minimizer_locate(dmi1, K_slow=4096)(torch.from_numpy(reads_big).to(dev0))
    if not (_same(ub, ub1) and _same(ob, ob1)):
        raise AssertionError("shard-local sharded minimizer locate disagrees with one device")
    ub = ub.cpu().numpy()
    shard_of = np.searchsorted(big.uid_base, ub[ub >= 0], side="right")
    if tp > 1 and np.unique(shard_of).size < 2:
        raise AssertionError("seam reads did not span multiple shards")
    n_big = int(concat.size)
    del genome, concat, big, dmi1

    # the build step: search every unitig window of the tiny index, the
    # windows split over the mesh's devices, then an amax scatter of the
    # window numbers into the position table (absent ranks -> the sink
    # row n), held to the same step on one device
    k = index.sbwt.get_k()
    tconcat = index.unitigs.concat
    n_pos = tconcat.size - k + 1
    m = max(dp, (n_pos // dp) * dp)
    wstarts = np.arange(m) % n_pos
    windows = np.stack([tconcat[s : s + k] for s in wstarts]).astype(np.uint8)
    n = dsbwt.n_nodes
    table = torch.full((n + 1,), -1, dtype=torch.int32, device=dev0)
    dsbwt_on = {}
    for d, part in zip(devs, np.array_split(np.arange(m), n_devices)):
        if d not in dsbwt_on:
            dsbwt_on[d] = DeviceSBWT.from_host(index.sbwt, d)
        r = search_batch_device(dsbwt_on[d], torch.from_numpy(windows[part]).to(d)).to(dev0)
        table.scatter_reduce_(0, torch.where(r < 0, n, r).to(torch.int64),
                              torch.from_numpy(part.astype(np.int32)).to(dev0), "amax")
    r1 = search_batch_device(dsbwt, torch.from_numpy(windows).to(dev0)).to(torch.int64)
    want = torch.full((n + 1,), -1, dtype=torch.int32, device=dev0)
    want.scatter_reduce_(0, torch.where(r1 < 0, n, r1), torch.arange(m, dtype=torch.int32,
                                                                       device=dev0), "amax")
    if not _same(table[:n], want[:n]):
        raise AssertionError("sharded build step disagrees with the single-device scatter")

    # the node-sharded LCS
    if not np.array_equal(sharded_lcs_fn(mesh, index.sbwt), np.asarray(lcs_array(index.sbwt))):
        raise AssertionError("sharded LCS build disagrees with host lcs_array")

    # the mesh-sharded index build of a slice, against the host builder
    slice_unitigs = unitigs[: max(8, len(unitigs) // 10)]
    want_sbwt, keys = build_plain_matrix_sbwt(slice_unitigs, kk, return_keys=True)
    want_idx = FinimizerIndexBuilder(want_sbwt, lcs_array(want_sbwt),
                                     SeqDB.from_sequences(slice_unitigs),
                                     node_keys=keys).get_index()
    got_idx = sharded_index_build(slice_unitigs, kk, mesh=mesh)
    if not (np.array_equal(got_idx.sbwt.bit_rows(), want_idx.sbwt.bit_rows())
            and np.array_equal(got_idx.LCS, want_idx.LCS)
            and np.array_equal(got_idx.fmin, want_idx.fmin)
            and np.array_equal(got_idx.global_offsets, want_idx.global_offsets)
            and np.array_equal(got_idx.Ustart, want_idx.Ustart)):
        raise AssertionError("mesh-sharded index build disagrees with the host builder")
    n_shard_built = got_idx.sbwt.number_of_subsets()

    # ShardedIndex.build from the mesh build's position slices: its
    # sharded locate against the host oracle
    locate2 = sharded_locate_fn(mesh, ShardedIndex.build(got_idx, tp=tp))
    reads2 = np.zeros((dp * 2, 64), np.uint8)  # 'A' pad: the same input to both
    for i in range(reads2.shape[0]):
        u = encode_seq(slice_unitigs[i % len(slice_unitigs)])
        reads2[i, : min(64, u.size)] = u[:64]
    u2, o2 = (t.cpu().numpy() for t in locate2(reads2))
    for i in range(reads2.shape[0]):
        exp = want_idx.search(decode_seq(reads2[i])).local_offsets
        if list(zip(u2[i, : len(exp)].tolist(), o2[i, : len(exp)].tolist())) != exp:
            raise AssertionError(
                "shard-locally built ShardedIndex locate disagrees with the oracle")

    # the CLI's --mesh path: the same bytes as the single-device run
    cli_ok = False
    if tp > 1:
        same = all(d == dev0 for d in devs)
        with tempfile.TemporaryDirectory() as td:
            _cli_mesh_matches_single(td, str(dev0) if same else "cuda", dp, tp)
        cli_ok = True

    summary = (f"dryrun_multichip ok: mesh dp={dp} tp={tp}, locate {tuple(uid.shape)} verified, "
               f"shard-local index {n_big} bases x tp={tp} verified (seam reads, {int(nsb)} slow), "
               f"build step over {m} windows, mesh-sharded full-index build {n_shard_built} nodes "
               f"equal to the host builder, CLI --mesh path "
               f"{'verified' if cli_ok else 'skipped (tp=1)'}")
    print(summary, flush=True)
    return summary
