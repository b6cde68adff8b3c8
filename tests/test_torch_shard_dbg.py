"""The port's mesh unitig build (finito_tpu_torch/parallel/shard_dbg.py)
against the JAX package's (finito_tpu/parallel/shard_dbg.py on its 8
virtual CPU devices) and the host builders (the port's and JAX's
dbg.build_unitigs), case for case as tests/test_shard_dbg.py; the port's
mesh is the CPU repeated N times. The unitigs are compared in the order
the builders emit them, which is what unitigs writes. Exact equality.

JAX's mesh build is run on the cases where it takes seconds; on the
rest the reference is JAX's host builder, which tests/test_shard_dbg.py
holds equal to JAX's mesh build on the same inputs."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

from finito_tpu.dbg import build_unitigs as jax_build_unitigs
from finito_tpu_torch.dbg import build_unitigs
from finito_tpu_torch.ops import keys as kt
from finito_tpu_torch.parallel import shard_dbg as tsd
from finito_tpu_torch.sbwt import keys as kw

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the virtual 8-device mesh"
)


def _bytes(unis):
    return [bytes(np.asarray(u, np.uint8)) for u in unis]


def _gen_pangenome(rng, base_len, n_var, snp):
    base = rng.integers(0, 4, size=base_len, dtype=np.uint8)
    out = [base]
    for _ in range(n_var):
        v = base.copy()
        pos = rng.choice(base_len, size=max(1, int(snp * base_len)), replace=False)
        v[pos] = (v[pos] + rng.integers(1, 4, size=pos.size)) % 4
        out.append(v)
    return out


def _jax_mesh(seqs, k, n_dev, **kw):
    from finito_tpu.parallel.shard_dbg import sharded_unitig_build

    return sharded_unitig_build(seqs, k, n_devices=n_dev, **kw)


@pytest.mark.parametrize("k", [11, 22, 43, 63])
def test_rc_and_top_char_rows_equal_jax_and_host(k):
    """The chars whose 3 bits straddle a plane boundary (r > 29) are read
    and written across both planes; sentinel rows give JAX's bits."""
    import jax.numpy as jnp

    from finito_tpu.parallel import shard_dbg as jsd

    rng = np.random.default_rng(k)
    mat = rng.integers(1, 5, size=(120, k)).astype(np.uint8)
    host = kw.pack_rows(mat)
    planes = np.concatenate([kt.from_host(host),
                             np.full((2, kt.n_planes(k)), 0xFFFFFFFF, np.uint32)])
    dev = kt.to_device(planes, "cpu")
    got = tsd._rc_rows(dev, k).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(jsd._rc_rows(jnp.asarray(planes), k)))
    for a, b in zip(kt.to_host(got[:120]), kw.rc_keys(host, k)):
        np.testing.assert_array_equal(a, b)
    cleared = kt.from_host(kw.mask_low(host, k - 1))
    for c in range(1, 5):
        got = tsd._set_top_char_rows(kt.to_device(cleared, "cpu"), k, c).numpy().astype(np.uint32)
        np.testing.assert_array_equal(
            got, np.asarray(jsd._set_top_char_rows(jnp.asarray(cleared), k, c)))
        for a, b in zip(kt.to_host(got), kw.set_top_char(kw.mask_low(host, k - 1), k, c)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k,n_dev,jax_mesh", [(31, 8, False), (5, 4, True), (63, 8, False)])
def test_sharded_equals_jax_and_host(k, n_dev, jax_mesh):
    rng = np.random.default_rng(k)
    seqs = _gen_pangenome(rng, 4000, 3, 0.01)
    got = _bytes(tsd.sharded_unitig_build(seqs, k, devices=["cpu"] * n_dev))
    assert got == _bytes(build_unitigs(seqs, k, canonical=True))
    assert got == _bytes(jax_build_unitigs(seqs, k, canonical=True))
    if jax_mesh:
        assert got == _bytes(_jax_mesh(seqs, k, n_dev))


def test_sharded_overflow_retry():
    """slack so small that the first successor-exchange capacity
    overflows and doubles."""
    rng = np.random.default_rng(2)
    seqs = _gen_pangenome(rng, 3000, 2, 0.02)
    reads = []
    real = tsd._total

    def counted(parts):
        n = real(parts)
        reads.append(n)
        return n

    tsd._total = counted
    try:
        got = _bytes(tsd.sharded_unitig_build(seqs, 15, devices=["cpu"] * 8, slack=0.02))
    finally:
        tsd._total = real
    assert any(n > 0 for n in reads)
    assert got == _bytes(build_unitigs(seqs, 15, canonical=True))
    assert got == _bytes(jax_build_unitigs(seqs, 15, canonical=True))


@pytest.mark.parametrize("k", [8, 2, 251])
def test_sharded_rejects_even_or_out_of_range_k(k):
    with pytest.raises(ValueError, match="canonical mode needs odd k"):
        tsd.sharded_unitig_build([np.zeros(300, np.uint8)], k, devices=["cpu"] * 2)


def test_sharded_handles_n_splits_and_bytes_input():
    from finito_tpu_torch.io.seqdb import encode_seq

    rng = np.random.default_rng(5)
    s = "".join("ACGT"[c] for c in rng.integers(0, 4, 400))
    with_n = s[:150] + "N" + s[150:]
    host = _bytes(build_unitigs([encode_seq(with_n.encode())], 9))
    # bytes input + an embedded N (sequence split) through the mesh path
    got = _bytes(tsd.sharded_unitig_build([with_n.encode()], 9, devices=["cpu"] * 4))
    assert got == host
    assert got == _bytes(_jax_mesh([with_n.encode()], 9, 4))
    # str input, and input with no k-mer at all
    assert _bytes(tsd.sharded_unitig_build([with_n], 9, devices=["cpu"] * 4)) == host
    assert tsd.sharded_unitig_build([b"ACGT", b"NNNNNNNNNNNN"], 9, devices=["cpu"] * 4) == []
