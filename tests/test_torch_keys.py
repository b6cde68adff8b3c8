"""The port's device key algebra (finito_tpu_torch/ops/keys.py) and the
mesh build's exchange helpers (parallel/shard_build.py) against their
JAX twins (finito_tpu/ops/keys_jax.py, the shard_map helpers of
finito_tpu/parallel/shard_build.py on JAX's 8 virtual CPU devices) and
the host keys (sbwt/keys.py). Integer work: exact equality throughout.

Lengths k in {4, 11, 21, 22, 31, 43, 63} put the 3-bit char at k-1 on
both sides of a plane boundary (k = 11, 22, 43: bits 30-32, 63-65,
126-128 straddle two planes)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from finito_tpu_torch.ops import keys as kt
from finito_tpu_torch.sbwt import keys as kw

KS = [4, 11, 21, 22, 31, 43, 63]
S = 8


def _rand_host(rng, n, k, dups=0):
    """n random length-k rows over {$, A, C, G, T} (codes 0..4) as host
    key words, the last `dups` rows copies of earlier ones (ties)."""
    mat = rng.integers(0, 5, size=(n, k)).astype(np.uint8)
    if dups:
        mat[n - dups :] = mat[rng.integers(0, n - dups, size=dups)]
    return kw.pack_rows(mat)


def _with_sentinels(planes, n_sent, rng):
    """Host planes with n_sent all-ones rows spliced in at random rows."""
    out = np.concatenate([planes, np.full((n_sent, planes.shape[1]), 0xFFFFFFFF, np.uint32)])
    return out[rng.permutation(out.shape[0])]


def _dev(planes):
    return kt.to_device(planes, "cpu")


def _np(t):
    """A tensor in the int64 convention -> uint32 planes (or plain values)."""
    a = t.cpu().numpy()
    return a.astype(np.uint32) if a.ndim == 2 else a


def _words_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", KS)
def test_planes_round_trip_and_sentinels(k):
    import finito_tpu.ops.keys_jax as kj

    rng = np.random.default_rng(k)
    host = _rand_host(rng, 200, k)
    planes = kt.from_host(host)
    assert kt.n_planes(k) == kj.n_planes(k) == planes.shape[1]
    np.testing.assert_array_equal(planes, kj.from_host(host))
    _words_equal(kt.to_host(planes), host)
    _words_equal(kt.to_host(_dev(planes)), host)  # from the int64 convention
    sent = kt.sentinel_rows(3, planes.shape[1])
    np.testing.assert_array_equal(_np(sent), np.asarray(kj.sentinel_rows(3, planes.shape[1])))
    mixed = _with_sentinels(planes, 5, rng)
    np.testing.assert_array_equal(_np(kt.is_sentinel(_dev(mixed))),
                                  np.asarray(kj.is_sentinel(mixed)))
    assert int(kt.is_sentinel(_dev(mixed)).sum()) == 5


@pytest.mark.parametrize("k", KS)
def test_sort_compare_bucket_equal_jax_and_host(k):
    import jax.numpy as jnp

    import finito_tpu.ops.keys_jax as kj

    rng = np.random.default_rng(100 + k)
    host = _rand_host(rng, 300, k, dups=60)
    planes = _with_sentinels(kt.from_host(host), 7, rng)
    dev, jdev = _dev(planes), jnp.asarray(planes)
    # the stable order is unique: the same permutation as JAX's
    order = kt.argsort_rows(dev)
    np.testing.assert_array_equal(_np(order), np.asarray(kj.argsort_rows(jdev)))
    srt = planes[_np(order)]
    np.testing.assert_array_equal(srt[: host[0].size], kt.from_host(kw.sort_keys(host)))
    assert kt.is_sentinel(dev[order])[host[0].size :].all()  # sentinels sort last
    np.testing.assert_array_equal(_np(kt.eq_adjacent_rows(_dev(srt))),
                                  np.asarray(kj.eq_adjacent_rows(jnp.asarray(srt))))
    np.testing.assert_array_equal(_np(kt.eq_adjacent_rows(_dev(srt)))[: host[0].size],
                                  kw.eq_adjacent(kw.sort_keys(host)))
    # three-way compare: random pairs, equal pairs, sentinel pairs
    other = planes[rng.permutation(planes.shape[0])]
    other[::5] = planes[::5]
    got = _np(kt.cmp_rows(dev, _dev(other)))
    np.testing.assert_array_equal(got, np.asarray(kj.cmp_rows(jdev, jnp.asarray(other))))
    valid = ~(_np(kt.is_sentinel(dev)) | _np(kt.is_sentinel(_dev(other))))
    want = kw.cmp_keys(kt.to_host(planes[valid]), kt.to_host(other[valid]))
    np.testing.assert_array_equal(got[valid], want)
    # buckets against S - 1 sorted splitters, some of them sentinels
    spl = srt[np.sort(rng.choice(srt.shape[0], S - 1, replace=False))]
    np.testing.assert_array_equal(_np(kt.bucket_of(dev, _dev(spl))),
                                  np.asarray(kj.bucket_of(jdev, jnp.asarray(spl))))


@pytest.mark.parametrize("k", KS)
def test_shift_mask_char_algebra_equal_jax_and_host(k):
    import jax.numpy as jnp

    import finito_tpu.ops.keys_jax as kj

    rng = np.random.default_rng(200 + k)
    host = _rand_host(rng, 257, k)
    planes = kt.from_host(host)
    dev, jdev = _dev(planes), jnp.asarray(planes)
    got = _np(kt.shift_right3_rows(dev))
    np.testing.assert_array_equal(got, np.asarray(kj.shift_right3_rows(jdev)))
    _words_equal(kt.to_host(got), kw.shift_right3(host))
    for chars in sorted({1, 10, 11, k // 2, k - 1, k}):
        m = _np(kt.mask_low_rows(dev, chars))
        np.testing.assert_array_equal(m, np.asarray(kj.mask_low_rows(jdev, chars)))
        _words_equal(kt.to_host(m), kw.mask_low(host, chars))
        sh = _np(kt.shift_left_rows(_dev(m), k - chars))
        np.testing.assert_array_equal(sh, np.asarray(kj.shift_left_rows(jnp.asarray(m), k - chars)))
        _words_equal(kt.to_host(sh), kw.shift_left(kw.mask_low(host, chars), k - chars))
    top = _np(kt.top_char_rows(dev, k))
    np.testing.assert_array_equal(top, np.asarray(kj.top_char_rows(jdev, k)))
    np.testing.assert_array_equal(top, kw.top_char(host, k))
    # every char, the straddling ones included, and writing one back
    for p in range(k):
        np.testing.assert_array_equal(_np(kt.char_at_rows(dev, p)), kw.unpack_char(host, p))
    cleared = kw.mask_low(host, k - 1)
    for c in range(5):
        got = kt.or_char_rows_(_dev(kt.from_host(cleared)), k - 1, c)
        _words_equal(kt.to_host(got), kw.set_top_char(cleared, k, c))


@pytest.mark.parametrize("k", [11, 19, 22, 43, 63])
def test_match_rows_equal_jax_and_host(k):
    """Absent queries, duplicate queries, sentinel queries and sentinel
    R padding (whose values are -1)."""
    import jax.numpy as jnp

    import finito_tpu.ops.keys_jax as kj

    rng = np.random.default_rng(300 + k)
    hostR = kw.dedup_sorted(kw.sort_keys(_rand_host(rng, 100, k)))
    nR = hostR[0].size
    hostQ = _rand_host(rng, 60, k)
    pick = rng.integers(0, nR, size=40)  # present, with repeats
    pick[:6] = pick[6]
    R = kt.from_host(hostR)
    Q = np.concatenate([kt.from_host(hostQ), R[pick], np.full((3, R.shape[1]), 0xFFFFFFFF, np.uint32)])
    Rp = np.concatenate([R, np.full((13, R.shape[1]), 0xFFFFFFFF, np.uint32)])
    vals = np.concatenate([np.arange(nR), np.full(13, -1)])
    got = _np(kt.match_rows(_dev(Q), _dev(Rp), torch.from_numpy(vals)))
    jgot = np.asarray(kj.match_rows(jnp.asarray(Q), jnp.asarray(Rp), jnp.asarray(vals, jnp.int32)))
    np.testing.assert_array_equal(got, jgot)
    np.testing.assert_array_equal(got, np.concatenate([kw.match_into(hostQ, hostR), pick, [-1] * 3]))


def _jax_exchange(keys, spl, M, pay):
    """JAX's _exchange and _answers_back under shard_map on S devices:
    (recv keys, recv payload, overflow, answers back of the payload)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from finito_tpu.parallel import shard_build as jsb

    mesh = Mesh(np.array(jax.devices()[:S]), ("D",))

    def body(kb, pb, sp):
        recv, rpay, ovf, order, slot, ok = jsb._exchange(kb[0], sp, S, M, (pb[0],))
        back = jsb._answers_back(rpay[0], order, slot, ok, kb.shape[1], S, M)
        return recv[None], rpay[0][None], ovf[None], back[None]

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("D"), P("D"), P()),
                              out_specs=(P("D"), P("D"), P("D"), P("D"))))
    out = f(jnp.asarray(keys), jnp.asarray(pay, jnp.int32), jnp.asarray(spl))
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("k,M", [(11, 12), (31, 40), (63, 5)])
def test_all_to_all_exchange_and_answers_back_equal_jax(k, M):
    """The block transpose (shard j receives cat_i(send_i[j*M:(j+1)*M])
    in source order), the payload that rides along, the overflow count
    (M = 5 overflows) and the inverse transpose of per-slot answers, each
    equal to JAX's lax.all_to_all under shard_map."""
    from finito_tpu_torch.parallel import shard_build as tsb

    rng = np.random.default_rng(400 + k)
    n = 30
    keys = np.stack([_with_sentinels(kt.from_host(_rand_host(rng, n - 4, k, dups=5)), 4, rng)
                     for _ in range(S)])
    sample = kt.from_host(kw.sort_keys(_rand_host(rng, 64, k)))
    spl = sample[(np.arange(1, S) * 64) // S]
    pay = rng.integers(0, 1 << 20, size=(S, n))
    want_recv, want_pay, want_ovf, want_back = _jax_exchange(keys, spl, M, pay)

    devs = [torch.device("cpu")] * S
    spl_d = {devs[0]: _dev(spl)}
    recv, rpay, ovf, ctx = tsb._exchange([_dev(kb) for kb in keys], spl_d, S, M, devs,
                                         [[torch.from_numpy(p)] for p in pay])
    back = tsb._answers_back([r[0] for r in rpay], ctx, [n] * S, S, M, devs)
    for j in range(S):
        np.testing.assert_array_equal(_np(recv[j]), want_recv[j])
        np.testing.assert_array_equal(_np(rpay[j][0]), want_pay[j])
        np.testing.assert_array_equal(_np(back[j]), want_back[j])
    np.testing.assert_array_equal([int(o) for o in ovf], want_ovf)
    # the transpose alone, applied twice, is the identity
    blocks = [torch.arange(S * 3) + 100 * i for i in range(S)]
    twice = tsb._all_to_all(tsb._all_to_all(blocks, devs), devs)
    for a, b in zip(twice, blocks):
        assert torch.equal(a, b)
