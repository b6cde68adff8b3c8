"""The port's 32-bit word convention (finito_tpu_torch/ops/bits.py)
against the host index's numpy mixes and plain numpy uint32 arithmetic,
at values on both sides of 2^31. All comparisons are exact."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from finito_tpu.index.minimizer import mix32, slot32
from finito_tpu_torch.ops import bits

torch.set_num_threads(1)

EDGES = np.array([0, 1, 2**16 - 1, 2**16, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 2, 2**32 - 1],
                 dtype=np.uint64)


def _words(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGES, rng.integers(0, 2**32, size=4096, dtype=np.uint64)])


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words.astype(np.int64))


@pytest.mark.parametrize("as_i32", [False, True])
@pytest.mark.parametrize("name,host", [("mix32", mix32), ("slot32", slot32)])
def test_mixes_match_host_index(name, host, as_i32):
    w = _words(1)
    t = _t(w)
    if as_i32:  # int32 bit patterns widen the same way
        t = bits.to_i32(t)
    got = getattr(bits, name)(t).numpy()
    np.testing.assert_array_equal(got, host(w.astype(np.uint32)).astype(np.int64))


def test_mul32_wraps_mod_2_32():
    w = _words(2)
    for c in (bits.MIX32, bits.MIX2, 0xFFFFFFFF, 3):
        want = (w * np.uint64(c)) & np.uint64(0xFFFFFFFF)
        np.testing.assert_array_equal(bits.mul32(_t(w), c).numpy(), want.astype(np.int64))


@pytest.mark.parametrize("s", [0, 1, 5, 13, 16, 31])
def test_logical_shift_on_int32_patterns(s):
    w = _words(3)
    got = bits.shr32(bits.to_i32(_t(w)), s).numpy()
    np.testing.assert_array_equal(got, (w.astype(np.uint32) >> np.uint32(s)).astype(np.int64))


def test_popcount32():
    w = _words(4)
    want = np.unpackbits(w.astype("<u4").view(np.uint8)).reshape(-1, 32).sum(axis=1)
    np.testing.assert_array_equal(bits.popcount32(_t(w)).numpy(), want)
    np.testing.assert_array_equal(bits.popcount32(bits.to_i32(_t(w))).numpy(), want)


def test_i32_round_trip():
    w = _words(5)
    pat = bits.to_i32(_t(w))
    assert pat.dtype == torch.int32
    np.testing.assert_array_equal(pat.numpy().view(np.uint32), w.astype(np.uint32))
    np.testing.assert_array_equal(bits.u32(pat).numpy(), w.astype(np.int64))
