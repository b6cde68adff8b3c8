"""The port's minimizer front end (finito_tpu_torch/ops/minimizer_front.py)
against the JAX forms it replaces: minimizer_scan + pack_query_windows
and the Pallas kernel in interpreter mode. Exact integer equality,
bad (pad / non-ACGT) windows included. The kernel itself runs only on
a CUDA card (the `cuda` marker)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from finito_tpu.ops.pallas_min import minimizer_windows_pallas
from finito_tpu.query.minimizer_engine import minimizer_scan, pack_query_windows
from finito_tpu_torch.ops.minimizer_front import minimizer_windows, minimizer_windows_ref

torch.set_num_threads(1)

CASES = [(31, 16), (21, 12), (63, 28), (95, 16), (31, 3), (31, 4)]


def _codes(seed=3, B=64, L=128):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    codes[rng.integers(0, B, 25), rng.integers(0, L, 25)] = 255
    return codes


def _assert_equal_to_jax(jax_out, port_out):
    bv, bo, bad, qw = jax_out
    tv, to, tb, tq = port_out
    np.testing.assert_array_equal(np.asarray(bv), tv.numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray(bo), to.numpy())
    np.testing.assert_array_equal(np.asarray(bad), tb.numpy())
    assert len(qw) == tq.shape[0]
    for a, b in zip(qw, tq):
        np.testing.assert_array_equal(np.asarray(a), b.numpy().view(np.uint32))


@pytest.mark.parametrize("k,m", CASES)
def test_front_matches_xla_forms(k, m):
    codes = _codes()
    c = jnp.asarray(codes).astype(jnp.uint32)
    before = minimizer_windows.launches
    port = minimizer_windows(torch.from_numpy(codes), k, m)
    assert minimizer_windows.launches == before  # CPU tensor: plain version
    _assert_equal_to_jax((*minimizer_scan(c, k, m), pack_query_windows(c, k)), port)


@pytest.mark.parametrize("k,m", [(31, 16), (63, 28), (95, 16), (31, 3)])
def test_front_matches_pallas_interpret(k, m):
    codes = _codes(seed=5)
    pv, po, pbad, pqw = minimizer_windows_pallas(
        jnp.asarray(codes), k, m, block_b=32, interpret=True
    )
    _assert_equal_to_jax((pv, po, pbad, pqw),
                         minimizer_windows_ref(torch.from_numpy(codes), k, m))


def test_engine_front_helpers_match_jax():
    from finito_tpu_torch.query import minimizer_engine as tme

    codes = _codes(seed=7)
    c = jnp.asarray(codes).astype(jnp.uint32)
    t = torch.from_numpy(codes)
    _assert_equal_to_jax((*minimizer_scan(c, 31, 16), pack_query_windows(c, 31)),
                         (*tme.minimizer_scan(t, 31, 16), tme.pack_query_windows(t, 31)))


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError):
        minimizer_windows(torch.zeros((2, 40), dtype=torch.uint8, device="meta"), 31, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,k,m", [
    (8192, 128, 31, 16), (8192, 128, 21, 12), (8192, 128, 63, 28),
    (8192, 128, 95, 16), (64, 4096, 31, 16), (256, 128, 31, 3), (7, 300, 250, 16),
])
def test_kernel_matches_plain_on_card(B, L, k, m):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    codes = torch.from_numpy(_codes(seed=B + k, B=B, L=L)).cuda()
    before = minimizer_windows.launches
    got = minimizer_windows(codes, k, m)
    torch.cuda.synchronize()
    assert minimizer_windows.launches == before + 1
    for a, b in zip(got, minimizer_windows_ref(codes, k, m)):
        assert torch.equal(a, b)
