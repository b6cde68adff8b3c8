"""The port's entry points (finito_tpu_torch/entry.py) on the CPU against
__graft_entry__.py: entry()'s locate step on its example batch equals
the JAX entry's, run as the JAX tests run it (its 8 virtual CPU
devices); dryrun_multichip passes on 8 CPU shards, with every check
JAX's runs; neither falls back to the host when a card is asked for.
Every comparison is exact."""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from finito_tpu_torch import entry as port_entry

torch.set_num_threads(1)


def test_entry_equals_jax():
    fn, (codes,) = port_entry.entry(device="cpu")
    jfn, (jcodes,) = jax_entry.entry()
    assert codes.device.type == "cpu" and np.array_equal(codes.numpy(), jcodes)
    got, want = fn(codes), jfn(jcodes)
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert (got[0] >= 0).any()  # the random batch meets the tiny index


def test_tiny_index_equals_jax():
    got, want = port_entry._tiny_index(), jax_entry._tiny_index()
    for a, b in ((got.sbwt.bit_rows(), want.sbwt.bit_rows()), (got.LCS, want.LCS),
                 (got.fmin, want.fmin), (got.global_offsets, want.global_offsets),
                 (got.Ustart, want.Ustart)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_dryrun_multichip_on_cpu_shards(capsys):
    summary = port_entry.dryrun_multichip(8, devices=["cpu"] * 8)
    assert summary.startswith("dryrun_multichip ok: mesh dp=4 tp=2")
    assert "CLI --mesh path verified" in summary and "shard-local index" in summary
    assert summary in capsys.readouterr().out


def test_entry_points_ask_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_entry.dryrun_multichip(8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match=re.escape("needs 8 devices, found 1 card(s)")):
        port_entry.dryrun_multichip(8)
    with pytest.raises(RuntimeError, match="need 8 devices, given 2"):
        port_entry.dryrun_multichip(8, devices=["cpu"] * 2)
