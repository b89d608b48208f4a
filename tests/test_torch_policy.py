"""The port's mesh price model (krypy_tpu_torch.functional.policy) against
krypy_tpu.functional.policy.

With the same constants set in both packages (``SYNC_S`` and
``HBM_BYTES_PER_S`` monkeypatched on both sides) every answer is equal,
over a grid of solvers, shard sizes, item sizes, basis heights and sync
prices that straddles each decision's break-even.  The environment
variables override the table; the table's row follows the device type of
the system's tensors (the JAX package keys it by its backend).
"""

import itertools

import pytest
import torch

from krypy_tpu.functional import policy as jpolicy
from krypy_tpu_torch.functional import policy

SOLVERS = ("cg", "minres", "deflated_cg", "deflated_minres", "unknown")
N_LOCAL = (1_000, 65_536, 4_194_304)
ITEMSIZES = (4, 8)
ROWS = (2, 26)
SYNC_S = (1e-6, 3e-5, 1e-3)


@pytest.fixture
def same_constants(monkeypatch):
    """Set both packages' constants to the same values: ``set(sync_s,
    hbm)``."""
    def set_(sync_s, hbm=2.0e12):
        for mod in (policy, jpolicy):
            monkeypatch.setattr(mod, "SYNC_S", sync_s)
            monkeypatch.setattr(mod, "HBM_BYTES_PER_S", hbm)

    return set_


@pytest.mark.parametrize("sync_s", SYNC_S)
@pytest.mark.parametrize("solver", SOLVERS)
def test_prefer_one_reduce_answers_as_jax(same_constants, solver, sync_s):
    same_constants(sync_s)
    answers = set()
    for n, item, saved in itertools.product(N_LOCAL, ITEMSIZES, (1, 3)):
        want = jpolicy.prefer_one_reduce(solver, n, item, syncs_saved=saved)
        for device in ("cuda", "cpu", torch.device("cpu")):
            assert policy.prefer_one_reduce(solver, n, item, saved,
                                            device=device) == want
        answers.add(want)
    if sync_s == SYNC_S[1]:
        assert answers == {True, False}  # the grid straddles break-even


@pytest.mark.parametrize("sync_s", SYNC_S)
@pytest.mark.parametrize("rows", ROWS)
def test_fused_sharded_wins_answers_as_jax(same_constants, rows, sync_s):
    same_constants(sync_s)
    for n, item, extra in itertools.product(N_LOCAL, ITEMSIZES, (1, 2)):
        want = jpolicy.fused_sharded_wins(rows, n, item, extra_syncs=extra)
        assert policy.fused_sharded_wins(rows, n, item, extra,
                                         device="cuda") == want
    assert policy.sweep_s(1000, 8) == jpolicy.sweep_s(1000, 8)


def test_the_solvers_tables_are_jax_ratios():
    """The extra-sweep ratios of the ported solvers are the JAX
    package's; the solvers not ported yet have no entry, and price at
    CG's figure as any unknown solver does."""
    for name, ratio in policy.ONE_REDUCE_EXTRA_SWEEPS.items():
        assert jpolicy.ONE_REDUCE_EXTRA_SWEEPS[name] == ratio
    assert set(policy.ONE_REDUCE_EXTRA_SWEEPS) == {
        "cg", "minres", "deflated_cg", "deflated_minres"}


@pytest.mark.parametrize("which", ["sync", "hbm"])
def test_environment_overrides_the_table(monkeypatch, which):
    name, fn, value = {
        "sync": ("KRYPY_TPU_SYNC_S", policy.sync_s, 7.5e-5),
        "hbm": ("KRYPY_TPU_HBM_BYTES_PER_S", policy.hbm_bytes_per_s,
                1.25e11),
    }[which]
    monkeypatch.setenv(name, str(value))
    for device in (None, "cuda", "cpu"):
        assert fn(device) == value
    # the module override outranks the environment
    monkeypatch.setattr(policy, "SYNC_S" if which == "sync"
                        else "HBM_BYTES_PER_S", 3.0)
    assert fn("cpu") == 3.0


def test_table_row_follows_the_device_type(monkeypatch):
    """``"cpu"`` tensors read the CPU row (the JAX package's defaults,
    which its CPU backend reads too), CUDA tensors and an unknown type
    the card's row; no TPU row."""
    for var in ("KRYPY_TPU_SYNC_S", "KRYPY_TPU_HBM_BYTES_PER_S"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(jpolicy, "SYNC_S", None)
    monkeypatch.setattr(jpolicy, "HBM_BYTES_PER_S", None)
    assert set(policy.SYNC_S_TABLE) == set(policy.HBM_BYTES_PER_S_TABLE) \
        == {"cuda", "cpu"}
    assert policy.sync_s("cpu") == jpolicy.sync_s() == 2e-6
    assert policy.hbm_bytes_per_s(torch.device("cpu")) == \
        jpolicy.hbm_bytes_per_s() == 40e9
    for device in (None, "cuda", torch.device("cuda", 0), "mps"):
        assert policy.sync_s(device) == policy.SYNC_S_TABLE["cuda"]
        assert policy.hbm_bytes_per_s(device) == \
            policy.HBM_BYTES_PER_S_TABLE["cuda"]
