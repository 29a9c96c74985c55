"""The dense tally: benor_tpu_torch.ops.dense (the kernel's plain version and
its wrapper) and benor_tpu_torch.ops.tally.dense_counts (the matrix-product
route) against benor_tpu.ops.tally.dense_counts and against
dense_counts_pallas in interpret mode, on the same numpy-made mask, sent and
alive.  Integer counts: exact equality.  The JAX functions run jitted on
numpy inputs (one XLA compile a shape)."""

import numpy as np
import pytest
import torch

import jax

from benor_tpu.ops.pallas_tally import dense_counts_pallas
from benor_tpu.ops.tally import dense_counts as j_dense_counts
from benor_tpu_torch import convert
from benor_tpu_torch.ops import _build
from benor_tpu_torch.ops import dense as tdense
from benor_tpu_torch.ops import tally as ttally

J_DENSE_COUNTS = jax.jit(j_dense_counts)


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs():
    """Every XLA:CPU executable keeps memory maps, and a test process that
    holds too many dies in a later compile: drop this module's when it is
    done."""
    yield
    jax.clear_caches()

SHAPES = [(2, 64, 64), (1, 128, 128), (3, 120, 120), (2, 40, 72)]


def _case(seed, t, n_recv, n_send):
    rs = np.random.default_rng(seed)
    mask = rs.random((t, n_recv, n_send)) < 0.7
    sent = rs.integers(0, 3, (t, n_send)).astype(np.int8)
    alive = rs.random((t, n_send)) < 0.9
    return mask, sent, alive


def _torch(mask, sent, alive):
    return (convert.mask_from_numpy(mask), torch.from_numpy(sent),
            torch.from_numpy(alive))


ROUTES = {"plain": tdense.dense_counts_plain, "wrapper": tdense.dense_counts,
          "matmul": ttally.dense_counts}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_dense_counts_match_jax(shape, route):
    mask, sent, alive = _case(sum(shape), *shape)
    got = ROUTES[route](*_torch(mask, sent, alive))
    assert got.dtype == torch.int32 and tuple(got.shape) == (*shape[:2], 3)
    want = np.asarray(J_DENSE_COUNTS(mask, sent, alive))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_pallas_kernel_in_interpret_mode(shape):
    mask, sent, alive = _case(sum(shape) + 1, *shape)
    want = np.asarray(dense_counts_pallas(mask, sent, alive,
                                          interpret=True))
    got = tdense.dense_counts_plain(*_torch(mask, sent, alive))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_counts_respect_alive_and_mask(route):
    """All-ones mask, five 1-senders of which one is dead."""
    mask = np.ones((1, 8, 16), bool)
    sent = np.zeros((1, 16), np.int8)
    sent[0, :5] = 1
    alive = np.ones((1, 16), bool)
    alive[0, 0] = False
    out = ROUTES[route](*_torch(mask, sent, alive)).numpy()
    want = np.asarray(dense_counts_pallas(mask, sent, alive,
                                          interpret=True))
    np.testing.assert_array_equal(out, want)
    assert (out[0, :, 1] == 4).all()      # 5 ones minus the dead one
    assert (out[0, :, 0] == 11).all()
    assert (out[0, :, 2] == 0).all()


def test_plain_passes_over_receivers_and_ignores_foreign_values(monkeypatch):
    """A pass size that splits the receivers unevenly moves no count, and a
    sent value outside {0, 1, 2} counts nowhere."""
    mask, sent, alive = _case(5, 2, 37, 50)
    sent[:, ::7] = 3
    whole = tdense.dense_counts_plain(*_torch(mask, sent, alive))
    monkeypatch.setattr(tdense, "PLAIN_CHUNK", 2 * 50 * 5)
    parts = tdense.dense_counts_plain(*_torch(mask, sent, alive))
    assert torch.equal(whole, parts)
    live = mask & (alive & (sent != 3))[:, None, :]
    np.testing.assert_array_equal(whole.sum(-1).numpy(), live.sum(-1))


def test_wrapper_launches_no_kernel_on_cpu_operands():
    tdense.reset_launches()
    tdense.dense_counts(*_torch(*_case(0, 2, 16, 16)))
    assert tdense.dense_counts.launches == 0
    assert tdense.KERNELS == {"dense_counts": tdense.dense_counts}


def test_wrapper_refuses_other_devices():
    mask, sent, alive = (x.to("meta") for x in _torch(*_case(0, 1, 4, 4)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tdense.dense_counts(mask, sent, alive)


def test_kernel_entry_point_is_declared_and_has_a_source():
    assert "benor_dense_counts" in _build.SIGNATURES
    src = (_build.CSRC / "tally_kernels.cu").read_text()
    assert 'extern "C" int benor_dense_counts(' in src
    n_args = src.split("benor_dense_counts(")[1].split(")")[0].count(",") + 1
    assert len(_build.SIGNATURES["benor_dense_counts"]) == n_args
