"""The port's three round kernels (their plain versions, which the wrappers
run on CPU tensors) against the JAX package's Pallas kernels in interpret
mode: same pack, histogram and key -> exactly equal summed partials and
new plane stacks; and, inside the port, the fused round equal to
proposal + sum + vote bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benor_tpu import state as jstate
from benor_tpu.config import SimConfig as JCfg
from benor_tpu.ops import pallas_round as jround
from benor_tpu.ops import rng as jrng
from benor_tpu.ops.collectives import SINGLE
from benor_tpu_torch import convert
from benor_tpu_torch.config import SimConfig as TCfg
from benor_tpu_torch.ops import packed_round as tround
from benor_tpu_torch.ops import rng as trng

# (trials, nodes, fault_model, rule, freeze): N = 1024 is two full tiles,
# N = 1000 two tiles with pad lanes; every mode appears in some case
CASES = [
    (2, 1024, "crash", "reference", True),
    (3, 1000, "byzantine", "textbook", False),
    (4, 1000, "crash", "textbook", False),
    (3, 1024, "byzantine", "reference", True),
]
R = 3


def _setup(t, n, fault_model, seed):
    """A random mid-run state packed by both packages + its histogram."""
    rng = np.random.default_rng(seed)
    kw = dict(n_nodes=n, n_faulty=n // 4, trials=t, max_rounds=12,
              fault_model=fault_model, seed=seed)
    jc, tc = JCfg(**kw), TCfg(**kw)
    leaves = dict(x=rng.integers(0, 3, size=(t, n)).astype(np.int8),
                  decided=rng.random((t, n)) < 0.2,
                  k=rng.integers(0, 14, size=(t, n)).astype(np.int32),
                  killed=rng.random((t, n)) < 0.15)
    faulty = rng.random((t, n)) < 0.25
    jst = jstate.NetState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    jpack = jround.pack_state(jc, jst, jnp.asarray(faulty))
    tpack = tround.pack_state(tc, convert.state_from_numpy(**leaves),
                              torch.from_numpy(faulty))
    np.testing.assert_array_equal(convert.pack_to_numpy(tpack),
                                  np.asarray(jpack))
    jhist = jround.sent_hist_from_pack(jc, jpack, None, None, R, SINGLE)
    thist = tround.sent_hist_from_pack(tc, tpack)
    np.testing.assert_array_equal(thist.numpy(), np.asarray(jhist))
    return jc, tc, jpack, tpack, jhist, thist


@pytest.mark.parametrize("t,n,fault_model,rule,freeze", CASES)
def test_proposal_hist_matches_pallas(t, n, fault_model, rule, freeze):
    jc, tc, jpack, tpack, jhist, thist = _setup(t, n, fault_model, 10 + t)
    jparts = jround.proposal_hist_pallas(
        jax.random.key(jc.seed), R, jrng.PHASE_PROPOSAL, jhist, jpack, None,
        jc.quorum, fault_model, freeze, interpret=True)
    tparts = tround.proposal_hist(tc.seed, R, trng.PHASE_PROPOSAL, thist,
                                  tpack, tc.quorum, fault_model, freeze)
    assert tparts.dtype == torch.int32
    np.testing.assert_array_equal(tparts.numpy(),
                                  np.asarray(jparts)[:, :tround.PROP_COLS])


@pytest.mark.parametrize("t,n,fault_model,rule,freeze", CASES)
def test_vote_commit_matches_pallas(t, n, fault_model, rule, freeze):
    jc, tc, jpack, tpack, jhist, thist = _setup(t, n, fault_model, 20 + t)
    # a vote histogram and quorum gate with both verdicts across trials
    rng = np.random.default_rng(t)
    hist2 = rng.integers(0, n // 2, size=(t, 3)).astype(np.int32)
    qok = np.arange(t) % 3 != 2
    jpack2, jparts = jround.vote_commit_pallas(
        jax.random.key(jc.seed), R, jrng.PHASE_VOTE, jnp.asarray(hist2),
        jpack, None, jnp.asarray(qok), jnp.zeros((t,), jnp.int32),
        jc.quorum, jc.n_faulty, rule, "private", 0.0, freeze, fault_model,
        interpret=True)
    tpack2, tparts = tround.vote_commit(
        tc.seed, R, trng.PHASE_VOTE, torch.from_numpy(hist2), tpack,
        torch.from_numpy(qok), tc.quorum, tc.n_faulty, rule, fault_model,
        freeze)
    np.testing.assert_array_equal(convert.pack_to_numpy(tpack2),
                                  np.asarray(jpack2))
    np.testing.assert_array_equal(tparts.numpy(),
                                  np.asarray(jparts)[:, :tround.VOTE_COLS])


@pytest.mark.parametrize("t,n,fault_model,rule,freeze", CASES)
def test_fused_round_matches_pallas_and_two_kernel(t, n, fault_model, rule,
                                                   freeze):
    jc, tc, jpack, tpack, jhist, thist = _setup(t, n, fault_model, 30 + t)
    jout = jround.fused_round_pallas(
        jax.random.key(jc.seed), R, jhist, jpack, None,
        jnp.zeros((t,), jnp.int32), jc.quorum, jc.n_faulty, rule, "private",
        0.0, freeze, fault_model, interpret=True)
    tpack2, tparts_a, tparts_b = tround.fused_round(
        tc.seed, R, thist, tpack, tc.quorum, tc.n_faulty, rule, fault_model,
        freeze)
    np.testing.assert_array_equal(convert.pack_to_numpy(tpack2),
                                  np.asarray(jout[0]))
    np.testing.assert_array_equal(tparts_a.numpy(),
                                  np.asarray(jout[1])[:, :tround.PROP_COLS])
    np.testing.assert_array_equal(tparts_b.numpy(),
                                  np.asarray(jout[2])[:, :tround.VOTE_COLS])

    # inside the port: fused == proposal + sum + vote, bit for bit
    parts_a = tround.proposal_hist(tc.seed, R, trng.PHASE_PROPOSAL, thist,
                                   tpack, tc.quorum, fault_model, freeze)
    two_pack, two_b = tround.vote_commit(
        tc.seed, R, trng.PHASE_VOTE, parts_a[:, :3], tpack,
        parts_a[:, 3] >= tc.quorum, tc.quorum, tc.n_faulty, rule,
        fault_model, freeze)
    assert torch.equal(parts_a, tparts_a)
    assert torch.equal(two_pack, tpack2)
    assert torch.equal(two_b, tparts_b)


def test_cpu_wrappers_never_count_launches():
    """On CPU tensors the wrappers run the plain versions and count no
    kernel launch."""
    tround.reset_launches()
    _, tc, _, tpack, _, thist = _setup(2, 1000, "crash", 5)
    tround.proposal_hist(tc.seed, R, 0, thist, tpack, tc.quorum, "crash",
                         True)
    tround.fused_round(tc.seed, R, thist, tpack, tc.quorum, tc.n_faulty,
                       "reference", "crash", True)
    assert {k: f.launches for k, f in tround.KERNELS.items()} == \
        dict.fromkeys(tround.KERNELS, 0)


def test_wrappers_refuse_other_devices_and_modes():
    _, tc, _, tpack, _, thist = _setup(2, 1000, "crash", 6)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tround.proposal_hist(tc.seed, R, 0, thist, tpack.to("meta"),
                             tc.quorum, "crash", True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tround.fused_round(tc.seed, R, thist, tpack, tc.quorum, tc.n_faulty,
                           "reference", "crash_at_round", True)


def test_wrappers_run_equivocate():
    """The equivocate fault model runs through the round kernels' wrappers
    (the mixed-population draws, given the live equivocators)."""
    _, tc, _, tpack, _, _ = _setup(2, 1000, "crash", 6)
    ne = torch.tensor([200, 3], dtype=torch.int32)
    hist = torch.tensor([[300, 250, 100], [10, 600, 40]], dtype=torch.int32)
    new_pack, parts_a, parts_b = tround.fused_round(
        tc.seed, R, hist, tpack, tc.quorum, tc.n_faulty, "reference",
        "equivocate", True, n_equiv=ne)
    assert new_pack.shape == tpack.shape
    assert parts_a.shape == (2, tround.PROP_COLS)
    assert parts_b.shape == (2, tround.VOTE_COLS)
