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
from torch_ref_pool import prefetch, ref, start

# (trials, nodes, fault_model, rule, freeze): N = 1024 is two full tiles,
# N = 1000 two tiles with pad lanes; every mode appears in some case
CASES = [
    (2, 1024, "crash", "reference", True),
    (3, 1000, "byzantine", "textbook", False),
    (4, 1000, "crash", "textbook", False),
    (3, 1024, "byzantine", "reference", True),
]
R = 3


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs(request):
    """Start the JAX sides ahead (torch_ref_pool)."""
    start(request)
    yield


def _kw(t, n, fault_model, seed):
    return dict(n_nodes=n, n_faulty=n // 4, trials=t, max_rounds=12,
                fault_model=fault_model, seed=seed)


def _draws(t, n, seed):
    """A random mid-run state and its faulty lanes."""
    rng = np.random.default_rng(seed)
    leaves = dict(x=rng.integers(0, 3, size=(t, n)).astype(np.int8),
                  decided=rng.random((t, n)) < 0.2,
                  k=rng.integers(0, 14, size=(t, n)).astype(np.int32),
                  killed=rng.random((t, n)) < 0.15)
    faulty = rng.random((t, n)) < 0.25
    return leaves, faulty


def _jax_setup(t, n, fault_model, seed):
    """The state packed by the JAX package + its histogram."""
    jc = JCfg(**_kw(t, n, fault_model, seed))
    leaves, faulty = _draws(t, n, seed)
    jst = jstate.NetState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    jpack = jround.pack_state(jc, jst, jnp.asarray(faulty))
    jhist = jround.sent_hist_from_pack(jc, jpack, None, None, R, SINGLE)
    return jc, jpack, jhist


def _jax_setup_out(t, n, fault_model, seed):
    """``_jax_setup``'s pack and histogram (a worker's call, see
    torch_ref_pool)."""
    _, jpack, jhist = _jax_setup(t, n, fault_model, seed)
    return np.asarray(jpack), np.asarray(jhist)


def _setup(t, n, fault_model, seed):
    """The state packed by the port + its histogram, both equal to the JAX
    package's."""
    tc = TCfg(**_kw(t, n, fault_model, seed))
    leaves, faulty = _draws(t, n, seed)
    tpack = tround.pack_state(tc, convert.state_from_numpy(**leaves),
                              torch.from_numpy(faulty))
    jpack, jhist = ref(_jax_setup_out, t, n, fault_model, seed)
    np.testing.assert_array_equal(convert.pack_to_numpy(tpack), jpack)
    thist = tround.sent_hist_from_pack(tc, tpack)
    np.testing.assert_array_equal(thist.numpy(), jhist)
    return tc, tpack, thist


def _jax_proposal(t, n, fault_model, rule, freeze):
    """The JAX package's proposal kernel in interpret mode (a worker's
    call, see torch_ref_pool)."""
    jc, jpack, jhist = _jax_setup(t, n, fault_model, 10 + t)
    return np.asarray(jround.proposal_hist_pallas(
        jax.random.key(jc.seed), R, jrng.PHASE_PROPOSAL, jhist, jpack, None,
        jc.quorum, fault_model, freeze, interpret=True))


@pytest.mark.parametrize("t,n,fault_model,rule,freeze", CASES)
@prefetch(lambda t, n, fault_model, rule, freeze: [
    (_jax_setup_out, t, n, fault_model, 10 + t),
    (_jax_proposal, t, n, fault_model, rule, freeze)])
def test_proposal_hist_matches_pallas(t, n, fault_model, rule, freeze):
    tc, tpack, thist = _setup(t, n, fault_model, 10 + t)
    jparts = ref(_jax_proposal, t, n, fault_model, rule, freeze)
    tparts = tround.proposal_hist(tc.seed, R, trng.PHASE_PROPOSAL, thist,
                                  tpack, tc.quorum, fault_model, freeze)
    assert tparts.dtype == torch.int32
    np.testing.assert_array_equal(tparts.numpy(),
                                  jparts[:, :tround.PROP_COLS])


def _vote_draws(t, n):
    """A vote histogram and quorum gate with both verdicts across
    trials."""
    rng = np.random.default_rng(t)
    hist2 = rng.integers(0, n // 2, size=(t, 3)).astype(np.int32)
    qok = np.arange(t) % 3 != 2
    return hist2, qok


def _jax_vote(t, n, fault_model, rule, freeze):
    """The JAX package's vote kernel in interpret mode (a worker's call,
    see torch_ref_pool)."""
    jc, jpack, _ = _jax_setup(t, n, fault_model, 20 + t)
    hist2, qok = _vote_draws(t, n)
    jpack2, jparts = jround.vote_commit_pallas(
        jax.random.key(jc.seed), R, jrng.PHASE_VOTE, jnp.asarray(hist2),
        jpack, None, jnp.asarray(qok), jnp.zeros((t,), jnp.int32),
        jc.quorum, jc.n_faulty, rule, "private", 0.0, freeze, fault_model,
        interpret=True)
    return np.asarray(jpack2), np.asarray(jparts)


@pytest.mark.parametrize("t,n,fault_model,rule,freeze", CASES)
@prefetch(lambda t, n, fault_model, rule, freeze: [
    (_jax_setup_out, t, n, fault_model, 20 + t),
    (_jax_vote, t, n, fault_model, rule, freeze)])
def test_vote_commit_matches_pallas(t, n, fault_model, rule, freeze):
    tc, tpack, _ = _setup(t, n, fault_model, 20 + t)
    hist2, qok = _vote_draws(t, n)
    jpack2, jparts = ref(_jax_vote, t, n, fault_model, rule, freeze)
    tpack2, tparts = tround.vote_commit(
        tc.seed, R, trng.PHASE_VOTE, torch.from_numpy(hist2), tpack,
        torch.from_numpy(qok), tc.quorum, tc.n_faulty, rule, fault_model,
        freeze)
    np.testing.assert_array_equal(convert.pack_to_numpy(tpack2), jpack2)
    np.testing.assert_array_equal(tparts.numpy(),
                                  jparts[:, :tround.VOTE_COLS])


def _jax_fused(t, n, fault_model, rule, freeze):
    """The JAX package's fused kernel in interpret mode (a worker's call,
    see torch_ref_pool)."""
    jc, jpack, jhist = _jax_setup(t, n, fault_model, 30 + t)
    jout = jround.fused_round_pallas(
        jax.random.key(jc.seed), R, jhist, jpack, None,
        jnp.zeros((t,), jnp.int32), jc.quorum, jc.n_faulty, rule, "private",
        0.0, freeze, fault_model, interpret=True)
    return [np.asarray(o) for o in jout[:3]]


@pytest.mark.parametrize("t,n,fault_model,rule,freeze", CASES)
@prefetch(lambda t, n, fault_model, rule, freeze: [
    (_jax_setup_out, t, n, fault_model, 30 + t),
    (_jax_fused, t, n, fault_model, rule, freeze)])
def test_fused_round_matches_pallas_and_two_kernel(t, n, fault_model, rule,
                                                   freeze):
    tc, tpack, thist = _setup(t, n, fault_model, 30 + t)
    jout = ref(_jax_fused, t, n, fault_model, rule, freeze)
    tpack2, tparts_a, tparts_b = tround.fused_round(
        tc.seed, R, thist, tpack, tc.quorum, tc.n_faulty, rule, fault_model,
        freeze)
    np.testing.assert_array_equal(convert.pack_to_numpy(tpack2), jout[0])
    np.testing.assert_array_equal(tparts_a.numpy(),
                                  jout[1][:, :tround.PROP_COLS])
    np.testing.assert_array_equal(tparts_b.numpy(),
                                  jout[2][:, :tround.VOTE_COLS])

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


@prefetch(lambda: [(_jax_setup_out, 2, 1000, "crash", 5)])
def test_cpu_wrappers_never_count_launches():
    """On CPU tensors the wrappers run the plain versions and count no
    kernel launch."""
    tround.reset_launches()
    tc, tpack, thist = _setup(2, 1000, "crash", 5)
    tround.proposal_hist(tc.seed, R, 0, thist, tpack, tc.quorum, "crash",
                         True)
    tround.fused_round(tc.seed, R, thist, tpack, tc.quorum, tc.n_faulty,
                       "reference", "crash", True)
    assert {k: f.launches for k, f in tround.KERNELS.items()} == \
        dict.fromkeys(tround.KERNELS, 0)


@prefetch(lambda: [(_jax_setup_out, 2, 1000, "crash", 6)])
def test_wrappers_refuse_other_devices_and_modes():
    tc, tpack, thist = _setup(2, 1000, "crash", 6)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tround.proposal_hist(tc.seed, R, 0, thist, tpack.to("meta"),
                             tc.quorum, "crash", True)
    with pytest.raises(ValueError, match="needs crash_round"):
        tround.fused_round(tc.seed, R, thist, tpack, tc.quorum, tc.n_faulty,
                           "reference", "crash_at_round", True)
    with pytest.raises(ValueError, match="unknown fault_model"):
        tround.proposal_hist(tc.seed, R, 0, thist, tpack, tc.quorum,
                             "meltdown", True)


def test_wrappers_run_equivocate():
    """The equivocate fault model runs through the round kernels' wrappers
    (the mixed-population draws, given the live equivocators)."""
    tc, tpack, _ = _setup(2, 1000, "crash", 6)
    ne = torch.tensor([200, 3], dtype=torch.int32)
    hist = torch.tensor([[300, 250, 100], [10, 600, 40]], dtype=torch.int32)
    new_pack, parts_a, parts_b = tround.fused_round(
        tc.seed, R, hist, tpack, tc.quorum, tc.n_faulty, "reference",
        "equivocate", True, n_equiv=ne)
    assert new_pack.shape == tpack.shape
    assert parts_a.shape == (2, tround.PROP_COLS)
    assert parts_b.shape == (2, tround.VOTE_COLS)
