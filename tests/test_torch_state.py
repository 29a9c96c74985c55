"""benor_tpu_torch's state, layout tables and bit-plane pack against
benor_tpu's: tables equal, packs equal word for word, round trips."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benor_tpu import state as jstate
from benor_tpu.config import SimConfig as JCfg
from benor_tpu.ops import pallas_hist as jhist
from benor_tpu.ops import pallas_round as jround
from benor_tpu.ops.collectives import SINGLE
from benor_tpu_torch import convert
from benor_tpu_torch import state as tstate
from benor_tpu_torch.config import SimConfig as TCfg
from benor_tpu_torch.ops import packed_round as tround
from benor_tpu_torch.ops import stream as tstream
from torch_ref_pool import prefetch, ref, start


def test_layout_tables_match():
    assert tstate.PACK_LAYOUT == jstate.PACK_LAYOUT
    assert tstate.PACK_EXTRA_FIELDS == jstate.PACK_EXTRA_FIELDS
    for name in ("PACK_X", "PACK_DECIDED", "PACK_KILLED", "PACK_COINED",
                 "PACK_FAULTY", "PACK_DOWN", "PACK_K", "PACK_K_MAX_BITS",
                 "PACK_STATIC_WIDTH", "PACK_NODES_PER_WORD"):
        assert getattr(tstate, name) == getattr(jstate, name), name
    assert tround.PROP_PARTIAL_LAYOUT == jround.PROP_PARTIAL_LAYOUT
    assert tround.VOTE_PARTIAL_LAYOUT == jround.VOTE_PARTIAL_LAYOUT
    assert tround.FUSED_ONE_PASS_MAX_NODES == jround.FUSED_ONE_PASS_MAX_NODES
    assert tround.FUSED_ONE_PASS_MAX_LANES == jround.FUSED_ONE_PASS_MAX_LANES
    assert tstream.TILE_N == jhist.TILE_N
    assert tstream._COIN_SALT == jhist._COIN_SALT
    assert tstream._EQUIV_SALT_OFFSET == jhist._EQUIV_SALT_OFFSET
    for mr in (1, 6, 12, 64, 200, 40000):
        assert tstate.pack_k_bits_for(mr) == jstate.pack_k_bits_for(mr)
        kw = dict(n_nodes=8, n_faulty=0, max_rounds=mr)
        assert tstate.pack_width(TCfg(**kw)) == jstate.pack_width(JCfg(**kw))


@pytest.mark.parametrize("t,n", [(3, 31), (4, 96), (2, 1000), (1, 1025)])
def test_fused_one_pass_eligible_matches(t, n):
    for kw in (dict(), dict(scheduler="adversarial"), dict(trials=64)):
        base = dict(n_nodes=n, n_faulty=n // 4, delivery="quorum", **kw)
        jc, tc = JCfg(**base), TCfg(**base)
        assert tround.fused_one_pass_eligible(tc, t, n) == \
            jround.fused_one_pass_eligible(jc, t, n)
    for nn in (8192, 8193, 16384):
        cfg = dict(n_nodes=nn, n_faulty=0)
        for tt in (1, 32, 33):
            assert tround.fused_one_pass_eligible(TCfg(**cfg), tt, nn) == \
                jround.fused_one_pass_eligible(JCfg(**cfg), tt, nn)


def _random_leaves(rng, t, n, max_k):
    return dict(x=rng.integers(0, 3, size=(t, n)).astype(np.int8),
                decided=rng.integers(0, 2, size=(t, n)).astype(bool),
                k=rng.integers(0, max_k + 1, size=(t, n)).astype(np.int32),
                killed=rng.integers(0, 2, size=(t, n)).astype(bool))


def _jax_state(leaves):
    return jstate.NetState(x=jnp.asarray(leaves["x"]),
                           decided=jnp.asarray(leaves["decided"]),
                           k=jnp.asarray(leaves["k"]),
                           killed=jnp.asarray(leaves["killed"]))


@pytest.fixture(scope="module", autouse=True)
def _reference_ahead(request):
    """Start the JAX sides ahead (torch_ref_pool)."""
    start(request)


_PACK_MODELS = ("crash", "byzantine")
_PACK_ROUNDS = 37


def _pack_draws(t, n):
    """The random leaves and faulty lanes of each fault model's state."""
    rng = np.random.default_rng(100 * t + n)
    out = []
    for _ in _PACK_MODELS:
        leaves = _random_leaves(rng, t, n, _PACK_ROUNDS + 1)
        faulty = rng.integers(0, 2, size=(t, n)).astype(bool)
        out.append((leaves, faulty))
    return out


def _jax_packs(t, n):
    """The JAX package's pack of each state and the proposal histogram
    read off it, op by op (a worker's call, see torch_ref_pool)."""
    jc = JCfg(n_nodes=n, n_faulty=0, trials=t, max_rounds=_PACK_ROUNDS)
    out = []
    for fault_model, (leaves, faulty) in zip(_PACK_MODELS,
                                             _pack_draws(t, n)):
        jpack = jround.pack_state(jc, _jax_state(leaves), jnp.asarray(faulty))
        jh = jround.sent_hist_from_pack(jc.replace(fault_model=fault_model),
                                        jpack, None, None, 1, SINGLE)
        out.append((np.asarray(jpack), np.asarray(jh)))
    return out


@pytest.mark.parametrize("t,n", [(1, 1), (3, 31), (2, 70), (4, 96),
                                 (2, 1000), (1, 1025)])
@prefetch(lambda t, n: [(_jax_packs, t, n)])
def test_pack_state_word_for_word(t, n):
    """Random states, pad lanes included (N not a multiple of 512): the
    port's plane stack equals the JAX pack word for word, unpacks to the
    same state, and the proposal histogram read off it agrees."""
    tc = TCfg(n_nodes=n, n_faulty=0, trials=t, max_rounds=_PACK_ROUNDS)
    for fault_model, (leaves, faulty), (jpack, jh) in zip(
            _PACK_MODELS, _pack_draws(t, n), ref(_jax_packs, t, n)):
        tpack = tround.pack_state(tc, convert.state_from_numpy(**leaves),
                                  torch.from_numpy(faulty))
        np.testing.assert_array_equal(convert.pack_to_numpy(tpack), jpack)
        back = convert.state_to_numpy(tround.unpack_state(tpack, n))
        for name, arr in leaves.items():
            np.testing.assert_array_equal(back[name], arr, err_msg=name)
        tc2 = tc.replace(fault_model=fault_model)
        np.testing.assert_array_equal(
            tround.sent_hist_from_pack(tc2, tpack).numpy(), jh)
        unsettled = int(np.sum(~(leaves["decided"] | leaves["killed"])))
        assert int(tround.unsettled_from_pack(tpack)) == unsettled


def test_convert_round_trips():
    rng = np.random.default_rng(5)
    leaves = _random_leaves(rng, 3, 40, 9)
    st = convert.state_from_numpy(**leaves)
    assert (st.x.dtype, st.decided.dtype, st.k.dtype, st.killed.dtype) == \
        (torch.int8, torch.bool, torch.int32, torch.bool)
    out = convert.state_to_numpy(st)
    for name, arr in leaves.items():
        np.testing.assert_array_equal(out[name], arr)
        assert out[name].dtype == arr.dtype
    # JAX leaves -> port -> numpy is the identity too
    jst = _jax_state(leaves)
    st2 = convert.state_from_numpy(*(np.asarray(getattr(jst, f))
                                     for f in ("x", "decided", "k",
                                               "killed")))
    for name, arr in convert.state_to_numpy(st2).items():
        np.testing.assert_array_equal(arr, leaves[name])
    cr = rng.integers(0, 5, size=(3, 40)).astype(np.int32)
    fs = convert.faults_from_numpy(leaves["killed"], cr, cr + 1)
    np.testing.assert_array_equal(fs.faulty.numpy(), leaves["killed"])
    np.testing.assert_array_equal(fs.crash_round.numpy(), cr)
    np.testing.assert_array_equal(fs.recover_round.numpy(), cr + 1)
    assert convert.faults_from_numpy(leaves["killed"], cr).recover_round \
        is None


@pytest.mark.parametrize("fault_model", ["crash", "byzantine"])
def test_faults_and_init_state_match(fault_model):
    t, n, f = 3, 20, 5
    kw = dict(n_nodes=n, n_faulty=f, trials=t, fault_model=fault_model)
    jc, tc = JCfg(**kw), TCfg(**kw)
    fl = [True] * f + [False] * (n - f)
    vals = np.random.default_rng(1).integers(0, 3, size=(t, n))
    for jf, tf in ((jstate.FaultSpec.from_faulty_list(jc, fl),
                    tstate.FaultSpec.from_faulty_list(tc, fl)),
                   (jstate.FaultSpec.first_f(jc), tstate.FaultSpec.first_f(tc)),
                   (jstate.FaultSpec.none(t, n), tstate.FaultSpec.none(t, n))):
        np.testing.assert_array_equal(tf.faulty.numpy(), np.asarray(jf.faulty))
        np.testing.assert_array_equal(tf.crash_round.numpy(),
                                      np.asarray(jf.crash_round))
        js = jstate.init_state(jc, vals, jf)
        ts = tstate.init_state(tc, vals, tf)
        for name in ("x", "decided", "k", "killed"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          np.asarray(getattr(js, name)))
    with pytest.raises(ValueError, match="F faulties"):
        tstate.FaultSpec.from_faulty_list(tc, [True] * n)
    with pytest.raises(ValueError):
        tstate.init_state(tc, [5] * n, tstate.FaultSpec.none(t, n))
    mixed = [0, 1, "?", 1] * 5
    np.testing.assert_array_equal(
        tstate.init_state(tc, mixed, tstate.FaultSpec.none(t, n)).x.numpy(),
        np.asarray(jstate.init_state(jc, mixed,
                                     jstate.FaultSpec.none(t, n)).x))


@pytest.mark.parametrize("form", ["int8_tn", "bool_n", "uint16_n",
                                  "int16_258", "float_n", "shape_tn1"])
def test_init_state_input_forms_match(form):
    """The values are checked and broadcast on the device: each input form
    gives the JAX package's x, or raises where it raises, and the state
    never aliases the caller's array."""
    t, n = 3, 8
    jc, tc = JCfg(n_nodes=n, n_faulty=0, trials=t), \
        TCfg(n_nodes=n, n_faulty=0, trials=t)
    rng = np.random.default_rng(7)
    vals = {"int8_tn": rng.integers(0, 3, size=(t, n)).astype(np.int8),
            "bool_n": rng.integers(0, 2, size=n).astype(bool),
            "uint16_n": rng.integers(0, 3, size=n).astype(np.uint16),
            "int16_258": np.full(n, 258, dtype=np.int16),   # 2 if narrowed
            "float_n": rng.integers(0, 2, size=n).astype(np.float64),
            "shape_tn1": np.zeros((t, n + 1), dtype=np.int8)}[form]
    jf, tf = jstate.FaultSpec.none(t, n), tstate.FaultSpec.none(t, n)
    try:
        want = np.asarray(jstate.init_state(jc, vals, jf).x)
    except ValueError:
        with pytest.raises(ValueError):
            tstate.init_state(tc, vals, tf)
        return
    x = tstate.init_state(tc, vals, tf).x
    assert x.dtype == torch.int8 and x.is_contiguous()
    np.testing.assert_array_equal(x.numpy(), want)
    assert not np.shares_memory(vals, x.numpy())
