"""The parity facade on the port: benor_tpu_torch.launch_network /
TpuNetwork / observable_state against the JAX package's, on the CPU.

Every scenario of tests/test_scenarios.py (the reference's integration-test
contract) runs on the port's ``launch_network(..., device="cpu")`` with its
verdicts, and its ``get_states`` equal the JAX ``TpuNetwork``'s state for
state; ``poll_rounds`` slicing equals the one-shot run; stop, stop_node and
status behave as in the reference; what is not ported raises, naming its
ROADMAP item."""

import numpy as np
import pytest
import torch

import jax

import benor_tpu_torch as bt
from benor_tpu import api as japi
from benor_tpu.backends.tpu import TpuNetwork as JTpuNetwork
from benor_tpu.config import SimConfig as JCfg
from benor_tpu.state import observable_state as j_observable_state
from benor_tpu_torch import api as tapi


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs():
    """Every XLA:CPU executable keeps memory maps, and a test process that
    holds too many dies in a later compile: drop this module's when it is
    done."""
    yield
    jax.clear_caches()


def _launch(api, faulty, values, **kw):
    if api is tapi:
        kw["device"] = "cpu"
    return api.launch_network(len(faulty), sum(faulty), values, faulty,
                              backend="tpu", **kw)


def _run_both(faulty, values, **kw):
    """The scenario on both packages -> the port's states (equal to the
    JAX package's, state for state)."""
    out = []
    for api in (japi, tapi):
        net = _launch(api, faulty, values, **kw)
        api.start_consensus(net)
        out.append((net.rounds_executed, api.get_nodes_state(net)))
        net.close()
    (j_rounds, j_states), (t_rounds, t_states) = out
    assert t_rounds == j_rounds
    assert t_states == j_states
    return t_states


def _assert_faulty_null(state):
    assert state["decided"] is None
    assert state["x"] is None
    assert state["k"] is None


# --- the scenarios of tests/test_scenarios.py (test.ts:45-492) ---------------


@pytest.mark.parametrize("faulty", [
    [True, False, False],
    [True, False, False, False, False, True, False, False, False, False],
], ids=["2_healthy_1_faulty", "8_healthy_2_faulty"])
def test_status(faulty):
    net = _launch(tapi, faulty, [1] * len(faulty))
    for i, f in enumerate(faulty):
        assert net.status(i) == (("faulty", 500) if f else ("live", 200))
    net.close()


def test_unanimous_agreement():
    states = _run_both([False] * 5, [1] * 5)
    assert bt.api.reached_finality(states)
    for st in states:
        assert st["decided"] is True and st["x"] == 1 and st["k"] <= 2


def test_simple_majority():
    faulty = [False, False, False, False, True]
    states = _run_both(faulty, [1, 1, 1, 0, 0])
    for st, f in zip(states, faulty):
        if f:
            _assert_faulty_null(st)
        else:
            assert st["decided"] is True and st["x"] == 1 and st["k"] <= 2


def test_fault_tolerance_threshold():
    faulty = [True] * 4 + [False] * 5
    states = _run_both(faulty, [0, 0, 1, 1, 1, 0, 0, 1, 1])
    live = [st for st, f in zip(states, faulty) if not f]
    for st, f in zip(states, faulty):
        if f:
            _assert_faulty_null(st)
    assert all(st["decided"] is True and st["k"] is not None for st in live)
    assert len({st["x"] for st in live}) == 1


def test_exceeding_fault_tolerance_livelock():
    faulty = [True] * 5 + [False] * 5
    states = _run_both(faulty, [0, 0, 1, 1, 1, 0, 0, 1, 1, 0],
                       max_rounds=15)
    for st, f in zip(states, faulty):
        if f:
            _assert_faulty_null(st)
        else:
            assert st["decided"] is not True
            assert st["k"] > 10 and st["x"] is not None


def test_no_faulty_nodes():
    states = _run_both([False] * 5, [0, 1, 0, 1, 1])
    for st in states:
        assert st["decided"] is True and st["x"] == 1 and st["k"] <= 2


def test_randomized():
    rng = np.random.default_rng(42)
    faulty = [False, False, True, False, True, False, False]
    values = [int(v) for v in rng.integers(0, 2, size=7)]
    states = _run_both(faulty, values)
    live = [st for st, f in zip(states, faulty) if not f]
    assert all(st["decided"] is True for st in live)
    assert len({st["x"] for st in live}) == 1


def test_one_node():
    states = _run_both([False], [1])
    assert states == [{"killed": False, "x": 1, "decided": True, "k": 2}]


def test_stop_consensus_kills_all():
    net = _launch(tapi, [False] * 3, [1, 1, 1])
    tapi.start_consensus(net)
    tapi.stop_consensus(net)
    assert [net.status(i) for i in range(3)] == [("faulty", 500)] * 3
    st = net.get_state(0)
    assert st["killed"] is True and st["x"] is not None


# --- the facade beyond the scenarios -----------------------------------------


def test_default_config_facade_matches_jax():
    """The upstream repo's own use case: N = 10 launched with SimConfig's
    defaults, started, read node by node and in bulk."""
    faulty = [True] * 4 + [False] * 6
    values = [0, 0, 1, 1, 1, 0, 0, 1, 1, 1]
    states = _run_both(faulty, values)
    net = _launch(tapi, faulty, values)
    assert net.cfg == bt.SimConfig(n_nodes=10, n_faulty=4)
    assert [net.get_state(i) for i in range(10)] == net.get_states() == \
        [{"killed": True, "x": None, "decided": None, "k": None}] * 4 + \
        [{"killed": False, "x": v, "decided": False, "k": 0}
         for v in values[4:]]
    net.start()
    assert net.get_states() == states
    assert bt.api.reached_finality(states)


def test_crash_at_round_facade_matches_jax():
    """Faulty nodes that die mid-run (crash_at_round, rounds 2 and 3):
    ``launch_network(..., crash_rounds=...)`` on the port against the JAX
    ``TpuNetwork`` with the same crash rounds, state for state; the dead
    nodes report killed with their last state, the live ones decide."""
    faulty = [True] * 4 + [False] * 6
    values = [0, 1] * 5
    crash = [2, 2, 3, 3] + [0] * 6
    jnet = JTpuNetwork(JCfg(n_nodes=10, n_faulty=4,
                            fault_model="crash_at_round"), values, faulty,
                       crash_rounds=crash)
    tnet = _launch(tapi, faulty, values, fault_model="crash_at_round",
                   crash_rounds=crash)
    for net in (jnet, tnet):
        net.start()
    assert tnet.rounds_executed == jnet.rounds_executed >= 2
    states = tnet.get_states()
    assert states == jnet.get_states()
    # a node is killed from its crash round on, and reports its state
    assert [st["killed"] for st in states] == \
        [0 < c <= tnet.rounds_executed for c in crash]
    assert all(st["decided"] is not None for st in states)
    assert bt.api.reached_finality(states[4:])
    assert [tnet.status(i) for i in range(10)] == \
        [jnet.status(i) for i in range(10)]


@pytest.mark.parametrize("fault_model", ["crash", "byzantine"])
def test_observable_state_matches_jax(fault_model):
    """Every node of every trial, a birth-faulty crash node all-null, a
    byzantine one live."""
    from benor_tpu import sim as jsim
    from benor_tpu.config import SimConfig as JCfg
    kw = dict(n_nodes=12, n_faulty=3, trials=2, max_rounds=8,
              fault_model=fault_model, seed=4)
    vals = [0, 1] * 6
    faulty = [False, True, False, True, True] + [False] * 7
    _, jst, jf = jsim.simulate(JCfg(**kw), vals, faulty)
    cfg = bt.SimConfig(**kw)
    _, tst, tf = bt.simulate(cfg, vals, faulty, device="cpu")
    for trial in range(2):
        for i in range(12):
            assert bt.observable_state(cfg, tst, tf, i, trial) == \
                j_observable_state(JCfg(**kw), jst, jf, i, trial)


def test_poll_rounds_slices_equal_one_shot():
    """poll_rounds=1 publishes a live snapshot after every round
    (on_slice fires each time, k grows) and ends where the one-shot run
    does, state for state."""
    faulty = [True] * 5 + [False] * 5
    values = [0, 0, 1, 1, 1, 0, 0, 1, 1, 0]
    one = _launch(tapi, faulty, values, max_rounds=15)
    one.start()
    net = _launch(tapi, faulty, values, max_rounds=15, poll_rounds=1)
    seen = []
    net.start(on_slice=lambda: seen.append(net.get_state(9)["k"]))
    assert seen == list(range(2, 17))
    assert net.rounds_executed == one.rounds_executed == 15
    assert net.get_states() == one.get_states()
    for name in ("x", "decided", "k", "killed"):
        assert torch.equal(getattr(net.state, name),
                           getattr(one.state, name))
    net.start()                       # a second /start is a no-op
    assert net.rounds_executed == 15


def test_on_slice_needs_poll_rounds():
    net = _launch(tapi, [False] * 3, [1, 1, 1])
    with pytest.raises(ValueError, match="poll_rounds"):
        net.start(on_slice=lambda: None)


def test_stop_node_and_status():
    """/stop on one node kills it in every trial; the others stay live."""
    net = _launch(tapi, [False] * 4, [1, 0, 1, 0], trials=3)
    net.stop_node(2)
    assert [net.status(i, trial=t) for t in range(3) for i in range(4)] == \
        [("live", 200), ("live", 200), ("faulty", 500), ("live", 200)] * 3
    assert net.get_state(2)["killed"] is True
    assert net.get_state(2)["x"] == 1


def test_launch_validation():
    """launchNodes.ts:10-13, as the JAX package words it."""
    with pytest.raises(ValueError, match="Arrays don't match"):
        tapi.launch_network(3, 0, [1, 1], [False] * 3, device="cpu")
    with pytest.raises(ValueError, match="faultyList doesnt have F"):
        tapi.launch_network(3, 1, [1, 1, 1], [False] * 3, device="cpu")


def test_launch_needs_cuda_unless_cpu_is_named(monkeypatch):
    """Without a CUDA device and without device='cpu' the facade raises:
    it never moves to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.launch_network(3, 0, [1, 1, 1], [False] * 3)


@pytest.mark.parametrize("call,item", [
    (lambda net: net.get_round_history(), "11"),
    (lambda net: net.get_witness(), "11"),
], ids=["get_round_history", "get_witness"])
def test_unported_methods_raise(call, item):
    net = _launch(tapi, [False] * 3, [1, 1, 1])
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP Queue A item {item}\\)"):
        call(net)


@pytest.mark.parametrize("kw,item", [
    (dict(backend="express"), "17"),
    (dict(backend="native"), "17"),
    (dict(heartbeat_rounds=2), "16"),
    (dict(mesh_shape=(1, 1)), "15"),
    (dict(record=True), "11"),
    (dict(drop_prob=0.2, path="histogram"), "13"),
], ids=["express", "native", "heartbeat", "mesh", "record",
        "omission-histogram"])
def test_unported_launches_raise(kw, item):
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP Queue A item {item}\\)"):
        tapi.launch_network(4, 1, [1, 1, 0, 0], [True, False, False, False],
                            device="cpu", **kw)


def test_heartbeat_path_raises():
    cfg = bt.SimConfig(n_nodes=3, n_faulty=0)
    with pytest.raises(NotImplementedError, match="item 16\\)"):
        bt.TpuNetwork(cfg, [1, 1, 1], [False] * 3, device="cpu",
                      heartbeat_path="beats.jsonl")
