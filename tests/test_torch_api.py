"""The parity facade on the port: benor_tpu_torch.launch_network /
TpuNetwork / observable_state against the JAX package's, on the CPU.

Every scenario of tests/test_scenarios.py (the reference's integration-test
contract) runs on the port's ``launch_network(..., device="cpu")`` with its
verdicts, and its ``get_states`` equal the JAX ``TpuNetwork``'s state for
state; ``poll_rounds`` slicing equals the one-shot run; stop, stop_node and
status behave as in the reference; what is not ported raises, naming its
ROADMAP item."""

import os

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
from torch_ref_pool import prefetch, ref, start


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs(request):
    """Start the JAX sides ahead (torch_ref_pool).  Every XLA:CPU
    executable keeps memory maps, and a test process that holds too many
    dies in a later compile: drop this module's when it is done."""
    start(request)
    yield
    jax.clear_caches()


def _launch(api, faulty, values, **kw):
    if api is tapi:
        kw["device"] = "cpu"
    return api.launch_network(len(faulty), sum(faulty), values, faulty,
                              backend="tpu", **kw)


def _jax_run(faulty, values, kw):
    """The scenario on the JAX package -> (rounds, states)."""
    net = _launch(japi, faulty, values, **kw)
    japi.start_consensus(net)
    return net.rounds_executed, japi.get_nodes_state(net)


#: the scenarios of tests/test_scenarios.py run on both packages: name ->
#: (faulty, values, launch overrides)
SCEN = {
    "unanimous": ([False] * 5, [1] * 5, {}),
    "simple_majority": ([False, False, False, False, True],
                        [1, 1, 1, 0, 0], {}),
    "threshold": ([True] * 4 + [False] * 5, [0, 0, 1, 1, 1, 0, 0, 1, 1],
                  {}),
    "livelock": ([True] * 5 + [False] * 5, [0, 0, 1, 1, 1, 0, 0, 1, 1, 0],
                 {"max_rounds": 15}),
    "no_faulty": ([False] * 5, [0, 1, 0, 1, 1], {}),
    "randomized": ([False, False, True, False, True, False, False],
                   [int(v) for v in
                    np.random.default_rng(42).integers(0, 2, size=7)], {}),
    "one_node": ([False], [1], {}),
    "default": ([True] * 4 + [False] * 6, [0, 0, 1, 1, 1, 0, 0, 1, 1, 1],
                {}),
}


def _scen(name):
    return prefetch(lambda: [(_jax_run, *SCEN[name])])


def _run_both(name):
    """A scenario on both packages (the JAX side from the worker pool) ->
    the port's states (equal to the JAX package's, state for state)."""
    faulty, values, kw = SCEN[name]
    net = _launch(tapi, faulty, values, **kw)
    tapi.start_consensus(net)
    t_rounds, t_states = net.rounds_executed, tapi.get_nodes_state(net)
    net.close()
    j_rounds, j_states = ref(_jax_run, *SCEN[name])
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


@_scen("unanimous")
def test_unanimous_agreement():
    states = _run_both("unanimous")
    assert bt.api.reached_finality(states)
    for st in states:
        assert st["decided"] is True and st["x"] == 1 and st["k"] <= 2


@_scen("simple_majority")
def test_simple_majority():
    faulty = SCEN["simple_majority"][0]
    states = _run_both("simple_majority")
    for st, f in zip(states, faulty):
        if f:
            _assert_faulty_null(st)
        else:
            assert st["decided"] is True and st["x"] == 1 and st["k"] <= 2


@_scen("threshold")
def test_fault_tolerance_threshold():
    faulty = SCEN["threshold"][0]
    states = _run_both("threshold")
    live = [st for st, f in zip(states, faulty) if not f]
    for st, f in zip(states, faulty):
        if f:
            _assert_faulty_null(st)
    assert all(st["decided"] is True and st["k"] is not None for st in live)
    assert len({st["x"] for st in live}) == 1


@_scen("livelock")
def test_exceeding_fault_tolerance_livelock():
    faulty = SCEN["livelock"][0]
    states = _run_both("livelock")
    for st, f in zip(states, faulty):
        if f:
            _assert_faulty_null(st)
        else:
            assert st["decided"] is not True
            assert st["k"] > 10 and st["x"] is not None


@_scen("no_faulty")
def test_no_faulty_nodes():
    states = _run_both("no_faulty")
    for st in states:
        assert st["decided"] is True and st["x"] == 1 and st["k"] <= 2


@_scen("randomized")
def test_randomized():
    faulty = SCEN["randomized"][0]
    states = _run_both("randomized")
    live = [st for st, f in zip(states, faulty) if not f]
    assert all(st["decided"] is True for st in live)
    assert len({st["x"] for st in live}) == 1


@_scen("one_node")
def test_one_node():
    states = _run_both("one_node")
    assert states == [{"killed": False, "x": 1, "decided": True, "k": 2}]


def test_stop_consensus_kills_all():
    net = _launch(tapi, [False] * 3, [1, 1, 1])
    tapi.start_consensus(net)
    tapi.stop_consensus(net)
    assert [net.status(i) for i in range(3)] == [("faulty", 500)] * 3
    st = net.get_state(0)
    assert st["killed"] is True and st["x"] is not None


# --- the facade beyond the scenarios -----------------------------------------


@_scen("default")
def test_default_config_facade_matches_jax():
    """The upstream repo's own use case: N = 10 launched with SimConfig's
    defaults, started, read node by node and in bulk."""
    faulty, values, _ = SCEN["default"]
    states = _run_both("default")
    net = _launch(tapi, faulty, values)
    assert net.cfg == bt.SimConfig(n_nodes=10, n_faulty=4)
    assert [net.get_state(i) for i in range(10)] == net.get_states() == \
        [{"killed": True, "x": None, "decided": None, "k": None}] * 4 + \
        [{"killed": False, "x": v, "decided": False, "k": 0}
         for v in values[4:]]
    net.start()
    assert net.get_states() == states
    assert bt.api.reached_finality(states)


CRASH = ([True] * 4 + [False] * 6, [0, 1] * 5, [2, 2, 3, 3] + [0] * 6)


def _jax_crash_at_round(faulty, values, crash):
    jnet = JTpuNetwork(JCfg(n_nodes=10, n_faulty=4,
                            fault_model="crash_at_round"), values, faulty,
                       crash_rounds=crash)
    jnet.start()
    return (jnet.rounds_executed, jnet.get_states(),
            [jnet.status(i) for i in range(10)])


@prefetch(lambda: [(_jax_crash_at_round, *CRASH)])
def test_crash_at_round_facade_matches_jax():
    """Faulty nodes that die mid-run (crash_at_round, rounds 2 and 3):
    ``launch_network(..., crash_rounds=...)`` on the port against the JAX
    ``TpuNetwork`` with the same crash rounds, state for state; the dead
    nodes report killed with their last state, the live ones decide."""
    faulty, values, crash = CRASH
    tnet = _launch(tapi, faulty, values, fault_model="crash_at_round",
                   crash_rounds=crash)
    tnet.start()
    j_rounds, j_states, j_status = ref(_jax_crash_at_round, *CRASH)
    assert tnet.rounds_executed == j_rounds >= 2
    states = tnet.get_states()
    assert states == j_states
    # a node is killed from its crash round on, and reports its state
    assert [st["killed"] for st in states] == \
        [0 < c <= tnet.rounds_executed for c in crash]
    assert all(st["decided"] is not None for st in states)
    assert bt.api.reached_finality(states[4:])
    assert [tnet.status(i) for i in range(10)] == j_status


OBS_VALS = [0, 1] * 6
OBS_FAULTY = [False, True, False, True, True] + [False] * 7


def _obs_kw(fault_model):
    return dict(n_nodes=12, n_faulty=3, trials=2, max_rounds=8,
                fault_model=fault_model, seed=4)


def _jax_observable(fault_model):
    """Every node's observable state of every trial of the JAX run."""
    from benor_tpu import sim as jsim
    kw = _obs_kw(fault_model)
    _, jst, jf = jsim.simulate(JCfg(**kw), OBS_VALS, OBS_FAULTY)
    return [[j_observable_state(JCfg(**kw), jst, jf, i, trial)
             for i in range(12)] for trial in range(2)]


@pytest.mark.parametrize("fault_model", ["crash", "byzantine"])
@prefetch(lambda fault_model: [(_jax_observable, fault_model)])
def test_observable_state_matches_jax(fault_model):
    """Every node of every trial, a birth-faulty crash node all-null, a
    byzantine one live."""
    cfg = bt.SimConfig(**_obs_kw(fault_model))
    _, tst, tf = bt.simulate(cfg, OBS_VALS, OBS_FAULTY, device="cpu")
    assert [[bt.observable_state(cfg, tst, tf, i, trial)
             for i in range(12)] for trial in range(2)] == \
        ref(_jax_observable, fault_model)


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


@pytest.mark.parametrize("call,flags,match", [
    (lambda net, **kw: net.get_round_history(**kw), dict(record=True),
     "record=True"),
    (lambda net, **kw: net.get_witness(), dict(witness_trials=(0,),
                                               witness_nodes=2),
     "witness_trials"),
], ids=["get_round_history", "get_witness"])
def test_history_and_witness_methods(call, flags, match):
    """Off, they raise the JAX facade's ValueError; on, they are empty before
    start() and hold a row a round (and the snapshot) after it, the
    ``since_round`` cursor keeping the later rows."""
    net = _launch(tapi, [False] * 3, [1, 1, 1])
    with pytest.raises(ValueError, match=match):
        call(net)
    net = _launch(tapi, [True] + [False] * 4, [0, 0, 1, 1, 1],
                  max_rounds=6, **flags)
    assert call(net) == []
    net.start()
    rows = call(net)
    per_round = 1 if "record" in flags else 2
    assert len(rows) == (net.rounds_executed + 1) * per_round
    assert [r["round"] for r in rows][::per_round] == \
        list(range(net.rounds_executed + 1))
    if "record" in flags:
        assert call(net, since_round=0) == rows[1:]


@pytest.mark.parametrize("kw,item", [
    (dict(backend="express"), "jax"),
    (dict(backend="native"), "jax"),
    (dict(heartbeat_rounds=2), "beats"),
    (dict(mesh_shape=(1, 1)), "15"),
    (dict(drop_prob=0.2, path="histogram"), None),
], ids=["express", "native", "heartbeat", "mesh", "omission-histogram"])
def test_unported_launches_raise(kw, item):
    """The launches the port does not serve raise, naming their ROADMAP
    item; omission on the histogram path (``item`` None) launches and runs
    now, and so do the event-loop oracles (``item`` "jax"), whose states
    and statuses equal the JAX package's oracle's (they take no device),
    and the heartbeat (``item`` "beats"), which publishes its final beat
    and leaves the states of the run without it."""
    args = (4, 1, [1, 1, 0, 0], [True, False, False, False])
    if item == "beats":
        from benor_tpu_torch.utils.metrics import REGISTRY
        before = REGISTRY.counter("heartbeat.published").value
        nets = [tapi.launch_network(*args, device="cpu", **k)
                for k in (kw, {})]
        for net in nets:
            net.start()
        assert REGISTRY.counter("heartbeat.published").value == before + 1
        assert REGISTRY.gauge("heartbeat.progress").value == 1.0
        assert nets[0].get_states() == nets[1].get_states()
        return
    if item == "jax":
        nets = [api.launch_network(*args, **kw) for api in (tapi, japi)]
        for net in nets:
            net.start()
        assert [[net.status(i) for i in range(4)] for net in nets] == \
            [[("faulty", 500)] * 4] * 2         # the global-halt probe
        assert nets[0].get_states() == nets[1].get_states()
        assert nets[0].get_states()[1]["decided"] is True
        return
    if item is not None:
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP Queue A item {item}\\)"):
            tapi.launch_network(*args, device="cpu", **kw)
        return
    net = tapi.launch_network(*args, device="cpu", **kw)
    net.start()
    assert net.rounds_executed >= 1
    states = net.get_states()
    assert len(states) == 4 and states[0]["killed"]


def test_recorded_launch_runs():
    """record=True launches and runs: the states equal the unrecorded
    launch's, the history ends at the last round run."""
    args = (4, 1, [1, 1, 0, 0], [True, False, False, False])
    nets = [tapi.launch_network(*args, device="cpu", record=rec)
            for rec in (True, False)]
    for net in nets:
        net.start()
    assert nets[0].get_states() == nets[1].get_states()
    assert nets[0].get_round_history()[-1]["round"] == \
        nets[0].rounds_executed


def test_heartbeat_path_raises(tmp_path):
    """A heartbeat path raised before the heartbeat was ported; now the
    network writes its beats there (one final beat for a one-shot run,
    ``done: true`` at the rounds run) and nothing with no cadence."""
    from benor_tpu_torch.meshscope import read_heartbeats
    path = str(tmp_path / "beats.jsonl")
    for hb in (0, 2):
        cfg = bt.SimConfig(n_nodes=3, n_faulty=0, heartbeat_rounds=hb)
        net = bt.TpuNetwork(cfg, [1, 1, 1], [False] * 3, device="cpu",
                            heartbeat_path=path)
        assert net.heartbeat_path == path
        net.start()
        assert os.path.exists(path) == bool(hb)
    beats = read_heartbeats(path)
    assert len(beats) == 1 and beats[0]["done"]
    assert beats[0]["round"] == net.rounds_executed
