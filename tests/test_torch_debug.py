"""The per-round debug callback of benor_tpu_torch (``SimConfig(debug=
True)``, utils/tracing.py): the sink registry, one event a round in order,
a packed-eligible config on the packed loop (announced with the JAX
package's warning, final state equal to the packed run's), and events
across ``poll_rounds`` slices.  Port only: the event rows are
held against the JAX package's sinks in tests/test_torch_topo.py."""

import numpy as np
import pytest
import torch

import benor_tpu_torch as bt
from benor_tpu.utils import tracing as jtracing
from benor_tpu_torch import sim as tsim
from benor_tpu_torch.ops import packed_round as tround
from benor_tpu_torch.ops import sampling as tsampling
from benor_tpu_torch.state import FaultSpec as TFaults
from benor_tpu_torch.sweep import balanced_inputs, random_inputs
from benor_tpu_torch.utils import tracing as ttracing

FIELDS = ("x", "decided", "k", "killed")


@pytest.fixture
def sink():
    """A registered sink collecting (round, decided, killed) rows."""
    rows = []

    def collect(*row):
        rows.append(row)
    ttracing.add_sink(collect)
    yield rows
    ttracing.remove_sink(collect)


def test_default_sink_prints_the_jax_line(capsys):
    """With no sink registered an event goes to ``default_sink``, which
    prints the JAX package's line to stderr."""
    ttracing.round_callback(3, 40, 2)
    jtracing.default_sink(3, 40, 2)
    err = capsys.readouterr().err.splitlines()
    assert err == ["[benor_tpu] round 3: decided=40 killed=2"] * 2


PACKED_KW = [
    # the north-star regime: quorum delivery, the CF samplers
    dict(n_faulty=40, delivery="quorum", path="histogram",
         use_pallas_hist=True, use_pallas_round=True),
    # a count adversary with the private coin, where the kernels' coin
    # stream is not the unfused loop's
    dict(n_faulty=24, delivery="quorum", scheduler="adversarial",
         use_pallas_round=True),
]


@pytest.mark.parametrize("kw", PACKED_KW, ids=["cf", "adversarial"])
def test_packed_eligible_debug_demotes(sink, monkeypatch, kw):
    """A packed-eligible config with debug=True: the demotion warning,
    the packed loop (the round kernels' path, as the JAX package's debug
    loop keeps its kernels), the packed run's final state, and one event
    a round, each the state after that round of a run taken one round at
    a time."""
    monkeypatch.setattr(tsampling, "EXACT_TABLE_MAX", 4)
    monkeypatch.setattr(tsim, "_debug_demotion_warned", False)
    kw = dict(n_nodes=96, trials=4, max_rounds=24, seed=1, **kw)
    vals = balanced_inputs(4, 96)
    fl = TFaults.none(4, 96)
    cfg = bt.SimConfig(**kw)
    packed = bt.simulate(cfg, vals, faults=fl, device="cpu")
    assert not sink
    state = bt.sim.start_state(cfg, bt.init_state(cfg, vals, fl))
    want, r = [], 1
    while True:
        nxt, state = bt.run_consensus_slice(cfg, state, fl, r, r + 1)
        if nxt == r:
            break
        want.append((int(state.k.max()), int(state.decided.sum()),
                     int(state.killed.sum())))
        r = nxt
    calls = []
    run = tround.run_packed_slice
    monkeypatch.setattr(tround, "run_packed_slice",
                        lambda *a, **k: calls.append(a) or run(*a, **k))
    with pytest.warns(UserWarning, match="debug=True"):
        rounds, st, _ = bt.simulate(cfg.replace(debug=True), vals,
                                    faults=fl, device="cpu")
    assert len(calls) == 1
    assert rounds == packed[0] >= 2
    for k in FIELDS:
        assert torch.equal(getattr(st, k), getattr(packed[1], k)), k
    assert sink == want
    assert [row[0] for row in sink] == list(range(2, rounds + 2))
    assert sink[-1] == (int(st.k.max()), int(st.decided.sum()),
                        int(st.killed.sum()))


def test_events_across_slices(sink):
    """Under poll_rounds the facade's slices emit the one-shot run's
    events, one a round, in order; the sink can be removed again."""
    kw = dict(n_nodes=64, n_faulty=4, trials=2, max_rounds=12, seed=3,
              topology="ring:4", debug=True)
    vals = random_inputs(3, 2, 64)
    fl = [i < 4 for i in range(64)]
    bt.simulate(bt.SimConfig(**kw), vals, fl, device="cpu")
    one_shot = list(sink)
    sink.clear()
    net = bt.launch_network(64, 4, vals[0], fl,
                            cfg=bt.SimConfig(**kw, poll_rounds=3),
                            device="cpu")
    net.start()
    assert len(sink) == net.rounds_executed == 12
    assert [row[0] for row in sink] == [row[0] for row in one_shot]
    assert len(one_shot) == 12


def test_slice_entry_announces_the_demotion(monkeypatch):
    """run_consensus_slice and resume_consensus announce a
    packed-eligible debug config as run_consensus does."""
    monkeypatch.setattr(tsampling, "EXACT_TABLE_MAX", 4)
    cfg = bt.SimConfig(n_nodes=96, n_faulty=24, trials=2, max_rounds=4,
                       delivery="quorum", path="histogram",
                       use_pallas_hist=True, use_pallas_round=True,
                       debug=True)
    fl = TFaults.none(2, 96)
    state = bt.sim.start_state(cfg, bt.init_state(
        cfg, balanced_inputs(2, 96), fl))
    for entry in (bt.run_consensus_slice, bt.resume_consensus):
        monkeypatch.setattr(tsim, "_debug_demotion_warned", False)
        args = (1, 3) if entry is bt.run_consensus_slice else (1,)
        with pytest.warns(UserWarning, match="debug=True"):
            out = entry(cfg, state, fl, *args)
        assert np.all(out[1].k.numpy() >= 1)
