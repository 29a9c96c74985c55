"""The port's event-loop oracles against the JAX package's, on the CPU.

``benor_tpu_torch.backends.express.ExpressNetwork`` is held to the JAX
package's ``ExpressNetwork`` on every scenario of tests/test_scenarios.py
and tests/test_native_oracle.py, in both delivery orders, plain, with
pre-start and post-start injections and with a pre-start ``stop_node``:
the final states, every ``status`` and the drain itself (each delivery,
in order) are equal.  The port's native oracle (its own copy of the C++
source, built into build/benor_tpu_torch/oracle/) equals the JAX
package's native oracle and the port's express oracle, state for state
and ``steps_delivered`` for ``steps_delivered``; ``run_batch`` equals the
JAX ``run_batch`` array for array, ``steps`` and ``n_tripped`` included.
The refusals raise the JAX package's exception types and messages.

Neither package's oracle compiles anything, so the JAX side runs in this
process; the module fixture still starts the worker pool (torch_ref_pool)
and drops JAX's caches at teardown, as every port test file does."""

import os

import jax
import numpy as np
import pytest

from benor_tpu.api import launch_network as jlaunch
from benor_tpu.backends import express as jexpress
from benor_tpu.backends import native_oracle as jnative
from benor_tpu.config import SimConfig as JCfg
from benor_tpu_torch.api import launch_network as tlaunch
from benor_tpu_torch.backends import express as texpress
from benor_tpu_torch.backends import native_oracle as tnative
from benor_tpu_torch.config import SimConfig as TCfg
from torch_ref_pool import start

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: name -> (values, faulty, launch overrides): tests/test_scenarios.py's
#: scenarios (their default seed and max_rounds) and tests/test_native_
#: oracle.py's seven (seed and max_rounds=12).
SCENARIOS = {
    "status_3": ([1, 1, 1], [True, False, False], {}),
    "status_10": ([1] * 10, [True, False, False, False, False, True,
                             False, False, False, False], {}),
    "unanimous": ([1] * 5, [False] * 5, {}),
    "simple_majority": ([1, 1, 1, 0, 0], [False] * 4 + [True], {}),
    "threshold": ([0, 0, 1, 1, 1, 0, 0, 1, 1], [True] * 4 + [False] * 5,
                  {}),
    "livelock": ([0, 0, 1, 1, 1, 0, 0, 1, 1, 0], [True] * 5 + [False] * 5,
                 {"max_rounds": 15}),
    "no_faulty": ([0, 1, 0, 1, 1], [False] * 5, {}),
    "randomized": ([int(v) for v in
                    np.random.default_rng(42).integers(0, 2, size=7)],
                   [False, False, True, False, True, False, False], {}),
    "one_node": ([1], [False], {}),
    "native_5_0": ([1] * 5, [False] * 5, {"seed": 0, "max_rounds": 12}),
    "native_5_1": ([1, 1, 1, 0, 0], [False] * 4 + [True],
                   {"seed": 1, "max_rounds": 12}),
    "native_9_4": ([1, 0, 1, 0, 1, 0, 1, 1, 0],
                   [True, True, False, False, True, False, False, False,
                    True], {"seed": 2, "max_rounds": 12}),
    "native_10_5": ([1, 0] * 5, [True] * 5 + [False] * 5,
                    {"seed": 3, "max_rounds": 12}),
    "native_7_2": ([0, 1, 1, 0, 1, 0, 1],
                   [True, False, True, False, False, False, False],
                   {"seed": 4, "max_rounds": 12}),
    "native_1_0": ([1], [False], {"seed": 5, "max_rounds": 12}),
    "native_30_9": ([i % 2 for i in range(30)], [True] * 9 + [False] * 21,
                    {"seed": 6, "max_rounds": 12}),
}
ORDERS = ("fifo", "shuffle")
#: plain; injections before start(); injections after start() (express
#: only: the native oracle runs a whole trial in one call); a healthy
#: node stopped before start()
MODES = ("plain", "pre_inject", "post_inject", "pre_stop")
#: tests/test_native_oracle.py's injection list, hostile wire values
#: included (an unknown type, a non-canonical x)
INJ = ([(0, 1, 1, "proposal phase")] * 3 + [(1, 1, 1, "proposal phase")] * 3
       + [(2, 1, 1, "proposal phase")] * 3 + [(1, 2, "?", "voting phase")]
       + [(2, 1, 1, "gossip"), (0, 2, 0.5, "voting phase"),
          (1, 1, True, "proposal phase"), (-1, 1, 0, "proposal phase")])


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs(request):
    start(request)
    yield
    jax.clear_caches()


def _traced(module):
    """Record every delivery (node, k, x, type) of ``module``'s oracle."""
    trace = []
    orig = module._ExpressNode.on_message

    def on_message(self, k, x, mtype):
        trace.append((self.node_id, k, x, mtype))
        return orig(self, k, x, mtype)
    return trace, orig, on_message


def _drive(launch, name, order, mode, backend):
    """One scenario through a package's facade -> (states, statuses,
    per-injection results, steps delivered or None)."""
    values, faulty, kw = SCENARIOS[name]
    net = launch(len(faulty), sum(faulty), values, faulty, backend=backend,
                 oracle_order=order, **kw)
    n = len(faulty)
    inj = [(i % n if i >= 0 else i, k, x, t) for i, k, x, t in INJ]
    got = []
    if mode == "pre_inject":
        got = [net.inject_message(*m) for m in inj]
    if mode == "pre_stop":
        net.stop_node(n - 1)
    net.start()
    if mode == "post_inject":
        got = [net.inject_message(*m) for m in inj]
    statuses = [net.status(i) for i in range(n)]
    return (net.get_states(), statuses, got,
            getattr(net, "steps_delivered", None))


def _express_run(module, launch, name, order, mode):
    trace, orig, hook = _traced(module)
    module._ExpressNode.on_message = hook
    try:
        out = _drive(launch, name, order, mode, "express")
    finally:
        module._ExpressNode.on_message = orig
    return out, trace


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_express_matches_jax(name, order, mode):
    """Final states, statuses, injection answers and the delivery sequence
    equal the JAX oracle's."""
    got, got_trace = _express_run(texpress, tlaunch, name, order, mode)
    want, want_trace = _express_run(jexpress, jlaunch, name, order, mode)
    assert got == want
    assert got_trace == want_trace
    assert got_trace or all(code == 500 for _, code in got[1])


@pytest.mark.parametrize("mode", ("plain", "pre_inject", "pre_stop"))
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_native_matches_jax_and_express(name, order, mode):
    """The port's native oracle equals the JAX package's native oracle
    (steps delivered included) and the port's express oracle."""
    got = _drive(tlaunch, name, order, mode, "native")
    assert got == _drive(jlaunch, name, order, mode, "native")
    assert got[:3] == _drive(tlaunch, name, order, mode, "express")[:3]
    assert got[3] > 0 or all(code == 500 for _, code in got[1])


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("name", ["threshold", "livelock", "native_30_9",
                                  "native_10_5", "capped"])
def test_run_batch_matches_jax(name, order):
    """One ctypes call over 64 seeds: every array, steps and n_tripped
    (``capped``: a step cap every seed trips)."""
    values, faulty, kw = SCENARIOS["threshold" if name == "capped"
                                   else name]
    kw = {"max_rounds": kw.get("max_rounds", 12)}
    cap = 40 if name == "capped" else None
    seeds = np.arange(64, dtype=np.uint32) * 7919
    outs = []
    for cfg_cls, mod in ((TCfg, tnative), (JCfg, jnative)):
        cfg = cfg_cls(n_nodes=len(faulty), n_faulty=sum(faulty),
                      backend="native", oracle_order=order, **kw)
        outs.append(mod.run_batch(cfg, values, faulty, seeds, step_cap=cap))
    got, want = outs
    assert got.keys() == want.keys()
    for key in got:
        if key == "n_tripped":
            assert got[key] == want[key]
        else:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    assert got["n_tripped"] == (64 if cap else 0)


def _net(launch, backend, n=3, f=1, **kw):
    return launch(n, f, [1] * n, [True] * f + [False] * (n - f),
                  backend=backend, **kw)


def _post_start_inject(launch):
    net = _net(launch, "native")
    net.start()
    net.inject_message(1, 1, 1, "proposal phase")


def _express_cap(launch):
    net = _net(launch, "express", n=5, f=0)
    net._step_cap = 3
    net.start()


def _express_cap_after_start(launch):
    values, faulty, _ = SCENARIOS["livelock"]
    net = launch(10, 5, values, faulty, backend="express", max_rounds=3)
    net.start()                      # undecided at the cap: still live
    net._step_cap = 1
    net.inject_message(5, 1, 1, "proposal phase")


def _native_cap(launch):
    net = _net(launch, "native", n=5, f=0)
    net._step_cap = 3
    net.start()


def _batch(pkg, **over):
    cfg_cls, mod = (TCfg, tnative) if pkg == "torch" else (JCfg, jnative)
    cfg = cfg_cls(n_nodes=5, n_faulty=0, backend="native",
                  max_rounds=12).replace(**over)
    return lambda launch: mod.run_batch(cfg, [1] * 5, [False] * 5,
                                        np.arange(4), step_cap=3,
                                        raise_on_cap=True)


REFUSALS = {
    "trials_express": lambda l: _net(l, "express", trials=2),
    "trials_native": lambda l: _net(l, "native", trials=2),
    "arrays_express": lambda l: l(3, 1, [1, 1], [True, False, False],
                                  backend="express"),
    "arrays_native": lambda l: l(3, 1, [1, 1, 1], [True, False],
                                 backend="native"),
    "f_count_express": lambda l: l(3, 2, [1, 1, 1], [True, False, False],
                                   backend="express"),
    "f_count_native": lambda l: l(3, 2, [1, 1, 1], [True, False, False],
                                  backend="native"),
    "seed_range": lambda l: _net(l, "native", seed=2 ** 32),
    "k_range_high": lambda l: _net(l, "native", max_rounds=4)
    .inject_message(1, 6, 1, "proposal phase"),
    "k_range_negative": lambda l: _net(l, "native")
    .inject_message(1, -1, 1, "proposal phase"),
    "k_range_bool": lambda l: _net(l, "native")
    .inject_message(1, True, 1, "proposal phase"),
    "node_range": lambda l: _net(l, "native").inject_message(
        3, 1, 1, "proposal phase"),
    "trial_index": lambda l: _net(l, "express").get_state(0, trial=1),
    "trial_index_native": lambda l: _net(l, "native").status(0, trial=1),
    "post_start_injection": _post_start_inject,
    "step_cap_express": _express_cap,
    "step_cap_express_injection": _express_cap_after_start,
    "step_cap_native": _native_cap,
    "step_cap_batch": "batch",
    "fault_model": lambda l: _net(l, "express", fault_model="byzantine"),
    "coin_mode": lambda l: _net(l, "native", coin_mode="common"),
    "rule": lambda l: _net(l, "express", rule="textbook"),
    "scheduler": lambda l: _net(l, "native", scheduler="adversarial"),
    "batch_knob": "batch_knob",
}


def _refusal(pkg, name):
    launch = tlaunch if pkg == "torch" else jlaunch
    fn = REFUSALS[name]
    if fn == "batch":
        fn = _batch(pkg)
    elif fn == "batch_knob":
        fn = _batch(pkg, fault_model="byzantine")
    with pytest.raises(Exception) as exc:
        fn(launch)
    return type(exc.value).__name__, str(exc.value)


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_match_jax(name):
    """The exception type and message of each refusal are the JAX
    package's."""
    assert _refusal("torch", name) == _refusal("jax", name)


def test_native_builds_only_its_own_library():
    """The port compiles its own copy of the C++ source (native/
    express_oracle.cpp line for line, but one comment, which names where
    the upstream file lies) into build/benor_tpu_torch/oracle/ and leaves
    native/build/, which the JAX package loads, untouched."""
    with open(os.path.join(ROOT, "native", "express_oracle.cpp")) as a, \
            open(tnative._SRC) as b:
        want, got = a.read().split("\n"), b.read().split("\n")
    assert len(got) == len(want)
    differ = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    assert differ == [4] and got[4].startswith("// ") and \
        want[4].startswith("// ")
    assert os.path.dirname(tnative._SRC) == os.path.join(
        ROOT, "benor_tpu_torch", "native")
    assert os.path.dirname(tnative._LIB) == os.path.join(
        ROOT, "build", "benor_tpu_torch", "oracle")

    def listing(d):
        if not os.path.isdir(d):
            return None
        return sorted((e.name, e.stat().st_mtime_ns, e.stat().st_size)
                      for e in os.scandir(d))

    native_build = os.path.join(ROOT, "native", "build")
    before = listing(native_build)
    lib, tnative._lib = tnative._lib, None
    try:
        if os.path.exists(tnative._LIB):
            os.remove(tnative._LIB)
        tnative.load_library()
        assert os.path.isfile(tnative._LIB)
        assert os.listdir(os.path.dirname(tnative._LIB)) == \
            ["libexpress_oracle.so"]
    finally:
        tnative._lib = lib if lib is not None else tnative._lib
    assert listing(native_build) == before
    assert tnative.native_available()
