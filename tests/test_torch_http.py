"""The port's HTTP node servers against the JAX package's, byte for byte.

The same request sequence goes to the JAX package's ``NodeHttpCluster``
over its ``ExpressNetwork`` (or native oracle) and to the port's over the
port's; every answer's status line, ``Content-Type`` / ``Allow`` /
``Content-Length`` headers and body are equal (the ``Date`` and ``Server``
headers are the clock and the interpreter's).  The sequences cover the
four routes, 404, forged proposals that flip the outcome, a killed target
that gets no response, 400 / 411 / 413, native post-start injection
(405) and its k-range (400), a step-cap trip (500), parked ports and a
fully taken range.  Over the port's ``TpuNetwork`` on the CPU every answer
equals the port's facade and the JAX package's HTTP layer serving the
same network; one case holds ``/getState`` and ``/getRoundHistory`` under
``poll_rounds=1`` against the JAX package's tpu-backed cluster, computed
in the worker pool (torch_ref_pool).

Port bases 3500-3999: the reference's own tests bind 3100-3171 and
3250-3269, so their TIME_WAIT stragglers cannot collide with these."""

import json
import socket
import threading

import jax
import pytest

from benor_tpu.api import launch_network as jlaunch
from benor_tpu.backends import http_api as jhttp
from benor_tpu_torch.api import launch_network as tlaunch
from benor_tpu_torch.backends import http_api as thttp
from torch_ref_pool import prefetch, ref, start

KEPT = ("content-type", "allow", "content-length")
POLL_BASE = {"jax": 3900, "torch": 3950}


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs(request):
    start(request)
    yield
    jax.clear_caches()


def _raw(port, payload: bytes):
    """One request on a fresh connection -> (status line, kept headers,
    body), or None when the server closes without answering."""
    with socket.create_connection(("127.0.0.1", port), timeout=20) as s:
        s.sendall(payload)
        data = b""
        while True:
            chunk = s.recv(1 << 16)
            if not chunk:
                break
            data += chunk
    if not data:
        return None
    head, _, body = data.partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    headers = sorted((k.lower(), v.strip()) for k, v in
                     (ln.split(":", 1) for ln in lines[1:])
                     if k.lower() in KEPT)
    return lines[0], headers, body


def _get(port, path):
    return _raw(port, f"GET {path} HTTP/1.1\r\nHost: x\r\n"
                      f"Connection: close\r\n\r\n".encode())


def _post(port, path, body: bytes, headers=None):
    hdrs = headers if headers is not None else \
        {"Content-Length": str(len(body))}
    text = "".join(f"{k}: {v}\r\n" for k, v in hdrs.items())
    return _raw(port, f"POST {path} HTTP/1.1\r\nHost: x\r\n{text}"
                      f"Connection: close\r\n\r\n".encode() + body)


def _msg(k, x, mtype="proposal phase"):
    return json.dumps({"k": k, "x": x, "messageType": mtype}).encode()


def _routes(base, n):
    out = [_get(base + i, "/status") for i in range(n)]
    out += [_get(base + i, "/getState") for i in range(n)]
    out += [_get(base, "/start"), _get(base + 1, "/start")]
    out += [_get(base + i, "/getState") for i in range(n)]
    out += [_get(base + 1, "/stop"), _get(base + 1, "/status"),
            _get(base + 1, "/getState"), _get(base, "/nope"),
            _get(base, "/getRoundHistory"),
            _get(base, "/getRoundHistory?since_round=x"),
            _post(base, "/nope", b"xyz")]
    return out


def _forged(base, n):
    """Forged all-1 proposals flip a unanimous-0 network; the faulty
    target gets no response."""
    out = [_post(base + nid, "/message", _msg(1, 1))
           for nid in range(3) for _ in range(3)]
    out.append(_post(base + 3, "/message", _msg(1, 1)))
    out.append(_get(base, "/start"))
    out += [_get(base + i, "/getState") for i in range(n)]
    return out


def _malformed(base, n):
    big = b"y" * ((1 << 20) + 10)
    return [
        _post(base, "/message", b"not json"),
        _post(base, "/message", b'{"k": 1}'),
        _post(base, "/message", _msg([1], 1)),
        _post(base, "/message", _msg(True, 1)),
        _post(base, "/message", json.dumps(
            {"k": 1, "x": 1, "messageType": 7}).encode()),
        _post(base, "/message", b"\xff\xfe", {"Content-Length": "2"}),
        _post(base, "/message", b"5\r\nhello\r\n0\r\n\r\n",
              {"Transfer-Encoding": "chunked"}),
        _post(base, "/message", b"abc", {"Content-Length": "abc"}),
        _post(base, "/message", big),
        _post(base, "/other", big),
        _get(base, "/getState"),
    ]


def _post_start(base, n):
    """Injections after /start: the express oracle drains them, the
    native oracle answers 405; its k-range refusal answers 400."""
    return [_get(base, "/start"),
            _post(base + 1, "/message", _msg(3, 1)),
            _post(base + 2, "/message", _msg(2, 0, "voting phase")),
            _post(base + 1, "/message", _msg(99, 1)),
            _get(base + 1, "/getState"), _get(base + 2, "/getState")]


def _pre_start_k(base, n):
    return [_post(base + 1, "/message", _msg(99, 1)),
            _post(base + 1, "/message", _msg(-1, 1)),
            _post(base + 1, "/message", _msg(1, 1)),
            _get(base, "/start"), _get(base + 1, "/getState")]


def _step_cap(base, n):
    """A post-start cascade past the step cap answers 500."""
    return [_get(base, "/start"), _set_cap(base),
            _post(base + 5, "/message", _msg(1, 1)),
            _get(base + 5, "/getState")]


_CLUSTERS = {}


def _set_cap(base):
    _CLUSTERS[base].network._step_cap = 1
    return "cap set"


#: name -> (backend, n, f, values, launch overrides, sequence)
SEQUENCES = {
    "routes_express": ("express", 4, 1, [1, 1, 0, 1], {}, _routes),
    "routes_native": ("native", 4, 1, [1, 1, 0, 1], {}, _routes),
    "forged_express": ("express", 4, 1, [0, 0, 0, 0], {"seed": 7},
                       _forged),
    "forged_express_shuffle": ("express", 4, 1, [0, 0, 0, 0],
                               {"seed": 7, "oracle_order": "shuffle"},
                               _forged),
    "forged_native": ("native", 4, 1, [0, 0, 0, 0], {"seed": 7}, _forged),
    "malformed_express": ("express", 3, 0, [1, 1, 1], {}, _malformed),
    "post_start_express": ("express", 4, 0, [1, 0, 1, 0],
                           {"max_rounds": 4}, _post_start),
    "post_start_native": ("native", 4, 0, [1, 0, 1, 0], {"max_rounds": 4},
                          _post_start),
    "k_range_native": ("native", 3, 0, [1, 1, 1], {"max_rounds": 4},
                       _pre_start_k),
    "step_cap_express": ("express", 10, 5, [0, 0, 1, 1, 1, 0, 0, 1, 1, 0],
                         {"max_rounds": 3}, _step_cap),
}


class _Serving:
    """A package's cluster as a context manager.  The JAX package's
    ``close`` shuts its listeners down one after another, each waiting up
    to a poll interval (0.5 s); here they are shut down side by side and
    woken by an empty connection (its public ``shutdown`` and
    ``server_close``, and the port's ``_wake``), as the port's ``close``
    does."""

    def __init__(self, http, net, base, **kw):
        self.cluster = http.NodeHttpCluster(net, base, **kw)

    def __enter__(self):
        return self.cluster.serve()

    def __exit__(self, *exc):
        stoppers = [threading.Thread(target=srv.shutdown)
                    for srv in self.cluster.servers]
        for t in stoppers:
            t.start()
        for srv in self.cluster.servers:
            thttp._wake(srv)
        for t in stoppers:
            t.join()
        for srv in self.cluster.servers:
            srv.server_close()


def _serving(http, net, base, **kw):
    return (http.NodeHttpCluster(net, base, **kw) if http is thttp
            else _Serving(http, net, base, **kw))


def _sequence(pkg, name, base):
    backend, n, f, values, kw, seq = SEQUENCES[name]
    launch, http = (tlaunch, thttp) if pkg == "torch" else (jlaunch, jhttp)
    faulty = [False] * (n - f) + [True] * f
    if name.startswith("forged"):
        faulty = [False, False, False, True]
    net = launch(n, f, values, faulty, backend=backend, **kw)
    with _serving(http, net, base) as cluster:
        _CLUSTERS[base] = cluster
        try:
            out = seq(base, n)
        finally:
            del _CLUSTERS[base]
    return out, net.get_states()


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_answers_match_jax(name):
    """Every answer of the sequence, and the network's final states, equal
    the JAX package's."""
    i = list(SEQUENCES).index(name)
    got = _sequence("torch", name, 3500 + 20 * i)
    want = _sequence("jax", name, 3510 + 20 * i)
    assert got == want
    assert any(a is not None and a[0].endswith("200 OK") for a in got[0])


def test_forged_proposals_flip_the_outcome():
    """The forged all-1 proposals decide the unanimous-0 network on 1; the
    faulty target's POST gets no response at all."""
    answers, states = _sequence("torch", "forged_express", 3720)
    assert answers[9] is None
    assert all(s["decided"] and s["x"] == 1 for s in states[:3])


def _blocked(base, ports):
    socks = []
    for p in ports:
        s = socket.socket()
        s.bind(("127.0.0.1", base + p))
        s.listen(1)
        socks.append(s)
    return socks


def _parked(pkg, base):
    launch, http = (tlaunch, thttp) if pkg == "torch" else (jlaunch, jhttp)
    net = launch(3, 0, [1, 1, 1], [False] * 3, backend="express")
    socks = _blocked(base, [1])
    try:
        with _serving(http, net, base, addr_retries=1,
                      addr_retry_delay_s=0.01) as cluster:
            out = [cluster.parked, _get(base, "/start"),
                   _get(base + 2, "/getState")]
    finally:
        for s in socks:
            s.close()
    return out, net.get_states()


def test_parked_port_matches_jax():
    """A taken port parks its node; the others serve."""
    got = _parked("torch", 3740)
    assert got == _parked("jax", 3750)
    assert got[0][0] == [1]


def test_fully_taken_range_raises_as_jax():
    """Every port taken: the JAX package's OSError, word for word."""
    errs = []
    socks = _blocked(3760, range(3))
    try:
        for launch, http in ((tlaunch, thttp), (jlaunch, jhttp)):
            net = launch(3, 0, [1, 1, 1], [False] * 3, backend="express")
            with pytest.raises(OSError) as exc:
                http.NodeHttpCluster(net, 3760, addr_retries=0)
            errs.append(str(exc.value))
    finally:
        for s in socks:
            s.close()
    assert errs[0] == errs[1] and "all 3 ports" in errs[0]


# --- the device simulator, on the CPU ----------------------------------------


def test_tpu_network_answers_are_the_facades():
    """Over the port's TpuNetwork: /status and /getState equal the
    facade's, /stop kills one node, POST /message answers 405, a recorder
    off answers 400, and the JAX package's HTTP layer serving the same
    network answers byte for byte alike."""
    values = [0, 0, 1, 1, 1, 0, 0, 1, 1]
    faulty = [True] * 4 + [False] * 5
    answers = []
    for http, base in ((thttp, 3780), (jhttp, 3800)):
        net = tlaunch(9, 4, values, faulty, device="cpu")
        with _serving(http, net, base):
            seq = [_get(base + i, "/status") for i in range(9)]
            seq += [_get(base, "/start")]
            for i in range(9):
                a = _get(base + i, "/getState")
                assert json.loads(a[2]) == net.get_state(i)
                seq.append(a)
                body, code = net.status(i)
                assert _get(base + i, "/status")[0].split()[1] == str(code)
            seq += [_get(base + 5, "/stop"), _get(base + 5, "/status"),
                    _post(base, "/message", _msg(1, 1)),
                    _get(base, "/getRoundHistory")]
            assert net.status(5) == ("faulty", 500)
        answers.append((seq, net.get_states()))
    assert answers[0] == answers[1]
    seq = answers[0][0]
    assert seq[-2][0].endswith("405 Method Not Allowed")
    assert ("allow", "GET") in seq[-2][1]
    assert seq[-1][0].endswith("400 Bad Request")


LIVELOCK = ([0, 0, 1, 1, 1, 0, 0, 1, 1, 0], [True] * 5 + [False] * 5)


def _polled(launch, http, base, **kw):
    """The livelock scenario with record=True, poll_rounds=1, served on
    ``base``: after every slice /getRoundHistory from the last cursor and
    /getState of a healthy node; after the run every /getState and the
    whole history -> the answers' (status line, body)."""
    values, faulty = LIVELOCK
    net = launch(10, 5, values, faulty, max_rounds=15, record=True,
                 poll_rounds=1, **kw)
    out, cursor = [], [-1]

    def poll():
        a = _get(base, f"/getRoundHistory?since_round={cursor[0]}")
        cursor[0] = json.loads(a[2])["cursor"]
        out.append((a[0], a[2]))
        a = _get(base + 7, "/getState")
        out.append((a[0], a[2]))
    with _serving(http, net, base):
        net.start(on_slice=poll)
        for i in range(10):
            a = _get(base + i, "/getState")
            out.append((a[0], a[2]))
        a = _get(base, "/getRoundHistory")
        out.append((a[0], a[2]))
    return out, net.rounds_executed


def _jax_polled():
    return _polled(jlaunch, jhttp, POLL_BASE["jax"])


@prefetch(lambda: [(_jax_polled,)])
def test_round_history_under_poll_rounds_matches_jax():
    """The cursor walks every round one slice at a time, and every answer
    equals the JAX package's tpu-backed cluster's."""
    got, rounds = _polled(tlaunch, thttp, POLL_BASE["torch"], device="cpu")
    want, want_rounds = ref(_jax_polled)
    assert rounds == want_rounds == 15
    assert got == want
    cursors = [json.loads(body)["cursor"] for _, body in got[0:2 * rounds:2]]
    assert cursors == list(range(1, rounds + 1))
    history = json.loads(got[-1][1])
    assert [r["round"] for r in history["rows"]] == list(range(rounds + 1))
