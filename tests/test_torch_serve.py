"""The port's serve control plane against the JAX package's, on the CPU:
twins of tests/test_serve.py and of the serve cases of tests/test_engine.py.
Each program runs through ``ray_tpu.serve`` on a fresh ``ray_tpu`` runtime,
then through ``ray_tpu_torch.serve`` on a fresh ``ray_tpu_torch`` runtime,
in one process, and what the reference's tests read is held equal: values
and error classes, ``stat()``'s keys and counts, ``list_backends()`` and
``list_endpoints()``, Prometheus series, HTTP status lines, headers and
body bytes, and the LM's tokens (the port's ``LMBackend`` on the CPU behind
the port's serve against JAX's behind JAX's, at tests/test_torch_engine.py's
config in f32 with JAX's weights carried across).

The reference's ``test_http_streaming_chunked`` counts NDJSON chunks and
fails whenever one long-poll drains every token. Its twin here holds the
LM stream to its tokens, content type and final ``done``, and a gated
backend, which releases one token per step of the test, holds incremental
arrival chunk by chunk."""

import http.client
import json
import random
import socket
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as jserve
from ray_tpu.models import TransformerConfig as JCfg
from ray_tpu.models import init_params as j_init
from ray_tpu.serve import router as jrouter
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.models import TransformerConfig as TCfg
from ray_tpu_torch.models import params_from_numpy
from ray_tpu_torch.serve import router as trouter

PKGS = (ray_tpu, ray_tpu_torch)
SERVE = {ray_tpu: jserve, ray_tpu_torch: tserve}
_KW = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=128, max_seq_len=128)
_RECONCILE = ("RAY_TPU_SERVE_RECONCILE_PERIOD_S",
              "RAY_TPU_TORCH_SERVE_RECONCILE_PERIOD_S")


@pytest.fixture(scope="module", autouse=True)
def _light():
    """One intra-op thread for torch, and a short reconcile period for
    both masters."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for name in _RECONCILE:
            mp.setenv(name, "0.05")
        yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _both_shut_down():
    """Neither serve nor runtime outlives a test."""
    yield
    for rt in PKGS:
        SERVE[rt].shutdown()
        rt.shutdown()


@pytest.fixture(scope="module")
def model():
    jcfg = JCfg(dtype=jnp.float32, **_KW)
    tcfg = TCfg(dtype=torch.float32, **_KW)
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return {ray_tpu: (jparams, jcfg, {}),
            ray_tpu_torch: (tparams, tcfg, {"device": "cpu"})}


def both(program, http_port=None):
    """Run ``program(rt, serve)`` on fresh runtimes and serves of each
    package in turn; return (JAX's result, the port's)."""
    outs = []
    for rt in PKGS:
        rt.init(num_cpus=8, object_store_memory=256 * 1024 * 1024)
        sv = SERVE[rt]
        try:
            sv.init(http_port=http_port)
            outs.append(program(rt, sv))
        finally:
            sv.shutdown()
            rt.shutdown()
    return outs


def same(program, http_port=None):
    j, t = both(program, http_port)
    assert j == t
    return t


def _err(e):
    """An error by package-free names: its class, and its cause's."""
    cause = getattr(e, "cause", None)
    return [type(e).__name__, type(cause).__name__ if cause else None]


def _counts(stat):
    """``stat()`` with its timings taken out: every key, every count."""
    def walk(v, key=""):
        if isinstance(v, dict):
            return {k: walk(x, k) for k, x in v.items() if k != "probes"}
        if key.startswith("latency_ms") or key == "qps":
            return type(v).__name__
        return v
    return walk(stat)


def _series(text):
    """Prometheus text without its values: each line's name and labels."""
    return [ln.rsplit(" ", 1)[0] for ln in text.splitlines()]


def _http(addr, method, path, body=None):
    """(status, headers, body bytes) of one request."""
    host, port = addr.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"}
                     if body is not None else {})
        resp = conn.getresponse()
        return resp.status, resp.getheaders(), resp.read()
    finally:
        conn.close()


# ------------------------------------------------- twins of test_serve.py


def test_function_backend_and_handle():
    def prog(rt, sv):
        def echo(x):
            return {"echo": x}

        sv.create_backend("echo:v1", echo)
        sv.create_endpoint("echo", backend="echo:v1")
        h = sv.get_handle("echo")
        return rt.get(h.remote(42)), rt.get([h.remote(i) for i in range(10)])

    one, many = same(prog)
    assert one == {"echo": 42}
    assert [r["echo"] for r in many] == list(range(10))


def test_class_backend_with_init_args_and_methods():
    def prog(rt, sv):
        class Model:
            def __init__(self, scale):
                self.scale = scale
                self.calls = 0

            def __call__(self, x):
                self.calls += 1
                return x * self.scale

            def meta(self):
                return {"scale": self.scale, "calls": self.calls}

        sv.create_backend("m:v1", Model, 3)
        sv.create_endpoint("model", backend="m:v1")
        h = sv.get_handle("model")
        return rt.get(h.remote(7)), rt.get(h.options(method="meta").remote())

    assert same(prog) == (21, {"scale": 3, "calls": 1})


def test_multiple_replicas():
    def prog(rt, sv):
        class Who:
            def __call__(self, _):
                return threading.get_ident()

        sv.create_backend(
            "who:v1", Who, config=sv.BackendConfig(num_replicas=3))
        sv.create_endpoint("who", backend="who:v1")
        h = sv.get_handle("who")
        idents = set(rt.get([h.remote(None) for _ in range(30)]))
        return (len(idents) >= 2, sv.stat()["backends"]["who:v1"],
                sv.list_backends())

    spread, backend, backends = same(prog)
    assert spread and backend["num_replicas"] == 3
    assert backends["who:v1"]["num_replicas"] == 3


def test_traffic_split():
    def prog(rt, sv):
        sv.create_backend("a:v1", lambda _: "a")
        sv.create_backend("b:v1", lambda _: "b")
        sv.create_endpoint("ab", backend="a:v1")
        sv.set_traffic("ab", {"a:v1": 0.5, "b:v1": 0.5})
        h = sv.get_handle("ab")
        split = set(rt.get([h.remote(None) for _ in range(60)]))
        listed = sv.list_endpoints()
        sv.set_traffic("ab", {"b:v1": 1.0})
        return split, set(rt.get([h.remote(None) for _ in range(20)])), \
            listed

    split, only_b, listed = same(prog)
    assert split == {"a", "b"} and only_b == {"b"}
    assert listed["ab"]["traffic"] == {"a:v1": 0.5, "b:v1": 0.5}


def test_pick_backend_draws_as_the_reference():
    """The split draws from module ``random``, which two live routers in
    one process share; so the parity is of ``_pick_backend`` itself, on the
    same seeded state, restored after each package."""
    traffic = {"a": 0.2, "b": 0.5, "c": 0.3}
    state = random.getstate()
    picks = []
    try:
        for mod in (jrouter, trouter):
            random.seed(1234)
            r = mod.Router.__new__(mod.Router)
            picks.append([r._pick_backend(traffic) for _ in range(200)])
    finally:
        random.setstate(state)
    assert picks[0] == picks[1]
    assert set(picks[1]) == {"a", "b", "c"}


def test_batching():
    def prog(rt, sv):
        sizes = []

        class Batched:
            @sv.accept_batch
            def __call__(self, requests):
                sizes.append(len(requests))
                return [r.data * 2 for r in requests]

        sv.create_backend(
            "batch:v1", Batched,
            config=sv.BackendConfig(max_batch_size=8,
                                    batch_wait_timeout_s=0.05))
        sv.create_endpoint("batch", backend="batch:v1")
        h = sv.get_handle("batch")
        results = rt.get([h.remote(i) for i in range(16)])
        return (results, sum(sizes), max(sizes) > 1,
                sv.stat()["backends"]["batch:v1"]["batched"])

    assert same(prog) == ([2 * i for i in range(16)], 16, True, True)


def test_update_backend_config_scales():
    def prog(rt, sv):
        sv.create_backend("s:v1", lambda _: "ok")
        sv.create_endpoint("s", backend="s:v1")
        sv.update_backend_config("s:v1", {"num_replicas": 4})
        h = sv.get_handle("s")
        return sv.list_backends(), rt.get(h.remote(None)), \
            sv.stat()["fleet"]

    backends, out, fleet = same(prog)
    assert backends["s:v1"]["num_replicas"] == 4 and out == "ok"
    assert fleet["s:v1"]["replicas"] == 4


def test_delete_endpoint_and_backend():
    def prog(rt, sv):
        sv.create_backend("d:v1", lambda _: 1)
        sv.create_endpoint("d", backend="d:v1")
        try:
            sv.delete_backend("d:v1")  # still has traffic
            refused = None
        except Exception as e:  # noqa: BLE001 - the error is the subject
            refused = _err(e) + [str(e.cause)]
        sv.delete_endpoint("d")
        sv.delete_backend("d:v1")
        return refused, sv.list_backends(), sv.list_endpoints()

    refused, backends, endpoints = same(prog)
    assert refused == ["TaskError", "ValueError",
                       "backend 'd:v1' still receives traffic"]
    assert backends == {} and endpoints == {}


def test_lm_backend_is_the_model_backend(model):
    """The twin of the reference's ``test_jax_model_backend``: the model
    behind serve is each package's ``LMBackend``, batching up to 16
    requests; the port's tokens are JAX's."""
    def prog(rt, sv):
        params, cfg, kw = model[rt]
        sv.create_backend(
            "lm:v1", sv.LMBackend, params, cfg, **kw,
            config=sv.BackendConfig(max_batch_size=16,
                                    batch_wait_timeout_s=0.05))
        sv.create_endpoint("lm", backend="lm:v1")
        h = sv.get_handle("lm")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, 256, int(n)).tolist()
                   for n in rng.integers(3, 12, 8)]
        return rt.get([h.remote(p, max_new_tokens=5) for p in prompts],
                      timeout=120)

    outs = same(prog)
    assert all(len(o) == 5 for o in outs) and len(set(map(tuple, outs))) > 1


def test_http_ingress():
    def prog(rt, sv):
        sv.create_backend("h:v1", lambda x=None: {"got": x})
        sv.create_endpoint("h", backend="h:v1", route="/h",
                           methods=["GET", "POST"])
        addr = sv.http_address()
        assert addr.startswith("http://127.0.0.1:")
        return [_http(addr, "GET", "/h"),
                _http(addr, "POST", "/h", json.dumps(123).encode()),
                _http(addr, "GET", "/nope"),
                _http(addr, "PUT", "/h"),
                _http(addr, "POST", "/h", b"{not json"),
                _http(addr, "GET", "/-/routes")]

    got, posted, missing, put, bad, routes = same(prog, http_port=0)
    assert got[0] == 200 and json.loads(got[2]) == {"result": {"got": None}}
    assert json.loads(posted[2]) == {"result": {"got": 123}}
    assert ("Content-Type", "application/json") in got[1]
    assert (missing[0], put[0], bad[0]) == (404, 405, 400)
    assert json.loads(routes[2]) == {"/h": ["h", ["GET", "POST"]]}


def test_serve_metrics_and_exporters():
    def prog(rt, sv):
        sv.create_backend("met:v1", lambda x=None: x)
        sv.create_endpoint("met", backend="met:v1")
        h = sv.get_handle("met")
        rt.get([h.remote(i) for i in range(25)])
        s = sv.stat()
        ep = s["metrics"]["endpoints"]["met"]
        ordered = 0 < ep["latency_ms_p50"] <= ep["latency_ms_p99"]

        sv.create_backend("boom:v1", lambda x=None: 1 / 0)
        sv.create_endpoint("boom", backend="boom:v1")
        try:
            rt.get(sv.get_handle("boom").remote(1))
            raised = None
        except Exception as e:  # noqa: BLE001 - the error is the subject
            raised = _err(e)
        text = sv.stat(exporter=sv.PrometheusExporter())
        count = [ln for ln in text.splitlines()
                 if ln.startswith("ray_serve_endpoint_count")]
        return (_counts(s), ordered, raised, _counts(sv.stat()),
                _series(text), count)

    first, ordered, raised, after, series, count = same(prog)
    assert ordered and raised == ["TaskError", "ZeroDivisionError"]
    assert first["metrics"]["endpoints"]["met"]["count"] == 25
    assert first["metrics"]["backends"]["met:v1"]["count"] == 25
    assert after["metrics"]["endpoints"]["boom"]["errors"] == 1
    assert 'ray_serve_backend_latency_ms_p50{backend="met:v1"}' in series
    assert count == ['ray_serve_endpoint_count{endpoint="met"} 25',
                     'ray_serve_endpoint_count{endpoint="boom"} 1']


def _read_http_response(s):
    """Read one HTTP response (head + Content-Length body) from a raw
    socket; fails fast on early close."""
    buf = b""
    while b"\r\n\r\n" not in buf:
        chunk = s.recv(4096)
        assert chunk, "connection closed mid-response"
        buf += chunk
    head, _, rest = buf.partition(b"\r\n\r\n")
    length = int([ln.split(b":")[1] for ln in head.split(b"\r\n")
                  if ln.lower().startswith(b"content-length")][0])
    while len(rest) < length:
        chunk = s.recv(4096)
        assert chunk, "connection closed mid-body"
        rest += chunk
    return head, rest[:length]


def test_http_ingress_concurrent_with_idle_connections():
    def prog(rt, sv):
        release = threading.Event()

        def double(x):
            release.wait(10)
            return x * 2

        sv.create_backend("http-conc", double,
                          config=sv.BackendConfig(num_replicas=2,
                                                  max_concurrent_queries=32,
                                                  replica_concurrency=32))
        sv.create_endpoint("http-conc-ep", backend="http-conc",
                           route="/dbl", methods=["POST"])
        addr = sv.http_address()
        host, port = addr.split("//")[1].split(":")
        idle = [socket.create_connection((host, int(port)), timeout=10)
                for _ in range(100)]
        try:
            results = [None] * 20

            def req(i):
                body = json.dumps({"args": [i]}).encode()
                r = urllib.request.Request(
                    f"{addr}/dbl", data=body,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(r, timeout=60) as resp:
                    results[i] = json.loads(resp.read())["result"]

            ts = [threading.Thread(target=req, args=(i,)) for i in range(20)]
            for t in ts:
                t.start()
            release.set()
            for t in ts:
                t.join(60)
            assert not any(t.is_alive() for t in ts)
            # keep-alive: one connection serves several sequential requests
            s = socket.create_connection((host, int(port)), timeout=10)
            replies = []
            for i in (3, 5):
                body = json.dumps({"args": [i]}).encode()
                s.sendall((f"POST /dbl HTTP/1.1\r\nHost: x\r\n"
                           f"Content-Type: application/json\r\n"
                           f"Content-Length: {len(body)}\r\n\r\n"
                           ).encode() + body)
                replies.append(_read_http_response(s))
            s.close()
        finally:
            for c in idle:
                c.close()
        return results, replies

    results, replies = same(prog, http_port=0)
    assert results == [i * 2 for i in range(20)]
    assert [json.loads(b)["result"] for _, b in replies] == [6, 10]


def test_http_ingress_expect_100_continue():
    def prog(rt, sv):
        sv.create_backend("http-exp", lambda x: len(x))
        sv.create_endpoint("http-exp-ep", backend="http-exp",
                           route="/len", methods=["POST"])
        host, port = sv.http_address().split("//")[1].split(":")
        body = json.dumps({"args": ["z" * 3000]}).encode()
        s = socket.create_connection((host, int(port)), timeout=15)
        s.sendall((f"POST /len HTTP/1.1\r\nHost: x\r\n"
                   f"Content-Type: application/json\r\n"
                   f"Expect: 100-continue\r\n"
                   f"Content-Length: {len(body)}\r\n\r\n").encode())
        interim = b""
        while b"\r\n\r\n" not in interim:
            chunk = s.recv(4096)
            assert chunk, "connection closed before 100 Continue"
            interim += chunk
        s.sendall(body)
        head, payload = _read_http_response(s)
        s.close()
        return interim, head, payload

    interim, head, payload = same(prog, http_port=0)
    assert interim == b"HTTP/1.1 100 Continue\r\n\r\n"
    assert head.split(b"\r\n")[0] == b"HTTP/1.1 200 OK"
    assert json.loads(payload) == {"result": 3000}


# --------------------------------- twins of test_engine.py's serve cases


def test_lm_backend_cross_batches_behind_serve(model):
    """Concurrent calls share engine decode steps through the router's
    batching; every caller gets JAX's tokens."""
    def prog(rt, sv):
        params, cfg, kw = model[rt]
        sizes = []

        class Counting(sv.LMBackend):
            @sv.accept_batch
            def __call__(self, requests):
                sizes.append(len(requests))
                return super().__call__(requests)

        sv.create_backend(
            "lm:v1", Counting, params, cfg, **kw,
            config=sv.BackendConfig(max_batch_size=4,
                                    batch_wait_timeout_s=0.05,
                                    max_concurrent_queries=8))
        sv.create_endpoint("gen", backend="lm:v1")
        h = sv.get_handle("gen")
        prompts = [[i + 1, i + 2, i + 3] for i in range(6)]
        outs = rt.get([h.remote(p, max_new_tokens=4) for p in prompts],
                      timeout=120)
        return outs, sum(sizes), max(sizes) > 1

    outs, n, batched = same(prog)
    assert n == 6 and batched and all(len(o) == 4 for o in outs)


def test_lm_backend_token_streaming(model):
    """``handle.stream()`` gives the whole response's tokens; two streams
    interleave on shared slots; an early close frees its slot."""
    def prog(rt, sv):
        params, cfg, kw = model[rt]
        sv.create_backend(
            "lm:stream", sv.LMBackend, params, cfg, max_slots=2, **kw,
            config=sv.BackendConfig(max_concurrent_queries=8,
                                    replica_concurrency=4))
        sv.create_endpoint("gen_s", backend="lm:stream")
        h = sv.get_handle("gen_s")
        whole = rt.get(h.remote([1, 2, 3], max_new_tokens=5))
        streamed = list(h.stream([1, 2, 3], max_new_tokens=5))
        g1 = h.stream([2, 3, 4], max_new_tokens=4)
        g2 = h.stream([5, 6], max_new_tokens=4)
        pairs = list(zip(g1, g2))
        g = h.stream([1, 2], max_new_tokens=30)
        first = next(g)
        g.close()
        after = list(h.stream([3, 4], max_new_tokens=3))
        short = rt.get([h.remote([2, 3, 4], max_new_tokens=4),
                        h.remote([5, 6], max_new_tokens=4),
                        h.remote([1, 2], max_new_tokens=1),
                        h.remote([3, 4], max_new_tokens=3)])
        return whole, streamed, pairs, first, after, short, \
            sv.stat()["streams"]

    whole, streamed, pairs, first, after, short, live = same(prog)
    assert streamed == whole
    assert [a for a, _ in pairs] == short[0]
    assert [b for _, b in pairs] == short[1]
    assert [first] == short[2] and after == short[3] and live == 0


def _ndjson_stream(addr, path, body):
    """Status, Content-Type and the decoded NDJSON lines of one streamed
    request."""
    req = urllib.request.Request(
        f"{addr}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    chunks = []
    with urllib.request.urlopen(req, timeout=120) as resp:
        status, ctype = resp.status, resp.headers.get("Content-Type")
        for line in resp:
            if line.strip():
                chunks.append(json.loads(line))
    return status, ctype, chunks


def test_http_streaming_of_the_lm(model):
    """The LM's HTTP stream: its tokens are the whole response's, its type
    is NDJSON, and its last chunk is ``done`` (how many chunks the tokens
    arrive in depends on the long-poll; the gated test below holds that)."""
    def prog(rt, sv):
        params, cfg, kw = model[rt]
        sv.create_backend(
            "lm:http", sv.LMBackend, params, cfg, **kw,
            config=sv.BackendConfig(max_concurrent_queries=8,
                                    replica_concurrency=4))
        sv.create_endpoint("gen_h", backend="lm:http", route="/generate",
                           methods=["POST"])
        whole = rt.get(sv.get_handle("gen_h").remote([1, 2, 3],
                                                     max_new_tokens=4))
        status, ctype, chunks = _ndjson_stream(
            sv.http_address(), "/generate",
            {"args": [[1, 2, 3]], "kwargs": {"max_new_tokens": 4,
                                             "stream": True}})
        toks = [t for c in chunks for t in c["tokens"]]
        return (status, ctype, toks == whole, chunks[-1]["done"],
                any(c["done"] for c in chunks[:-1]), whole)

    status, ctype, equal, done, early, _ = same(prog, http_port=0)
    assert (status, ctype) == (200, "application/x-ndjson")
    assert equal and done and not early


def _next_chunk(s, buf):
    """One chunk of a chunked body: (its payload, the bytes after it)."""
    while b"\r\n" not in buf:
        buf += s.recv(4096)
    size, _, buf = buf.partition(b"\r\n")
    n = int(size, 16)
    while len(buf) < n + 2:
        chunk = s.recv(4096)
        assert chunk, "connection closed mid-chunk"
        buf += chunk
    assert buf[n:n + 2] == b"\r\n"
    return buf[:n], buf[n + 2:]


class Gated:
    """A streaming backend whose stream gives one token each time the test
    releases its gate: 1, 2, ... up to ``total``."""

    def __init__(self, gate):
        self.gate = gate
        self.streams = {}

    def stream_start(self, total):
        token = f"g{len(self.streams)}"
        self.streams[token] = [0, int(total)]
        return token

    def stream_poll(self, token, wait_s=2.0):
        st = self.streams[token]
        if not self.gate.acquire(timeout=wait_s):
            return {"tokens": [], "done": False}
        st[0] += 1
        return {"tokens": [st[0]], "done": st[0] >= st[1]}

    def stream_cancel(self, token):
        return self.streams.pop(token, None) is not None


def test_http_streaming_arrives_chunk_by_chunk():
    """Each token the backend releases reaches the HTTP client as its own
    chunk before the next is released: incremental arrival, shown step by
    step rather than counted after the fact."""
    def prog(rt, sv):
        gate = threading.Semaphore(0)
        sv.create_backend("gated", Gated, gate, config=sv.BackendConfig(
            replica_concurrency=4))
        sv.create_endpoint("gated", backend="gated", route="/g",
                           methods=["POST"])
        host, port = sv.http_address().split("//")[1].split(":")
        body = json.dumps({"args": [3], "kwargs": {"stream": True}})
        s = socket.create_connection((host, int(port)), timeout=30)
        s.sendall((f"POST /g HTTP/1.1\r\nHost: x\r\n"
                   f"Content-Length: {len(body)}\r\n\r\n{body}").encode())
        buf = b""
        while b"\r\n\r\n" not in buf:
            buf += s.recv(4096)
        head, _, buf = buf.partition(b"\r\n\r\n")
        steps = []
        for _ in range(4):
            if len(steps) < 3:
                gate.release()
            payload, buf = _next_chunk(s, buf)
            steps.append(payload)
        assert buf == b""
        s.close()
        return head, steps

    head, steps = same(prog, http_port=0)
    assert head.split(b"\r\n")[:2] == [
        b"HTTP/1.1 200 OK", b"Content-Type: application/x-ndjson"]
    want = [json.dumps({"tokens": [i], "done": i == 3}).encode() + b"\n"
            for i in (1, 2, 3)]
    assert steps == want + [b""]


def test_lm_backend_stats_through_a_handle(model):
    """Speculative serving behind serve, its telemetry through
    ``handle.options(method="stats")``, on both engines (the reference's
    tensor-parallel cases at tp 1: the port has no tp yet)."""
    def prog(rt, sv):
        params, cfg, kw = model[rt]
        sv.create_backend(
            "lm:spec", sv.LMBackend, params, cfg, speculative_k=3, **kw,
            config=sv.BackendConfig(max_concurrent_queries=8))
        sv.create_backend(
            "lm:pspec", sv.LMBackend, params, cfg, paged=True, page_size=8,
            speculative_k=3, **kw,
            config=sv.BackendConfig(max_concurrent_queries=8))
        sv.create_endpoint("gen_spec", backend="lm:spec")
        sv.create_endpoint("gen_pspec", backend="lm:pspec")
        prompt = [5, 6, 7, 5, 6, 7, 5]
        out = []
        for ep in ("gen_spec", "gen_pspec"):
            h = sv.get_handle(ep)
            out.append(rt.get(h.remote(prompt, max_new_tokens=6),
                              timeout=120))
            out.append(rt.get(h.options(method="stats").remote(),
                              timeout=60))
        return out

    tokens, stats, ptokens, pstats = same(prog)
    assert tokens == ptokens
    assert stats["slots"] == 8 and stats["speculative"]["ticks"] > 0
    assert pstats["speculative"]["ticks"] > 0


def test_serve_api_needs_init():
    for sv in SERVE.values():
        with pytest.raises(RuntimeError, match="serve.init"):
            sv.list_backends()
        assert sv.shutdown() is None


def test_shutdown_leaves_no_serve_thread(model):
    """serve.shutdown() ends the reconcile thread and the HTTP loop in both
    packages (bounded wait). The killed replica's LM pump ends only in the
    port, whose replica closes its LMBackend (C8); the reference's keeps
    it."""
    names = ("serve-reconcile", "serve-http", "lm-engine-pump")
    left = {}
    for rt in PKGS:
        sv = SERVE[rt]
        params, cfg, kw = model[rt]
        before = set(threading.enumerate())
        rt.init(num_cpus=8)
        sv.init(http_port=0)
        sv.create_backend("lm:t", sv.LMBackend, params, cfg, **kw)
        sv.create_endpoint("t", backend="lm:t")
        rt.get(sv.get_handle("t").remote([1, 2], max_new_tokens=2))
        live = {t.name for t in threading.enumerate()}
        assert set(names) <= live, live
        sv.shutdown()
        keeps = {"lm-engine-pump"} if rt is ray_tpu else set()
        deadline = time.monotonic() + 10
        while True:
            left[rt] = sorted(t.name for t in threading.enumerate()
                              if t not in before and t.name in names)
            if set(left[rt]) <= keeps or time.monotonic() > deadline:
                break
            time.sleep(0.02)
        rt.shutdown()
    assert left == {ray_tpu: ["lm-engine-pump"], ray_tpu_torch: []}


def test_lm_backend_behind_serve_defaults_to_the_card(model):
    """No fallback: an LMBackend created through serve without ``device``
    is built for the card, so on a machine without one its replica fails
    to construct and create_backend raises, naming the missing device."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    params, cfg, _ = model[ray_tpu_torch]
    ray_tpu_torch.init(num_cpus=8)
    tserve.init()
    with pytest.raises(ray_tpu_torch.ActorDiedError,
                       match="no CUDA device"):
        tserve.create_backend("lm:card", tserve.LMBackend, params, cfg)
