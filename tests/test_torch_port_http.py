"""PyTorch port, HTTP frontend and rollup reporter: ``HttpFrontend``
(``/predict``, ``/generate`` as an SSE stream or collected, ``/metrics``,
``/metrics.json``, ``/healthz``, the debug routes, draining) and
``maybe_start_reporter``, held against the JAX package's on the CPU, and
``launch()`` from a stock config (no ``http:`` block), which starts
both.

Both packages' deployments run side by side in this process on the same
weights: TinyGenLM's seeded draws are the same numbers in both, and the
BERT classifier's flax variables are carried into the port by
``bridge.load_flax_into``. The wire formats must match byte for byte, so
the SSE responses are read off a raw socket and compared whole, with
only the random request id masked. Mirrors the reference's own tests of
these routes (``tests/test_generation.py`` ``TestHttpGenerate``,
``tests/test_serving.py``'s HTTP cases, ``tests/test_obs.py``
``TestReporter``).
"""

import json
import logging
import re
import socket
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models.text.bert_estimators import (
    _BERTHeadModule as JaxBERTHead)
from analytics_zoo_tpu.serving.launcher import launch as jax_launch
from analytics_zoo_tpu_torch.bridge import load_flax_into
from analytics_zoo_tpu_torch.common.config import get_config
from analytics_zoo_tpu_torch.models.text.bert_estimators import (
    BERTClassifier)
from analytics_zoo_tpu_torch.obs.metrics import MetricsRegistry
from analytics_zoo_tpu_torch.obs.reporter import (Reporter,
                                                  maybe_start_reporter)
from analytics_zoo_tpu_torch.serving import chaos
from analytics_zoo_tpu_torch.serving.generation import (DecodeEngine,
                                                        GenerationWorker,
                                                        TinyGenLM)
from analytics_zoo_tpu_torch.serving.generation.model import GenModelConfig
from analytics_zoo_tpu_torch.serving.http_frontend import HttpFrontend
from analytics_zoo_tpu_torch.serving.launcher import launch
from analytics_zoo_tpu_torch.serving.protocol import DEADLINE_PREFIX
from analytics_zoo_tpu_torch.serving.queues import InputQueue, OutputQueue

torch.set_num_threads(2)

# the generation plane's repo geometry at a small max_len (both packages)
GEN = {"model": {"vocab": 64, "dim": 32, "heads": 2, "head_dim": 16,
                 "layers": 2, "max_len": 64, "seed": 0},
       "slots": 4, "page_size": 4, "max_len": 64}
PROMPTS = [[3, 7, 1, 9, 2], [5, 6], list(range(1, 30)), [63, 0, 62, 1]]
# a small BERT classifier, f32 in both packages
BERT = dict(vocab=256, num_classes=3, hidden_size=64, n_block=1, n_head=2,
            intermediate_size=128, max_position_len=64)
SEQ = 32
# /predict logits, the same f32 model in two frameworks: exact
# arithmetic in another order
PREDICT_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _drop_port_flight_recorder():
    # launch() installs the port's process-wide crash hooks
    yield
    from analytics_zoo_tpu_torch.obs.flight import (
        uninstall_flight_recorder)

    uninstall_flight_recorder()


@pytest.fixture(scope="module")
def gen_apps():
    """A generation deployment of each package from the same stock
    config (no ``http:`` block: the frontend starts on its own)."""
    port = launch({"generation": dict(GEN)}, device="cpu")
    ref = jax_launch({"generation": dict(GEN)})
    yield port, ref
    port.stop()
    ref.stop()


def _post(url, body, timeout=30):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, dict(resp.headers), resp.read()


def _raw_generate(address, body, timeout=30.0):
    """POST /generate over a raw socket: (status line, headers without
    Date, the body bytes as sent: chunk sizes, SSE framing and all)."""
    host, port = address.rsplit("//", 1)[1].rsplit(":", 1)
    payload = json.dumps(body).encode()
    head = (f"POST /generate HTTP/1.1\r\nHost: {host}\r\n"
            "Content-Type: application/json\r\n"
            f"Content-Length: {len(payload)}\r\n\r\n").encode()
    with socket.create_connection((host, int(port)), timeout=timeout) as s:
        s.sendall(head + payload)
        raw = b""
        while True:  # the server closes the connection after the stream
            part = s.recv(65536)
            if not part:
                break
            raw += part
    top, _, data = raw.partition(b"\r\n\r\n")
    status, *lines = top.split(b"\r\n")
    headers = [ln for ln in lines if not ln.startswith(b"Date:")]
    return status, headers, data


def _events(body: bytes):
    """The SSE events of a de-chunked /generate body."""
    return [json.loads(ev[len(b"data: "):])
            for ev in body.split(b"\n\n") if ev]


def _dechunk(data: bytes) -> bytes:
    out = b""
    while True:
        size, _, rest = data.partition(b"\r\n")
        n = int(size, 16)
        if n == 0:
            assert rest == b"\r\n"
            return out
        assert rest[n:n + 2] == b"\r\n"
        out += rest[:n]
        data = rest[n + 2:]


# ------------------------------------------------------------ /generate --
class TestGenerateAgainstReference:
    @pytest.mark.parametrize("i", range(len(PROMPTS)))
    def test_same_stream_and_framing(self, gen_apps, i):
        """The same prompt through both packages' frontends gives the
        same response byte for byte, but for the random request id:
        status line, headers, HTTP chunks, SSE events, token stream."""
        port, ref = gen_apps
        body = {"prompt": PROMPTS[i], "max_tokens": 6}
        got, want = (_raw_generate(app.address, body) for app in (port, ref))
        mask = re.compile(rb'"uri": "[0-9a-f]{32}"')
        assert got[0] == want[0] == b"HTTP/1.1 200 OK"
        assert got[1] == want[1]
        assert mask.sub(b"U", got[2]) == mask.sub(b"U", want[2])
        events = _events(_dechunk(got[2]))
        assert set(events[0]) == {"uri"}
        data = events[1:]
        assert [e["seq"] for e in data] == list(range(len(data)))
        assert data[-1]["finish_reason"] == "length"
        assert data[-1]["n_tokens"] == 6
        toks = [t for e in data for t in e.get("token", [])]
        assert len(toks) == 6

    def test_collected_form(self, gen_apps):
        port, ref = gen_apps
        body = {"prompt": PROMPTS[0], "max_tokens": 4, "stream": False}
        (code, _, got), (ref_code, _, want) = (
            _post(app.address + "/generate", body) for app in gen_apps)
        assert code == ref_code == 200
        assert json.loads(got) == json.loads(want)
        assert len(json.loads(got)["tokens"]) == 4

    def test_stream_carries_trace_id(self, gen_apps):
        port, _ = gen_apps
        get_config().set("zoo.obs.trace.enabled", True)
        try:
            _, _, raw = _raw_generate(port.address,
                                      {"prompt": [1, 2], "max_tokens": 2})
        finally:
            get_config().unset("zoo.obs.trace.enabled")
        assert _events(_dechunk(raw))[0].get("trace_id")

    @pytest.mark.parametrize("body", [
        {"prompt": []}, {"prompt": "abc"}, {"prompt": [1], "max_tokens": "x"},
        {"prompt": [1], "max_tokens": 0}, {}])
    def test_bad_requests_as_reference(self, gen_apps, body):
        (code, _, got), (ref_code, _, want) = (
            _post(app.address + "/generate", body) for app in gen_apps)
        assert code == ref_code == 400
        assert got == want

    def test_draining_refuses_503(self, gen_apps):
        port, _ = gen_apps
        port.frontend.set_draining()
        try:
            code, headers, payload = _post(port.address + "/generate",
                                           {"prompt": [1]})
            predict, _, _ = _post(port.address + "/predict",
                                 {"inputs": {"x": [1]}})
        finally:
            port.frontend._draining = False
        assert code == 503 and predict == 503
        assert headers.get("Retry-After")
        assert json.loads(payload)["error"] == "draining"

    def test_frontend_stall_emits_structured_terminal(self):
        """Chunks stalling past request_timeout (an inter-chunk stall
        detector) end the stream with a structured deadline_exceeded
        event, not a silent close."""
        lm = TinyGenLM(GenModelConfig(**GEN["model"]))
        eng = DecodeEngine(lm, num_slots=2, page_size=4, max_len=64,
                           device="cpu").warm_up()
        in_q, out_q = InputQueue(backend="memory"), OutputQueue(
            backend="memory")
        w = GenerationWorker(eng, in_q, out_q)
        fe = HttpFrontend(InputQueue(backend="memory"), out_q,
                          request_timeout=0.4, gen_queue=in_q,
                          gen_worker=w).start()
        chaos.install(chaos.ChaosInjector(chaos.parse_spec(
            "sleep:dispatch:every=4:dur=0.9")))
        w.start()
        try:
            _, _, raw = _raw_generate(fe.address,
                                      {"prompt": [2, 4], "max_tokens": 60},
                                      timeout=15)
        finally:
            chaos.uninstall()
            fe.stop()
            w.stop()
        events = _events(_dechunk(raw))
        assert events[-1].get("error") == DEADLINE_PREFIX
        assert DEADLINE_PREFIX in events[-1]["detail"]
        assert any("token" in e for e in events)


# ---------------------------------------------------------- other routes --
class TestRoutes:
    def test_metrics_json_and_health(self, gen_apps):
        port, _ = gen_apps
        code, headers, text = _get(port.address + "/metrics")
        assert code == 200
        assert headers["Content-Type"].startswith("text/plain")
        assert b"# TYPE zoo_http_requests_total counter" in text
        code, _, body = _get(port.address + "/metrics.json")
        snap = json.loads(body)
        assert code == 200 and "generation" in snap
        assert snap["registry"]["zoo_http_requests_total"]["type"] == \
            "counter"
        code, _, body = _get(port.address + "/healthz")
        health = json.loads(body)
        assert code == 200 and health["status"] == "ok"
        assert health["generation_served"] >= 0

    def test_welcome_trace_debug_and_404(self, gen_apps):
        port, ref = gen_apps
        for route in ("/", "/nope"):
            got, want = [], []
            for app, out in ((port, got), (ref, want)):
                try:
                    code, _, body = _get(app.address + route)
                except urllib.error.HTTPError as e:
                    code, body = e.code, e.read()
                out.append((code, json.loads(body)))
            assert got == want
        assert json.loads(_get(port.address + "/trace")[2]) is not None
        events = json.loads(_get(port.address + "/debug/events?n=5")[2])
        assert len(events["events"]) <= 5
        build = json.loads(_get(port.address + "/debug/vars")[2])["build"]
        assert build["torch"] == torch.__version__ and build["device"] == "cpu"
        assert "jax" not in build

    def test_generate_404_on_a_predict_only_frontend(self):
        fe = HttpFrontend(InputQueue(backend="memory"),
                          OutputQueue(backend="memory")).start()
        try:
            code, _, body = _post(fe.address + "/generate", {"prompt": [1]})
        finally:
            fe.stop()
        assert code == 404
        assert "not enabled" in json.loads(body)["error"]


# --------------------------------------------------------------- /predict --
@pytest.fixture(scope="module")
def predict_apps(tmp_path_factory):
    """A seeded BERT classifier served by each package's launch() from a
    stock config: the JAX package's weights, saved by the port."""
    jm = JaxBERTHead(per_token=False, **BERT)
    variables = jm.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, SEQ), jnp.int32))
    port_model = BERTClassifier(device="cpu", **BERT)
    load_flax_into(port_model.module,
                   jax.tree_util.tree_map(np.asarray, variables))
    path = str(tmp_path_factory.mktemp("http_bert"))
    port_model.save_model(path)
    config = {"model": {"path": path},
              "params": {"batch_size": 4, "warm_batch_sizes": [1, 4],
                         "warm_example": np.zeros((1, SEQ), np.int32)}}
    port = launch(dict(config), device="cpu")
    ref = jax_launch(dict(config))
    yield port, ref
    port.stop()
    ref.stop()


class TestPredict:
    def test_same_replies_as_reference(self, predict_apps):
        rng = np.random.RandomState(3)
        ids = [rng.randint(0, BERT["vocab"], SEQ).tolist() for _ in range(3)]
        replies = []
        for app in predict_apps:
            code, _, one = _post(app.address + "/predict",
                                 {"inputs": {"input_ids": ids[0]}})
            code2, _, many = _post(app.address + "/predict",
                                   {"instances": [{"input_ids": i}
                                                  for i in ids]})
            assert code == code2 == 200
            replies.append((json.loads(one), json.loads(many)))
        (one, many), (ref_one, ref_many) = replies

        def shape(x):
            if isinstance(x, dict):
                return {k: shape(v) for k, v in x.items()}
            if isinstance(x, list):
                return [shape(v) for v in x]
            return type(x).__name__

        assert shape(one) == shape(ref_one)
        assert shape(many) == shape(ref_many)
        np.testing.assert_allclose(one["predictions"]["output"],
                                   ref_one["predictions"]["output"],
                                   atol=PREDICT_TOL, rtol=PREDICT_TOL)
        for got, want in zip(many["predictions"], ref_many["predictions"]):
            np.testing.assert_allclose(got["output"], want["output"],
                                       atol=PREDICT_TOL, rtol=PREDICT_TOL)

    @pytest.mark.parametrize("bad", [{"nope": 1}, 5, [1, 2],
                                     {"instances": 3},
                                     {"inputs": {"x": [[1], [2, 3]]}}])
    def test_bad_requests_as_reference(self, predict_apps, bad):
        (code, _, got), (ref_code, _, want) = (
            _post(app.address + "/predict", bad) for app in predict_apps)
        assert code == ref_code == 400
        assert got == want

    def test_metrics_and_health_after_predicts(self, predict_apps):
        port, _ = predict_apps
        _post(port.address + "/predict",
              {"inputs": {"input_ids": [1] * SEQ}})
        metrics = json.loads(_get(port.address + "/metrics.json")[2])
        assert metrics["worker"]["served"] >= 1
        assert "predict_request" in metrics["frontend"]
        text = _get(port.address + "/metrics")[2].decode()
        assert "zoo_serving_stage_duration_seconds_bucket" in text
        health = json.loads(_get(port.address + "/healthz")[2])
        assert health["status"] == "ok" and health["served"] >= 1


# --------------------------------------------------------------- launcher --
class TestLauncher:
    def test_stock_config_starts_the_frontend(self):
        """No ``http:`` block: the frontend binds loopback at a free port
        (zoo.serving.http_port 0) and stops with the app."""
        app = launch({"generation": dict(GEN)}, device="cpu")
        try:
            assert app.frontend is not None
            assert app.address.startswith("http://127.0.0.1:")
            assert not app.address.endswith(":0")
            assert _get(app.address + "/healthz")[0] == 200
        finally:
            app.stop()
        with pytest.raises(OSError):
            _get(app.address + "/healthz", timeout=2)

    def test_http_port_key_and_disabled_frontend(self):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            free = s.getsockname()[1]
        get_config().set("zoo.serving.http_port", free)
        try:
            app = launch({"generation": dict(GEN)}, device="cpu")
            try:
                assert app.address == f"http://127.0.0.1:{free}"
            finally:
                app.stop()
        finally:
            get_config().unset("zoo.serving.http_port")
        app = launch({"generation": dict(GEN), "http": {"enabled": False}},
                     device="cpu")
        try:
            assert app.frontend is None and app.address is None
        finally:
            app.stop()

    def test_redis_with_http_raises_the_reference_error(self):
        for run in (lambda c: launch(c, device="cpu"), jax_launch):
            with pytest.raises(ValueError,
                               match="redis.enabled requires http.enabled"):
                run({"generation": dict(GEN), "redis": {"enabled": True}})

    def test_redis_alone_is_not_ported(self):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP queue 1: fleet"):
            launch({"generation": dict(GEN), "http": {"enabled": False},
                    "redis": {"enabled": True}}, device="cpu")

    def test_reporter_logs_its_rollup(self):
        """zoo.obs.report.interval > 0: launch() starts the reporter,
        whose rollup lines reach its log, and stop() stops it with one
        final rollup."""
        seen = []

        class Grab(logging.Handler):
            def emit(self, record):
                seen.append(record.getMessage())

        log = logging.getLogger("analytics_zoo_tpu_torch.obs.reporter")
        grab, level = Grab(), log.level
        log.addHandler(grab)
        log.setLevel(logging.INFO)
        get_config().set("zoo.obs.report.interval", 0.05)
        try:
            app = launch({"generation": dict(GEN)}, device="cpu")
            try:
                assert app.reporter is not None
                _post(app.address + "/generate",
                      {"prompt": [1, 2], "max_tokens": 2, "stream": False})
                deadline = time.monotonic() + 10
                while not seen and time.monotonic() < deadline:
                    time.sleep(0.05)
            finally:
                app.stop()
        finally:
            get_config().unset("zoo.obs.report.interval")
            log.removeHandler(grab)
            log.setLevel(level)
        assert app.reporter._thread is None
        assert any(m.startswith("obs rollup: ") and
                   "zoo_http_requests_total" in m for m in seen), seen


# --------------------------------------------------------------- reporter --
class TestReporter:
    def test_rollup_rates_and_latency(self):
        r = MetricsRegistry()
        c = r.counter("zoo_test_g_total")
        h = r.histogram("zoo_test_h_seconds")
        g = r.gauge("zoo_test_i_items")
        rep = Reporter(registry=r, interval=60.0)
        assert rep.tick(dt=1.0) == "idle"
        c.inc(50)
        h.observe(0.010)
        h.observe(0.030)
        g.set(4)
        line = rep.tick(dt=2.0)
        assert "zoo_test_g_total: 25.0/s" in line
        assert "zoo_test_h_seconds: n=2 mean=20.00ms" in line
        assert "zoo_test_i_items: 4" in line
        g.set(0)
        assert rep.tick(dt=1.0) == "idle"

    def test_rates_use_measured_elapsed_time(self):
        r = MetricsRegistry()
        c = r.counter("zoo_test_n_total")
        rep = Reporter(registry=r, interval=0.01)
        time.sleep(0.2)
        c.inc(10)
        rate = float(rep.tick().split(": ")[1].rstrip("/s"))
        assert rate < 200

    def test_thread_lifecycle_and_config_gate(self):
        assert maybe_start_reporter() is None  # default interval 0
        get_config().set("zoo.obs.report.interval", 0.05)
        try:
            rep = maybe_start_reporter()
            assert rep is not None and rep._thread.is_alive()
            rep.stop()
            assert rep._thread is None
        finally:
            get_config().unset("zoo.obs.report.interval")
        with pytest.raises(ValueError):
            Reporter(registry=MetricsRegistry(), interval=0).start()
