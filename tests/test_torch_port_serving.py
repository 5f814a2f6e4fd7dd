"""PyTorch port, serving: ``launch()`` -> ``ServingWorker`` ->
``InferenceModel`` on the CPU answers every request exactly once with
the JAX package's prediction at the same (bridged) weights, through
both engines; and the AZT1 wire format is byte-identical across the two
packages.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.inference.inference_model import (
    InferenceModel as JaxInferenceModel)
from analytics_zoo_tpu.models.text.bert_estimators import (
    _BERTHeadModule as JaxBERTHead)
from analytics_zoo_tpu.serving import queues as jax_queues
from analytics_zoo_tpu_torch.bridge import load_flax_into
from analytics_zoo_tpu_torch.inference.inference_model import (
    DeviceResult, InferenceModel)
from analytics_zoo_tpu_torch.models.text.bert_estimators import (
    BERTClassifier)
from analytics_zoo_tpu_torch.serving import queues as port_queues
from analytics_zoo_tpu_torch.serving.launcher import launch

torch.set_num_threads(2)

CFG = dict(vocab=512, num_classes=3, hidden_size=128, n_block=2,
           n_head=2, intermediate_size=256, max_position_len=256)
SEQ, N_REQ = 128, 20


@pytest.fixture(autouse=True)
def _drop_port_flight_recorder():
    # launch() installs the port's process-wide crash hooks; take them
    # out again so later tests in this process see the hooks they set
    yield
    from analytics_zoo_tpu_torch.obs.flight import (
        uninstall_flight_recorder)

    uninstall_flight_recorder()


@pytest.fixture(scope="module")
def bridged(tmp_path_factory):
    """A JAX-initialised f32 BERT classifier, the JAX package's
    InferenceModel over it, and the same weights saved as a port
    ZooModel directory."""
    jm = JaxBERTHead(per_token=False, **CFG)
    ids = jnp.zeros((1, SEQ), jnp.int32)
    variables = jm.init(jax.random.PRNGKey(0), ids)
    jax_model = JaxInferenceModel().load_flax(jm, variables=variables)
    port = BERTClassifier(device="cpu", **CFG)
    load_flax_into(port.module, jax.tree_util.tree_map(np.asarray,
                                                       variables))
    path = str(tmp_path_factory.mktemp("port_bert"))
    port.save_model(path)
    rng = np.random.RandomState(11)
    reqs = {f"r{i:03d}": rng.randint(0, CFG["vocab"], SEQ).astype(np.int32)
            for i in range(N_REQ)}
    return jax_model, path, reqs


def _serve(app, reqs, timeout_s=60.0):
    for uri, ids in reqs.items():
        assert app.input_queue.enqueue(uri, input_ids=ids)
    got = {}
    deadline = time.monotonic() + timeout_s
    while len(got) < len(reqs) and time.monotonic() < deadline:
        item = app.output_queue.dequeue(timeout=0.5)
        if item is None:
            continue
        uri, tensors = item
        assert uri not in got, f"{uri} answered twice"
        got[uri] = tensors
    # nothing more arrives once every request is answered
    assert app.output_queue.dequeue(timeout=0.2) is None
    return got


class TestLaunchServesBridgedBERT:
    @pytest.mark.parametrize("pipelined", [True, False])
    def test_every_request_answered_once_like_jax(self, bridged,
                                                  pipelined):
        jax_model, path, reqs = bridged
        app = launch({"model": {"path": path},
                      "params": {"batch_size": 4, "pipelined": pipelined,
                                 "warm_batch_sizes": [1, 4],
                                 "warm_example": np.zeros((1, SEQ),
                                                          np.int32)},
                      "http": {"enabled": False}}, device="cpu")
        try:
            assert app.worker.pipelined is pipelined
            got = _serve(app, reqs)
        finally:
            app.stop()
        assert sorted(got) == sorted(reqs)
        uris = sorted(reqs)
        want = jax_model.predict(np.stack([reqs[u] for u in uris]))
        served = np.stack([got[u]["output"] for u in uris])
        assert served.shape == (N_REQ, CFG["num_classes"])
        # f32 model, same weights: the frameworks differ only in
        # summation order
        np.testing.assert_allclose(served, want, atol=1e-4)

    def test_entry_points_raise_without_a_gpu(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is visible")
        with pytest.raises(RuntimeError, match="CUDA"):
            InferenceModel()
        with pytest.raises(RuntimeError, match="CUDA"):
            launch({"model": {"path": "unused"},
                    "http": {"enabled": False}})

    @pytest.mark.parametrize("config", [
        {"http": {"enabled": True}},
        {"http": {"enabled": False}, "data": {"queue": "tcp"}},
        {"http": {"enabled": False}, "generation": {"role": "prefill"}},
        {"http": {"enabled": False}, "shard": {"mode": "tp"}},
    ])
    def test_unported_options_raise(self, config):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            launch(dict(config, model={"path": "unused"}), device="cpu")


class TestInferenceModel:
    def test_predict_async_pads_to_bucket(self, bridged):
        _, path, reqs = bridged
        model = InferenceModel(device="cpu").load_zoo(path)
        x = np.stack([reqs[u] for u in sorted(reqs)[:3]])
        out, n = model.predict_async(x)
        assert n == 3 and isinstance(out, DeviceResult)
        padded = np.asarray(out)
        assert padded.shape == (4, CFG["num_classes"])  # bucket of 3 is 4
        np.testing.assert_array_equal(padded[:n], model.predict(x))


class TestWireFormat:
    CASES = [
        ("u1", {"input_ids": np.arange(7, dtype=np.int32)}, {}),
        ("u2", {"x": np.ones((2, 3), np.float32),
                "s": np.asarray("text")},
         dict(reply_to="r", trace_id="t", deadline=1.5, tenant=2,
              priority=1)),
        ("u3", {"tokens": np.zeros(0, np.int32)},
         dict(max_tokens=8, eos=3)),
    ]

    @pytest.mark.parametrize("uri,tensors,meta", CASES)
    def test_blobs_identical_and_cross_decode(self, uri, tensors, meta):
        jax_blob = jax_queues._encode(uri, tensors, **meta)
        port_blob = port_queues._encode(uri, tensors, **meta)
        assert jax_blob == port_blob
        for blob, dec in ((jax_blob, port_queues._decode_predict),
                          (port_blob, jax_queues._decode_predict)):
            got = dec(blob)
            want = jax_queues._decode_predict(jax_blob)
            assert got[0] == want[0] and got[2:] == want[2:]
            assert sorted(got[1]) == sorted(tensors)
            for k, v in tensors.items():
                np.testing.assert_array_equal(got[1][k], v)
                assert got[1][k].dtype == v.dtype
