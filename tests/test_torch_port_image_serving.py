"""PyTorch port, image classification and its serving: uint8 images
against float ones, ``predict_classes`` against the JAX package's at the
same weights, and ``launch()`` on the CPU answering raw uint8 requests
with the model's own top class, with no image decoder imported.

Small configuration: ``ImageClassifier(class_num=10, backbone="resnet18",
image_size=32)``, f32, seeded weights; images made from a seed with
numpy.
"""

import sys
import time

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models.image.classifier import (
    ImageClassifier as RefImageClassifier)
from analytics_zoo_tpu_torch.bridge import variables_from_module
from analytics_zoo_tpu_torch.models import ImageClassifier
from analytics_zoo_tpu_torch.serving.launcher import launch

torch.set_num_threads(2)

CFG = dict(class_num=10, backbone="resnet18", image_size=32)
N_REQ = 12


@pytest.fixture(autouse=True)
def _drop_port_flight_recorder():
    # launch() installs the port's process-wide crash hooks
    yield
    from analytics_zoo_tpu_torch.obs.flight import (
        uninstall_flight_recorder)

    uninstall_flight_recorder()


@pytest.fixture(scope="module")
def model():
    return ImageClassifier(device="cpu", seed=3, **CFG)


def _uint8(n, seed):
    return np.random.RandomState(seed).randint(
        0, 256, (n, 32, 32, 3)).astype(np.uint8)


def test_uint8_is_normalized_on_the_device(model):
    """uint8 images give the logits of their host-preprocessed floats;
    float images (taken as raw 0-255 by ``predict_classes``) give the
    same classes as the uint8 ones."""
    x = _uint8(6, 1)
    np.testing.assert_allclose(
        model.predict(x, batch_size=6),
        model.predict(ImageClassifier.preprocess(x), batch_size=6),
        atol=1e-4)
    raw = model.predict_classes(x, batch_size=6, top_k=3)
    floats = model.predict_classes(x.astype(np.float32), batch_size=6,
                                   top_k=3)
    assert [[c for c, _ in row] for row in raw] == \
        [[c for c, _ in row] for row in floats]
    np.testing.assert_allclose([[p for _, p in row] for row in raw],
                               [[p for _, p in row] for row in floats],
                               atol=1e-5)


def test_predict_classes_matches_reference(model):
    ref = RefImageClassifier(**CFG)
    ref.estimator.variables = jax.tree_util.tree_map(
        jax.numpy.asarray, variables_from_module(model.module))
    x = _uint8(8, 2)
    want = ref.predict_classes(x, batch_size=8, top_k=3)
    got = model.predict_classes(x, batch_size=8, top_k=3)
    assert [[c for c, _ in row] for row in got] == \
        [[c for c, _ in row] for row in want]
    np.testing.assert_allclose([[p for _, p in row] for row in got],
                               [[p for _, p in row] for row in want],
                               atol=1e-5)


def test_launch_serves_uint8_images(tmp_path, model, monkeypatch):
    """``launch()`` over a saved ImageClassifier, warmed with a uint8
    example, answers each raw uint8 [32, 32, 3] request once with the
    logits of ``predict`` and the top class of ``predict_classes``; no
    module of the path imports PIL (raw arrays need no decoder)."""
    path = str(tmp_path / "classifier")
    model.save_model(path)
    # an import of PIL anywhere on the path now raises
    monkeypatch.setitem(sys.modules, "PIL", None)
    images = _uint8(N_REQ, 3)
    app = launch({"model": {"path": path},
                  "params": {"batch_size": 4, "max_batch_size": 4,
                             "timeout_ms": 2.0, "pipeline_depth": 3,
                             "warm_example": np.zeros((1, 32, 32, 3),
                                                      np.uint8)},
                  "http": {"enabled": False}}, device="cpu")
    got = {}
    try:
        for i in range(N_REQ):
            assert app.input_queue.enqueue(f"img{i:02d}", image=images[i])
        deadline = time.monotonic() + 60.0
        while len(got) < N_REQ and time.monotonic() < deadline:
            item = app.output_queue.dequeue(timeout=0.5)
            if item is None:
                continue
            uri, tensors = item
            assert uri not in got, f"{uri} answered twice"
            got[uri] = tensors
        assert app.output_queue.dequeue(timeout=0.2) is None
    finally:
        app.stop()
    assert sorted(got) == [f"img{i:02d}" for i in range(N_REQ)]
    logits = np.stack([got[f"img{i:02d}"]["output"] for i in range(N_REQ)])
    np.testing.assert_allclose(logits, model.predict(images, batch_size=4),
                               atol=1e-4)
    classes = model.predict_classes(images, batch_size=4)
    assert [int(np.argmax(row)) for row in logits] == \
        [row[0][0] for row in classes]
