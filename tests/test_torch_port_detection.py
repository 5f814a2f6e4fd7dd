"""PyTorch port, image models slice: ``models/image/detection.py``,
``object_detection.py`` (SSD) and ``faster_rcnn.py`` held against the
JAX package on the CPU.

The host-side geometry (IoU, NMS and its order, box encoding, anchor
matching with its forced matches, clipping, per-class detection, both
anchor generators) must be equal to the reference's. ``multibox_loss``
and its gradient on matched targets, with tied losses among the
negatives (the ranking is stable in both); ``SSDModule``'s forward and
one train step's gradients and statistics; three Adam steps of
``ObjectDetector.fit`` against the reference's Estimator; both
detectors' ``detect`` lists; ``roi_align`` and its gradient against the
reference's vmapped function; ``FasterRCNNModule``'s proposals, logits
and deltas; saves in both directions (the ``label_map`` survives), and
an ``ImageClassifier("mobilenet-v2")``'s; and ``visualize``'s array.

The models run at small sizes (64 x 64 images, narrow widths); their
trees at the classes' defaults are checked against flax's
(``jax.eval_shape``). Weights are the port's seeded draw with every
BatchNorm's scale, bias and running statistics and every bias drawn,
carried to flax by ``bridge``; inputs come from a seed with numpy. f32
within 1e-4 (1 + |ref|).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.learn import optim as ref_optim
from analytics_zoo_tpu.models.common import ZooModel as RefZooModel
from analytics_zoo_tpu.models.image import detection as ref_det
from analytics_zoo_tpu.models.image import faster_rcnn as ref_frcnn
from analytics_zoo_tpu.models.image import object_detection as ref_od
from analytics_zoo_tpu.models.image.classifier import (
    ImageClassifier as RefImageClassifier)
from analytics_zoo_tpu_torch.bridge import (flatten, kernel_layouts,
                                            load_flax_into,
                                            state_dict_from_flax,
                                            variables_from_module)
from analytics_zoo_tpu_torch.keras.layers.normalization import BatchNorm
from analytics_zoo_tpu_torch.learn import optim
from analytics_zoo_tpu_torch.learn.optim import batch_stats_tree, param_tree
from analytics_zoo_tpu_torch.models import (ImageClassifier, ObjectDetector,
                                            ZooModel)
from analytics_zoo_tpu_torch.models.image import (detection, faster_rcnn,
                                                  object_detection)
from analytics_zoo_tpu_torch.models.image.faster_rcnn import FasterRCNN

torch.set_num_threads(2)

F32 = 1e-4
# Adam's epsilon in the Estimator runs (the ResNet tests' reason: an
# element whose gradient is near 0 would turn f32 rounding into an
# update of up to lr)
ADAM_EPS = 1e-3
SIZE, CLASSES = 64, 3
SSD = dict(class_num=CLASSES, image_size=SIZE, widths=(16, 32),
           anchors_per_cell=3)
FRCNN = dict(class_num=CLASSES, image_size=SIZE, width=16, top_k=8, pool=3)


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    excess = np.abs(got - want) - tol * (1.0 + np.abs(want))
    assert excess.max(initial=-1) <= 0, f"{what}: max excess {excess.max():.3g}"


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _draw(module, seed):
    """Seeded weights: kernels normal at 1 / sqrt(fan_in), every bias,
    BatchNorm scale and running statistic drawn too."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm):
                c = m.weight.numel()
                m.weight.copy_(torch.rand(c, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.2)
                m.mean.copy_(torch.randn(c, generator=gen) * 0.2)
                m.var.copy_(torch.rand(c, generator=gen) + 0.5)
                continue
            for name, p in m.named_parameters(recurse=False):
                scale = (p[0].numel() ** -0.5 if name == "weight" else 0.2)
                p.copy_(torch.randn(p.shape, generator=gen) * scale)
    return module


def toy_scene(rng, size=SIZE, classes=CLASSES):
    """A dim noise image with one to three bright rectangles, each
    labelled with a foreground class (1..classes)."""
    img = rng.rand(size, size, 3).astype(np.float32) * 0.1
    boxes, labels = [], []
    for _ in range(rng.randint(1, 4)):
        w, h = rng.randint(size // 4, size // 2, 2)
        x1, y1 = rng.randint(0, size - w), rng.randint(0, size - h)
        img[y1:y1 + h, x1:x1 + w] = rng.rand(3) * 0.5 + 0.5
        boxes.append([x1, y1, x1 + w, y1 + h])
        labels.append(rng.randint(1, classes + 1))
    return img, np.asarray(boxes, np.float32), np.asarray(labels, np.int32)


def _scenes(n, seed):
    rng = np.random.RandomState(seed)
    data = [toy_scene(rng) for _ in range(n)]
    return np.stack([d[0] for d in data]), [(d[1], d[2]) for d in data]


def _shapes(tree):
    return {k: tuple(np.shape(v)) for k, v in flatten(tree).items()}


# --------------------------------------------------- host-side geometry --
def _boxes(rng, n, size=64.0):
    xy = rng.rand(n, 2) * size * 0.8
    wh = rng.rand(n, 2) * size * 0.4 + 1.0
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_iou_nms_and_box_codes_are_the_reference_s():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 30), _boxes(rng, 20)
    np.testing.assert_array_equal(detection.bbox_iou(a, b),
                                  ref_det.bbox_iou(a, b))
    # scores with ties: NMS keeps the reference's order
    scores = np.round(rng.rand(30), 1).astype(np.float32)
    for thr, k in ((0.45, 200), (0.2, 5), (0.9, 200)):
        np.testing.assert_array_equal(detection.nms(a, scores, thr, k),
                                      ref_det.nms(a, scores, thr, k))
    deltas = rng.randn(30, 4).astype(np.float32)
    np.testing.assert_array_equal(detection.decode_boxes(a, deltas),
                                  ref_det.decode_boxes(a, deltas))
    np.testing.assert_array_equal(detection.encode_boxes(a, b[:1].repeat(
        30, 0)), ref_det.encode_boxes(a, b[:1].repeat(30, 0)))
    np.testing.assert_array_equal(detection.clip_boxes(a * 1.5 - 10, 50, 60),
                                  ref_det.clip_boxes(a * 1.5 - 10, 50, 60))


def test_match_anchors_and_detect_per_class_are_the_reference_s():
    rng = np.random.RandomState(1)
    anchors = _boxes(rng, 200)
    # one ground truth overlaps nothing above the threshold: it still
    # claims its best anchor
    gt = np.concatenate([_boxes(rng, 3), [[30, 30, 31, 31]]]).astype(
        np.float32)
    labels = np.asarray([1, 2, 3, 2], np.int32)
    got = detection.match_anchors(anchors, gt, labels)
    want = ref_det.match_anchors(anchors, gt, labels)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[0] == 2).sum() >= 2
    empty = detection.match_anchors(anchors, np.zeros((0, 4)), np.zeros(0))
    assert empty[0].sum() == 0 and np.abs(empty[1]).sum() == 0
    scores = rng.rand(200, 4).astype(np.float32)
    got = detection.detect_per_class(anchors, scores, 0.5, 0.45, 50)
    want = ref_det.detect_per_class(anchors, scores, 0.5, 0.45, 50)
    assert [(c, s) for c, s, _ in got] == [(c, s) for c, s, _ in want]
    for (_, _, g), (_, _, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_anchor_generators_are_the_reference_s():
    args = (300, [38, 19, 10, 5], [0.1, 0.3, 0.5, 0.7],
            [[2.0, 0.5]] * 4)
    np.testing.assert_array_equal(object_detection.generate_anchors(*args),
                                  ref_od.generate_anchors(*args))
    for size, stride in ((128, 8), (64, 8), (100, 16)):
        np.testing.assert_array_equal(
            faster_rcnn.rpn_anchors(size, stride),
            ref_frcnn.rpn_anchors(size, stride))
    for cfg in (dict(class_num=20), SSD, dict(SSD, anchors_per_cell=6)):
        port = ObjectDetector(device="cpu", **cfg)
        np.testing.assert_array_equal(port.anchors,
                                      ref_od.ObjectDetector(**cfg).anchors)
    with pytest.raises(ValueError, match="anchors_per_cell"):
        ObjectDetector(class_num=2, anchors_per_cell=7, device="cpu")


# ------------------------------------------------------------ the trees --
@pytest.mark.parametrize("which", ["ssd", "faster_rcnn"])
def test_trees_match_flax_at_the_defaults(which):
    """``ObjectDetector(20)`` and ``FasterRCNN(20)`` at their default
    widths: flax's paths (the auto-named ``_ConvBlock_k``/``Conv_k`` and
    ``_ConvBNRelu_k``) and shapes."""
    if which == "ssd":
        port, ref = (ObjectDetector(20, device="cpu"),
                     ref_od.ObjectDetector(20))
    else:
        port, ref = FasterRCNN(20, device="cpu"), ref_frcnn.FasterRCNN(20)
    want = jax.eval_shape(ref.estimator.adapter.init, jax.random.PRNGKey(0),
                          ref._example_input())
    assert _shapes(variables_from_module(port.module)) == _shapes(want)


# ---------------------------------------------------------------- SSD --
def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@functools.lru_cache(maxsize=None)
def _ssd_reference():
    """The port's seeded SSD module and, at its weights, the JAX
    package's eval forward and one train step (multibox loss, gradients,
    statistics) on matched toy scenes, from one jitted function in f64:
    in f32 the train-mode norms alone put the reference's own outputs
    5e-5 from its f64 ones (the losses stay f32 in both packages)."""
    port = ObjectDetector(device="cpu", seed=3, **SSD)
    _draw(port.module, 3)
    variables = variables_from_module(port.module)
    x, gt = _scenes(8, 2)
    targets = port.prepare_targets(gt)
    module = ref_od.SSDModule(CLASSES, SIZE, SSD["widths"],
                              SSD["anchors_per_cell"])

    def run(v, x, targets):
        def loss(params):
            preds, new = module.apply(
                {"params": params, "batch_stats": v["batch_stats"]}, x,
                train=True, mutable=["batch_stats"])
            return ref_od.multibox_loss(preds, targets), (preds,
                                                          new["batch_stats"])

        (value, (preds, stats)), grads = jax.value_and_grad(
            loss, has_aux=True)(v["params"])
        return module.apply(v, x), value, preds, stats, grads

    with jax.enable_x64(True):
        ev, loss, preds, stats, grads = _host(jax.jit(run)(
            _f64(variables), x.astype(np.float64), targets))
    return dict(port=port, variables=variables, x=x, gt=gt, targets=targets,
                eval=ev, loss=float(loss), preds=preds, stats=stats,
                grads=grads)


def test_prepare_targets_is_the_reference_s():
    ref = _ssd_reference()
    want = ref_od.ObjectDetector(**SSD).prepare_targets(ref["gt"])
    for g, w in zip(ref["targets"], want):
        np.testing.assert_array_equal(g, w)
    assert (ref["targets"][0] > 0).sum() >= 8


def test_multibox_loss_and_gradient_match():
    """On seeded logits quantized to steps of 0.5 (so that many
    negatives tie on their loss and the mining cut falls among ties: the
    gradient then shows which of them each package kept) and matched
    targets."""
    targets = _ssd_reference()["targets"]
    b, n = targets[0].shape
    rng = np.random.RandomState(4)
    logits = (np.round(rng.randn(b, n, CLASSES + 1) * 2) / 2).astype(
        np.float32)
    deltas = rng.randn(b, n, 4).astype(np.float32)
    (want, want_g) = _host(jax.jit(jax.value_and_grad(
        lambda p: ref_od.multibox_loss(p, targets)))((logits, deltas)))
    preds = (torch.from_numpy(logits).requires_grad_(),
             torch.from_numpy(deltas).requires_grad_())
    got = object_detection.multibox_loss(
        preds, tuple(torch.from_numpy(t) for t in targets))
    got.backward()
    _close(got.item(), want, F32, "loss")
    _close(preds[0].grad.numpy(), want_g[0], F32, "d logits")
    _close(preds[1].grad.numpy(), want_g[1], F32, "d deltas")


def test_ssd_module_forward_and_step_match():
    """The eval forward (class logits and box deltas; f32 against the
    f64 reference), then one train step's multibox loss, gradients,
    train-mode outputs and statistics, both in f64."""
    ref = _ssd_reference()
    module = ref["port"].module
    x = torch.from_numpy(ref["x"])
    with torch.no_grad():
        got = module(x)
    for g, w, what in zip(got, ref["eval"], ("logits", "deltas")):
        _close(g.numpy(), w, F32, f"eval {what}")
    net = object_detection.SSDModule(CLASSES, SIZE, SSD["widths"],
                                     SSD["anchors_per_cell"]).double()
    load_flax_into(net, ref["variables"])
    preds = net(x.double(), train=True)
    loss = object_detection.multibox_loss(
        preds, tuple(torch.from_numpy(t) for t in ref["targets"]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=F32)
    for g, w, what in zip(preds, ref["preds"], ("logits", "deltas")):
        _close(g.detach().numpy(), w, F32, f"train {what}")
    want = state_dict_from_flax(ref["grads"], kernel_layouts(net))
    got = {k: p.grad for k, p in net.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, g in want.items():
        _close(got[k].numpy(), g.numpy(), F32, f"grad {k}")
    want = flatten(ref["stats"])
    for k, s in batch_stats_tree(net).items():
        _close(s.numpy(), want[k], F32, f"stats {k}")


def _flax_variables(module):
    out = {f"params/{k}": v for k, v in flatten(
        variables_from_module(module)["params"]).items()}
    out.update({f"batch_stats/{k}": b.numpy()
                for k, b in batch_stats_tree(module).items()})
    return out


def test_three_adam_steps_match():
    """``ObjectDetector.fit`` against the reference's Estimator: 24 toy
    scenes, batch 8 (three Adam steps, the shuffles alike), both in f64
    (see ``_ssd_reference``); the parameters, statistics, epoch loss and
    ``predict`` after them."""
    ref = _ssd_reference()
    x, gt = _scenes(24, 5)
    x = x.astype(np.float64)
    port = ObjectDetector(device="cpu", **SSD)
    port.module.double()
    load_flax_into(port.module, ref["variables"])
    port.compile(optimizer=optim.Adam(epsilon=ADAM_EPS))
    data = (x, port.prepare_targets(gt))
    got = port.fit(data, batch_size=8, epochs=1)
    assert port.estimator.global_step == 3
    with jax.enable_x64(True):
        jax_model = ref_od.ObjectDetector(**SSD)
        jax_model.compile(optimizer=ref_optim.Adam(epsilon=ADAM_EPS))
        jax_model.estimator.variables = jax.tree_util.tree_map(
            jnp.asarray, _f64(ref["variables"]))
        want = jax_model.fit(data, batch_size=8, epochs=1)
        fitted = flatten(_host(jax_model.estimator.variables))
        jax_pred = _host(jax_model.predict(x[:8], batch_size=8))
    np.testing.assert_allclose(got[0]["loss"], want[0]["loss"], rtol=F32)
    mine = _flax_variables(port.module)
    assert sorted(mine) == sorted(fitted)
    for k, v in fitted.items():
        _close(mine[k], v, F32, k)
    for g, w in zip(port.predict(x[:8], batch_size=8), jax_pred):
        _close(g, w, F32, "predict")


def _same_detections(got, want):
    assert len(got) == len(want)
    for g_img, w_img in zip(got, want):
        assert [c for c, _, _ in g_img] == [c for c, _, _ in w_img]
        for (_, gs, gb), (_, ws, wb) in zip(g_img, w_img):
            _close(gs, ws, F32, "score")
            _close(gb, wb, F32, "box")
    assert sum(map(len, got)) > 0


def test_ssd_detect_lists_match():
    ref = _ssd_reference()
    jax_model = ref_od.ObjectDetector(**SSD)
    jax_model.estimator.variables = jax.tree_util.tree_map(
        jnp.asarray, ref["variables"])
    kw = dict(batch_size=8, score_threshold=0.3, iou_threshold=0.45,
              top_k=50)
    _same_detections(ref["port"].detect(ref["x"], **kw),
                     jax_model.detect(ref["x"], **kw))


# ------------------------------------------------------- Faster-RCNN --
def test_roi_align_and_gradient_match():
    """A batch of feature maps and boxes (some past the map's edges)
    against the reference's function vmapped over the batch: the crops
    and the gradients of a weighted sum by features and boxes."""
    rng = np.random.RandomState(6)
    feats = rng.randn(2, 8, 8, 5).astype(np.float32)
    boxes = np.concatenate([_boxes(rng, 12, 64.0), [[-8, -4, 20, 30],
                                                    [50, 40, 90, 80]]])
    boxes = boxes.reshape(2, 7, 4).astype(np.float32)
    w = rng.randn(2, 7, 3, 3, 5).astype(np.float32)

    def ref_fn(f, b):
        out = jax.vmap(lambda fi, bi: ref_frcnn.roi_align(fi, bi, 8, 3))(
            f, b)
        return jnp.sum(out * w), out

    (_, want), (want_df, want_db) = _host(jax.jit(jax.value_and_grad(
        ref_fn, argnums=(0, 1), has_aux=True))(feats, boxes))
    f = torch.from_numpy(feats).requires_grad_()
    b = torch.from_numpy(boxes).requires_grad_()
    got = faster_rcnn.roi_align(f, b, 8, 3)
    (got * torch.from_numpy(w)).sum().backward()
    _close(got.detach().numpy(), want, F32, "crops")
    _close(f.grad.numpy(), want_df, F32, "d features")
    _close(b.grad.numpy(), want_db, F32, "d boxes")
    # one image, the reference's signature
    with torch.no_grad():
        one = faster_rcnn.roi_align(f[1], b[1], 8, 3)
    np.testing.assert_array_equal(one.numpy(), got[1].detach().numpy())


@functools.lru_cache(maxsize=None)
def _frcnn_reference():
    port = FasterRCNN(device="cpu", seed=7, **FRCNN)
    _draw(port.module, 7)
    variables = variables_from_module(port.module)
    x, _ = _scenes(8, 8)
    module = ref_frcnn.FasterRCNNModule(anchors=port.anchors, **{
        k: v for k, v in FRCNN.items()})
    want = _host(jax.jit(module.apply)(variables, x))
    return dict(port=port, variables=variables, x=x, out=want)


def test_faster_rcnn_module_matches():
    """Proposals, class logits and box deltas of the eval forward; the
    top-K anchors are the same (no objectness ties in seeded data)."""
    ref = _frcnn_reference()
    with torch.no_grad():
        got = ref["port"].module(torch.from_numpy(ref["x"]))
    for g, w, what in zip(got, ref["out"], ("proposals", "logits",
                                            "deltas")):
        _close(g.numpy(), w, F32, what)


def test_faster_rcnn_detect_lists_match():
    ref = _frcnn_reference()
    jax_model = ref_frcnn.FasterRCNN(**FRCNN)
    jax_model.estimator.variables = jax.tree_util.tree_map(
        jnp.asarray, ref["variables"])
    kw = dict(batch_size=8, score_threshold=0.3, iou_threshold=0.45,
              top_k=50)
    _same_detections(ref["port"].detect(ref["x"], **kw),
                     jax_model.detect(ref["x"], **kw))


# -------------------------------------------------------------- saves --
def _template_for_load(self):
    """``ZooModel._build_for_load`` with the variables' template from
    ``jax.eval_shape`` in place of an eager ``init`` (``load`` overwrites
    every value)."""
    x = self._example_input()
    est = self.estimator
    shapes = jax.eval_shape(est.adapter.init, jax.random.PRNGKey(0), x)
    est.variables = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    est._ensure_built(x)


LABELS = {1: "cat", 2: "dog", 3: "bird"}
SAVES = {"ssd": (ObjectDetector, ref_od.ObjectDetector, SSD,
                 _ssd_reference),
         "faster_rcnn": (FasterRCNN, ref_frcnn.FasterRCNN, FRCNN,
                         _frcnn_reference)}


@pytest.mark.parametrize("which", sorted(SAVES))
def test_port_saved_detector_loads_in_jax(tmp_path, monkeypatch, which):
    cls, ref_cls, cfg, reference = SAVES[which]
    ref = reference()
    port = cls(device="cpu", label_map=LABELS, **cfg)
    load_flax_into(port.module, ref["variables"])
    port.save_model(str(tmp_path))
    monkeypatch.setattr(RefZooModel, "_build_for_load", _template_for_load)
    loaded = RefZooModel.load_model(str(tmp_path))
    assert isinstance(loaded, ref_cls)
    assert loaded.label_of(2) == "dog" and loaded.label_of(9) == "9"
    got = flatten(_host(loaded.estimator.variables))
    for k, v in flatten(ref["variables"]).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    kw = dict(batch_size=8, score_threshold=0.3, top_k=50)
    _same_detections(port.detect(ref["x"], **kw),
                     loaded.detect(ref["x"], **kw))


@pytest.mark.parametrize("which", sorted(SAVES))
def test_jax_saved_detector_loads_in_the_port(tmp_path, which):
    cls, ref_cls, cfg, reference = SAVES[which]
    ref = reference()
    jax_model = ref_cls(label_map=LABELS, **cfg)
    jax_model.estimator.variables = jax.tree_util.tree_map(
        jnp.asarray, ref["variables"])
    jax_model.save_model(str(tmp_path))
    loaded = ZooModel.load_model(str(tmp_path), device="cpu")
    assert isinstance(loaded, cls)
    assert loaded.label_of(3) == "bird" and loaded.label_of(0) == "0"
    want = param_tree(ref["port"].module)
    for k, p in param_tree(loaded.module).items():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      want[k].detach().numpy(), err_msg=k)
    kw = dict(batch_size=8, score_threshold=0.3, top_k=50)
    _same_detections(loaded.detect(ref["x"], **kw),
                     ref["port"].detect(ref["x"], **kw))


# ----------------------------------------------- ImageClassifier saves --
# (the image classifier's saves beside the detectors': one file keeps the
# slice's saved-model checks, and each file stays under 90 s)
IMG = dict(class_num=3, backbone="mobilenet-v2", image_size=32)


@pytest.fixture(scope="module")
def classifiers():
    """The port's seeded ImageClassifier and the JAX package's at its
    weights, with the JAX package's predictions on raw uint8 images."""
    port = ImageClassifier(device="cpu", seed=2, **IMG)
    _draw(port.module, 2)
    ref = RefImageClassifier(**IMG)
    ref.estimator.variables = jax.tree_util.tree_map(
        jnp.asarray, variables_from_module(port.module))
    x = np.random.RandomState(4).randint(0, 256, (8, 32, 32, 3)).astype(
        np.uint8)
    return port, ref, x, np.asarray(ref.predict(x, batch_size=8))


def test_jax_saved_classifier_loads_in_the_port(tmp_path, classifiers):
    port, ref, x, want = classifiers
    ref.save_model(str(tmp_path))
    loaded = ZooModel.load_model(str(tmp_path), device="cpu")
    assert isinstance(loaded, ImageClassifier)
    assert loaded._config["backbone"] == "mobilenet-v2"
    _close(loaded.predict(x, batch_size=8), want, F32, "predict")
    for k, v in loaded.module.state_dict().items():
        np.testing.assert_array_equal(v.numpy(),
                                      port.module.state_dict()[k].numpy())


def test_port_saved_classifier_loads_in_jax(tmp_path, classifiers,
                                            monkeypatch):
    port, ref, x, want = classifiers
    _close(port.predict(x, batch_size=8), want, F32, "port predict")
    port.save_model(str(tmp_path))
    monkeypatch.setattr(RefZooModel, "_build_for_load", _template_for_load)
    loaded = RefZooModel.load_model(str(tmp_path))
    assert isinstance(loaded, RefImageClassifier)
    got = flatten(_host(loaded.estimator.variables))
    for k, v in flatten(variables_from_module(port.module)).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # the JAX package's predictions from the variables it loaded (through
    # the fixture's model, whose predict is compiled already)
    ref.estimator.variables = loaded.estimator.variables
    _close(np.asarray(ref.predict(x, batch_size=8)), want, F32,
           "jax predict")


def test_visualize_matches():
    pytest.importorskip("PIL")
    rng = np.random.RandomState(9)
    image = rng.rand(48, 64, 3) * 300 - 20
    dets = [(c, float(rng.rand()), _boxes(rng, 1, 48.0)[0])
            for c in (1, 2, 7)]
    np.testing.assert_array_equal(
        object_detection.visualize(image, dets, LABELS),
        ref_od.visualize(image, dets, LABELS))
