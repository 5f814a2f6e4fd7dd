"""PyTorch port, Keras slice 3b: ``keras/layers/{embedding,recurrent,
torch_ops}.py``, held against the JAX package on the CPU.

Both packages get the same numpy inputs (made from a seed); the port's
weights are the JAX package's, perturbed by a seeded draw so that no
parameter sits at its initial value, and copied across by ``bridge``.
Dropout is off (eval mode) except in the statistics test of
``RReLU``'s training slopes, whose streams differ between the packages.
Tolerances: 1e-5 (1 + |ref|) in f32, 1e-4 after a product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.keras import Sequential as RefSequential
from analytics_zoo_tpu.keras import layers as RL
from analytics_zoo_tpu_torch.bridge import (flatten, kernel_layouts,
                                            load_flax_into, nest,
                                            to_flax_layout,
                                            variables_from_module)
from analytics_zoo_tpu_torch.keras import Sequential
from analytics_zoo_tpu_torch.keras import layers as PL
from analytics_zoo_tpu_torch.keras.layers.transformer import reset_parameters
from analytics_zoo_tpu_torch.learn.optim import param_tree
from analytics_zoo_tpu_torch.utils.tree import tree_map

torch.set_num_threads(2)

TOL = 1e-5
PROD_TOL = 1e-4


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    excess = np.abs(got - want) - tol * (1 + np.abs(want))
    assert excess.max(initial=-1) <= 0, (what, float(excess.max()))


def _tree(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def _perturbed(variables, seed=0):
    """The flax tree with every parameter moved by a seeded draw."""
    rng = np.random.RandomState(seed)
    return nest({k: (np.asarray(a) + 0.3 * rng.randn(*np.shape(a))).astype(
        np.float32) for k, a in sorted(flatten(_tree(variables)).items())})


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _ids(*shape, vocab=10, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


def _port_module(make, x, variables):
    mod = make(PL).build()
    with torch.no_grad():
        mod(torch.from_numpy(x))
    if variables:
        load_flax_into(mod, variables)
    return mod


def _layer_pair(make, x):
    """(the JAX output, the port's output) of one layer in eval mode at
    the same (perturbed) weights."""
    ref_mod = make(RL).build()
    variables = ref_mod.init(jax.random.PRNGKey(0), x)
    variables = _perturbed(variables) if variables else variables
    want = np.asarray(ref_mod.apply(variables, x))
    mod = _port_module(make, x, variables)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    return want, got


X2 = _rand(4, 6, seed=1)
X3 = _rand(3, 7, 4, seed=2)
X4 = _rand(2, 5, 6, 3, seed=3)
POS3 = np.abs(X3) + 0.1
IDS = _ids(3, 7, seed=4)
BAGS = np.array([[1, 4, 0, 0], [0, 0, 0, 0], [3, 3, 9, 10]], np.int32)
CONV_SEQ = _rand(2, 4, 5, 6, 2, seed=5)
CONV_SEQ3 = _rand(2, 3, 3, 4, 5, 2, seed=6)

# (case, make(layers), input, tolerance)
LAYER_CASES = [
    ("embedding", lambda L: L.Embedding(10, 5), IDS, 0.0),
    ("embedding_weights", lambda L: L.Embedding(
        10, 3, weights=_rand(10, 3, seed=7)), IDS, 0.0),
    ("word_embedding", lambda L: L.WordEmbedding(
        10, 3, weights=_rand(10, 3, seed=8)), IDS, 0.0),
    ("sparse_embedding_sum", lambda L: L.SparseEmbedding(10, 4), BAGS,
     TOL),
    ("sparse_embedding_mean", lambda L: L.SparseEmbedding(
        10, 4, combiner="mean"), BAGS, TOL),
    ("sparse_embedding_sqrtn", lambda L: L.SparseEmbedding(
        10, 4, combiner="sqrtn"), BAGS, TOL),
    ("sparse_dense", lambda L: L.SparseDense(5, activation="relu"), X3,
     PROD_TOL),
    ("simple_rnn", lambda L: L.SimpleRNN(5), X3, PROD_TOL),
    ("simple_rnn_seq_back", lambda L: L.SimpleRNN(
        5, return_sequences=True, go_backwards=True), X3, PROD_TOL),
    ("lstm", lambda L: L.LSTM(6), X3, PROD_TOL),
    ("lstm_seq", lambda L: L.LSTM(6, return_sequences=True), X3,
     PROD_TOL),
    ("lstm_back", lambda L: L.LSTM(6, go_backwards=True), X3, PROD_TOL),
    ("lstm_seq_back", lambda L: L.LSTM(
        6, return_sequences=True, go_backwards=True), X3, PROD_TOL),
    ("gru", lambda L: L.GRU(5), X3, PROD_TOL),
    ("gru_seq_back", lambda L: L.GRU(
        5, return_sequences=True, go_backwards=True), X3, PROD_TOL),
    ("gru_back", lambda L: L.GRU(5, go_backwards=True), X3, PROD_TOL),
    ("bidirectional_lstm", lambda L: L.Bidirectional(L.LSTM(5)), X3,
     PROD_TOL),
    ("bidirectional_lstm_seq", lambda L: L.Bidirectional(
        L.LSTM(5, return_sequences=True)), X3, PROD_TOL),
    ("bidirectional_gru_sum", lambda L: L.Bidirectional(
        L.GRU(4), merge_mode="sum"), X3, PROD_TOL),
    ("bidirectional_rnn_mul_seq", lambda L: L.Bidirectional(
        L.SimpleRNN(4, return_sequences=True), merge_mode="mul"), X3,
     PROD_TOL),
    ("bidirectional_lstm_ave", lambda L: L.Bidirectional(
        L.LSTM(3), merge_mode="ave"), X3, PROD_TOL),
    ("conv_lstm2d", lambda L: L.ConvLSTM2D(3, 3), CONV_SEQ, PROD_TOL),
    ("conv_lstm2d_seq", lambda L: L.ConvLSTM2D(
        2, 2, return_sequences=True), CONV_SEQ, PROD_TOL),
    ("conv_lstm3d", lambda L: L.ConvLSTM3D(2, 3), CONV_SEQ3, PROD_TOL),
    ("time_distributed_dense", lambda L: L.TimeDistributed(
        L.Dense(5, activation="tanh")), X3, PROD_TOL),
    ("time_distributed_conv", lambda L: L.TimeDistributed(
        L.Convolution2D(3, 2, 2)), CONV_SEQ, PROD_TOL),
    ("add_constant", lambda L: L.AddConstant(1.5), X3, TOL),
    ("mul_constant", lambda L: L.MulConstant(-2.0), X3, TOL),
    ("cadd", lambda L: L.CAdd((7, 4)), X3, TOL),
    ("cadd_broadcast", lambda L: L.CAdd((1, 4)), X3, TOL),
    ("cmul", lambda L: L.CMul((1, 4)), X3, TOL),
    ("mul", lambda L: L.Mul(), X3, TOL),
    ("scale", lambda L: L.Scale((4,)), X3, TOL),
    ("exp", lambda L: L.Exp(), X3, TOL),
    ("log", lambda L: L.Log(), POS3, TOL),
    ("sqrt", lambda L: L.Sqrt(), POS3, TOL),
    ("square", lambda L: L.Square(), X3, TOL),
    ("power", lambda L: L.Power(2.5, scale=0.5, shift=1.0), POS3, TOL),
    ("negative", lambda L: L.Negative(), X3, 0.0),
    ("identity", lambda L: L.Identity(), X3, 0.0),
    ("expand", lambda L: L.Expand((3, 7, 4)), X3[:, :1], 0.0),
    ("expand_dim", lambda L: L.ExpandDim(1), X3, 0.0),
    ("expand_dim_end", lambda L: L.ExpandDim(-1), X3, 0.0),
    ("squeeze", lambda L: L.Squeeze(), X3[:, :1], 0.0),
    ("squeeze_dim", lambda L: L.Squeeze(0), X3[:, :1], 0.0),
    ("select", lambda L: L.Select(1, 2), X3, 0.0),
    ("select_negative", lambda L: L.Select(-1, 0), X3, 0.0),
    ("narrow", lambda L: L.Narrow(0, 2, 3), X3, 0.0),
    ("max", lambda L: L.Max(0), X3, 0.0),
    ("max_keepdims", lambda L: L.Max(-1, keepdims=True), X3, 0.0),
    ("get_shape", lambda L: L.GetShape(), X3, 0.0),
    ("threshold", lambda L: L.Threshold(0.2, -1.0), X3, 0.0),
    ("binary_threshold", lambda L: L.BinaryThreshold(0.1), X3, 0.0),
    ("hard_shrink", lambda L: L.HardShrink(0.4), X3, 0.0),
    ("soft_shrink", lambda L: L.SoftShrink(0.3), X3, TOL),
    ("hard_tanh", lambda L: L.HardTanh(-0.5, 0.7), X3, 0.0),
    ("rrelu_eval", lambda L: L.RReLU(), X3, TOL),
    ("softmax", lambda L: L.Softmax(), X3, TOL),
    ("layer_norm", lambda L: L.LayerNorm(eps=1e-3), X3, TOL),
    ("within_channel_lrn2d", lambda L: L.WithinChannelLRN2D(
        size=3, alpha=0.5), X4, TOL),
    ("within_channel_lrn2d_even", lambda L: L.WithinChannelLRN2D(
        size=4), X4, TOL),
    ("share_convolution2d", lambda L: L.ShareConvolution2D(
        3, 2, 2, border_mode="same"), X4, PROD_TOL),
]


@pytest.mark.parametrize("make,x,tol", [c[1:] for c in LAYER_CASES],
                         ids=[c[0] for c in LAYER_CASES])
def test_layer_matches_reference(make, x, tol):
    want, got = _layer_pair(make, x)
    assert got.dtype == want.dtype or tol > 0, (got.dtype, want.dtype)
    _close(got, want, tol)


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_run_fused_carries_match_flax(kind):
    """``run_fused`` from a non-zero initial carry, returning the final
    one, against flax's ``nn.RNN(cell, return_carry=True)`` at the same
    (perturbed) weights: flax's carry form both ways (the LSTM's
    ``(c, h)``, the GRU's ``h``)."""
    import flax.linen as fnn

    from analytics_zoo_tpu_torch.keras.layers.recurrent import (
        GRUCell, LSTMCell, run_fused)

    units = 6
    flax_cell, port_cell = {
        "lstm": (fnn.OptimizedLSTMCell, LSTMCell),
        "gru": (fnn.GRUCell, GRUCell)}[kind]
    rnn = fnn.RNN(flax_cell(units), return_carry=True)
    carry = (_rand(3, units, seed=11), _rand(3, units, seed=12))
    if kind == "gru":
        carry = carry[1]
    variables = _perturbed(rnn.init(jax.random.PRNGKey(0), X3,
                                    initial_carry=carry))
    want_carry, want = rnn.apply(variables, X3, initial_carry=carry)
    cell = port_cell(X3.shape[-1], units)
    load_flax_into(cell, variables["params"]["cell"])
    with torch.no_grad():
        got_carry, got = run_fused([cell], torch.from_numpy(X3),
                                   initial_carry=tree_map(torch.from_numpy,
                                                          carry),
                                   return_carry=True)
        _close(got.numpy(), want, PROD_TOL, "outputs")
        want_carry, got_carry = (jax.tree_util.tree_leaves(want_carry),
                                 jax.tree_util.tree_leaves(got_carry))
        assert len(got_carry) == len(want_carry) == (2 if kind == "lstm"
                                                     else 1)
        for g, w in zip(got_carry, want_carry):
            _close(g.numpy(), w, PROD_TOL, "carry")
        # the default carry is zeros, and the outputs alone come back
        zero = run_fused([cell], torch.from_numpy(X3))
        zeros = jax.tree_util.tree_map(np.zeros_like, carry)
        _close(zero.numpy(), rnn.apply(variables, X3,
                                       initial_carry=zeros)[1], PROD_TOL,
               "zero carry")


PARAM_CASES = {
    "embedding": (lambda L: L.Embedding(10, 5), IDS),
    "sparse_embedding": (lambda L: L.SparseEmbedding(10, 4), BAGS),
    "sparse_dense": (lambda L: L.SparseDense(5), X3),
    "simple_rnn": (lambda L: L.SimpleRNN(5), X3),
    "lstm": (lambda L: L.LSTM(6), X3),
    "gru": (lambda L: L.GRU(5), X3),
    "bidirectional_lstm": (lambda L: L.Bidirectional(L.LSTM(5)), X3),
    "conv_lstm2d": (lambda L: L.ConvLSTM2D(3, 3), CONV_SEQ),
    "conv_lstm3d": (lambda L: L.ConvLSTM3D(2, 3), CONV_SEQ3),
    "time_distributed": (lambda L: L.TimeDistributed(L.Dense(5)), X3),
    "cadd": (lambda L: L.CAdd((7, 4)), X3),
    "cmul": (lambda L: L.CMul((1, 4)), X3),
    "mul": (lambda L: L.Mul(), X3),
    "scale": (lambda L: L.Scale((4,)), X3),
    "layer_norm": (lambda L: L.LayerNorm(), X3),
}


@pytest.mark.parametrize("case", sorted(PARAM_CASES))
def test_parameter_trees_match_flax(case):
    """flax's exact tree (names and shapes); biases and the torch-style
    layers' parameters at flax's initial values."""
    make, x = PARAM_CASES[case]
    want = flatten(_tree(make(RL).build().init(jax.random.PRNGKey(0), x)))
    mod = make(PL).build()
    with torch.no_grad():
        mod(torch.from_numpy(x))
    reset_parameters(mod, 0)
    got = flatten(variables_from_module(mod))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        if not k.endswith(("kernel", "embedding")):
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def _draw(make, x, seed=0):
    """The JAX package's and the port's initial trees of one layer."""
    want = flatten(_tree(make(RL).build().init(jax.random.PRNGKey(seed),
                                               x)))
    mod = make(PL).build()
    with torch.no_grad():
        mod(torch.from_numpy(x))
    reset_parameters(mod, seed)
    return want, flatten(variables_from_module(mod))


def test_initializer_spreads_match_flax():
    """The draws by their statistics: Embedding's U[0, 0.05) table,
    SparseEmbedding's normal of std 1/sqrt(dim), an LSTM's input kernels
    at lecun_normal's spread and its recurrent kernels orthogonal
    (W^T W = I), ConvLSTM's kernels at lecun_normal's."""
    want, got = _draw(lambda L: L.Embedding(4000, 64), IDS)
    for tree in (want, got):
        t = tree["params/embedding"]
        assert 0.0 <= t.min() and t.max() < 0.05
        assert abs(t.mean() / 0.025 - 1) < 0.01
        assert abs(t.std() / (0.05 / 12 ** 0.5) - 1) < 0.01
    want, got = _draw(lambda L: L.SparseEmbedding(4000, 64), BAGS)
    for tree in (want, got):
        t = tree["params/embedding/embedding"]
        assert abs(t.std() * 8 - 1) < 0.02, t.std()
    x = _rand(2, 3, 256, seed=9)
    want, got = _draw(lambda L: L.LSTM(128), x)
    for tree in (want, got):
        for g in "ifgo":
            k = tree[f"params/OptimizedLSTMCell_0/i{g}/kernel"]
            assert abs(k.std() * 16 - 1) < 0.03, (g, k.std() * 16)
            h = tree[f"params/OptimizedLSTMCell_0/h{g}/kernel"]
            np.testing.assert_allclose(h.T @ h, np.eye(128), atol=1e-5)
    want, got = _draw(lambda L: L.ConvLSTM2D(32, 3),
                      _rand(1, 2, 5, 5, 32, seed=10))
    for tree in (want, got):
        for name, fan_in in (("ih", 288), ("hh", 288)):
            k = tree[f"params/ConvLSTMCell_0/{name}/kernel"]
            assert abs(k.std() * fan_in ** 0.5 - 1) < 0.03, name


# ------------------------------------------------------------ bridge --


@pytest.mark.parametrize("case", ["conv_lstm2d", "conv_lstm3d"])
def test_bridge_conv_lstm_layout(case):
    """ConvLSTM's ``ih``/``hh`` kernels (4-D and 5-D) go flax -> port
    -> flax unchanged, keyed on the module."""
    make, x = PARAM_CASES[case]
    ref_mod = make(RL).build()
    tree = _perturbed(ref_mod.init(jax.random.PRNGKey(0), x), seed=11)
    mod = _port_module(make, x, tree)
    assert set(kernel_layouts(mod).values()) == {"conv"}
    back = flatten(variables_from_module(mod))
    for k, w in flatten(tree).items():
        np.testing.assert_array_equal(back[k], w, err_msg=k)


def _conv_lstm_seq(L, S):
    return S([L.ConvLSTM2D(2, 3), L.Flatten(), L.Dense(3)])


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_conv_lstm_weights_cross_between_packages(tmp_path, saver):
    x = np.concatenate([CONV_SEQ] * 4)
    y = _rand(8, 3, seed=12)
    ref = _conv_lstm_seq(RL, RefSequential)
    port = _conv_lstm_seq(PL, lambda ls: Sequential(ls, device="cpu"))
    for m in (ref, port):
        m.compile(optimizer="adam", loss="mse")
    src, dst = (ref, port) if saver == "jax" else (port, ref)
    src.fit(x, y, batch_size=8, nb_epoch=1)
    path = str(tmp_path / "w")
    src.save_weights(path)
    dst.load_weights(path)
    _close(dst.predict(x, batch_size=8), src.predict(x, batch_size=8),
           PROD_TOL)


# ------------------------------------------------------------ models --


def _text_bilstm(L, S, vocab=50, embed=8, units=6, classes=4):
    """The chip's BiLSTM text classifier at small widths."""
    return S([L.Embedding(vocab, embed), L.Bidirectional(L.LSTM(units)),
              L.Dropout(0.2), L.Dense(7, activation="relu"),
              L.Dense(classes)])


def _grads(build, ids, y, seed):
    ref_mod = build(RL, RefSequential)._build_module()
    tree = _perturbed(ref_mod.init(jax.random.PRNGKey(0), ids), seed=seed)

    def ref_loss(params):
        logits = ref_mod.apply({"params": params}, ids)
        return -jnp.mean(jnp.take_along_axis(
            jax.nn.log_softmax(logits), y[:, None], axis=1))

    want = flatten(_tree(jax.grad(ref_loss)(tree["params"])))
    port = build(PL, lambda ls: Sequential(ls, device="cpu"))
    port.materialize(ids)
    load_flax_into(port.module, tree)
    loss = torch.nn.functional.cross_entropy(
        port.module(torch.from_numpy(ids)), torch.from_numpy(y).long())
    loss.backward()
    layouts = kernel_layouts(port.module)
    got = {k: to_flax_layout(k, p.grad.numpy(), layouts)
           for k, p in param_tree(port.module).items()
           if p.grad is not None}
    return want, got


def test_text_bilstm_gradient_matches_reference():
    """One step's gradient of the BiLSTM text classifier (dropout off)
    at the same weights, within 1e-4: every flax cell parameter gets
    its gradient through the fused recurrence's flat weights."""
    ids = _ids(8, 12, vocab=50, seed=13)
    y = np.random.RandomState(14).randint(0, 4, 8).astype(np.int32)
    want, got = _grads(_text_bilstm, ids, y, seed=15)
    assert sorted(got) == sorted(want)
    assert any("bwd/OptimizedLSTMCell_0/hf" in k for k in got)
    for k, w in want.items():
        _close(got[k], w, PROD_TOL, k)


def test_gru_and_frozen_embedding_gradients():
    """A GRU under a frozen ``WordEmbedding``: the table gets no
    gradient (the Estimator steps it with zeros, as ``stop_gradient``
    leaves it), the GRU's ``hn`` bias and the rest match."""
    table = _rand(50, 8, seed=16)

    def build(L, S):
        return S([L.WordEmbedding(50, 8, weights=table),
                  L.GRU(5, go_backwards=True), L.Dense(4)])

    ids = _ids(8, 9, vocab=50, seed=17)
    y = np.random.RandomState(18).randint(0, 4, 8).astype(np.int32)
    want, got = _grads(build, ids, y, seed=19)
    np.testing.assert_array_equal(want["modules_0/embedding"], 0.0)
    assert sorted(got) == sorted(set(want) - {"modules_0/embedding"})
    assert "modules_1/GRUCell_0/hn/bias" in got
    for k, g in got.items():
        _close(g, want[k], PROD_TOL, k)


def test_from_glove(tmp_path):
    """``WordEmbedding.from_glove`` over a tiny GloVe file: the rows of
    the words in ``word_index``, zeros elsewhere, in both packages."""
    path = tmp_path / "glove.txt"
    path.write_text("the 0.1 0.2 0.3\ncat -1.0 0.5 2.0\ndog 3 4 5\n"
                    "unused 9 9 9\n", encoding="utf-8")
    index = {"the": 1, "cat": 2, "bird": 3, "dog": 5}
    ids = np.array([[1, 2, 3, 5, 0]], np.int32)
    layers = {L: L.WordEmbedding.from_glove(str(path), index)
              for L in (RL, PL)}
    for layer in layers.values():
        assert (layer.input_dim, layer.output_dim) == (6, 3)
        assert not layer.trainable
    ref_mod = layers[RL].build()
    want = np.asarray(ref_mod.apply(ref_mod.init(jax.random.PRNGKey(0),
                                                 ids), ids))
    mod = layers[PL].build()
    reset_parameters(mod, 0)
    with torch.no_grad():
        got = mod(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 2], 0.0)
    np.testing.assert_allclose(got[0, 1], [-1.0, 0.5, 2.0])
    for L in (RL, PL):
        with pytest.raises(ValueError, match="no words"):
            L.WordEmbedding.from_glove(str(path), {"zebra": 1})


def test_rrelu_training_statistics():
    """Training slopes ~ U[lower, upper) drawn from the layer's
    generator: on x = -1 the outputs' mean and spread are the uniform's,
    in both packages; positive inputs pass."""
    x = -np.ones((2000, 100), np.float32)
    lo, hi = 0.1, 0.4
    ref_mod = RL.RReLU(lo, hi).build()
    want = -np.asarray(ref_mod.apply({}, x, train=True, rngs={
        "dropout": jax.random.PRNGKey(0)}), np.float64)
    mod = PL.RReLU(lo, hi).build()
    got = -mod(torch.from_numpy(x), train=True,
               rng=torch.Generator().manual_seed(0)).numpy().astype(
                   np.float64)
    for s in (want, got):
        assert lo <= s.min() and s.max() < hi
        assert abs(s.mean() / ((lo + hi) / 2) - 1) < 0.01
        assert abs(s.std() / ((hi - lo) / 12 ** 0.5) - 1) < 0.01
    pos = np.abs(X3)
    np.testing.assert_array_equal(
        mod(torch.from_numpy(pos), train=True,
            rng=torch.Generator().manual_seed(1)).numpy(), pos)
    with pytest.raises(ValueError, match="generator"):
        mod(torch.from_numpy(x), train=True)


@pytest.mark.parametrize("make,x", [
    (lambda L: L.Squeeze(1), X3),
    (lambda L: L.Select(3, 0), X3),
    (lambda L: L.ExpandDim(4), X3),
    (lambda L: L.Bidirectional(L.LSTM(3), merge_mode="nope"), X3),
    (lambda L: L.SparseEmbedding(10, 3, combiner="max"), BAGS),
], ids=["squeeze_size", "select_range", "expand_range", "merge_mode",
        "combiner"])
def test_layer_errors_match_reference(make, x):
    with pytest.raises(ValueError):
        make(RL).build().init(jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError):
        make(PL).build()(torch.from_numpy(x))


def test_share_convolution2d_is_a_convolution2d():
    for L in (RL, PL):
        assert type(L.ShareConvolution2D(3, 2, 2)) is L.Convolution2D
