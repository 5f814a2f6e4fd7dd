"""PyTorch port, generation plane: K5b's plain version and the attention
dispatch at head dims that are not a multiple of 64, TinyGenLM, the paged
KV cache, the decode engine, the generation worker and ``launch()`` with a
``generation:`` block, held against the JAX package on the CPU.

The reference for attention is the JAX package's einsum path
(``dot_product_attention`` takes it on the CPU). JAX's stock Pallas
``flash_attention``, which the reference calls on the TPU at such head
dims (K5b), does not run on the CPU, so no test here runs it; the port's
K5b kernel is held against its plain version on the card by
``chip_smoke.py``. Inputs are made with numpy and fed to both packages,
in f32 (TinyGenLM is f32 throughout).
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops.attention import (
    dot_product_attention as jax_dot_product_attention)
from analytics_zoo_tpu.serving.generation.engine import (
    DecodeEngine as JaxDecodeEngine)
from analytics_zoo_tpu.serving.generation.model import (
    GenModelConfig as JaxGenModelConfig)
from analytics_zoo_tpu.serving.generation.model import TinyGenLM as JaxLM
from analytics_zoo_tpu_torch.bridge import gen_params_from_tree
from analytics_zoo_tpu_torch.common.config import get_config
from analytics_zoo_tpu_torch.inference.kv_cache import (CacheOverflow,
                                                        PagedKVCache)
from analytics_zoo_tpu_torch.ops import attention as port_attention
from analytics_zoo_tpu_torch.ops import flash_attention as fa
from analytics_zoo_tpu_torch.serving import chaos
from analytics_zoo_tpu_torch.serving.generation import (
    ContinuousBatcher, DecodeEngine, GenerationWorker, GenModelConfig,
    TinyGenLM, prefill_ladder)
from analytics_zoo_tpu_torch.serving.launcher import launch
from analytics_zoo_tpu_torch.serving.protocol import (
    DEADLINE_PREFIX, ERROR_KEY, ERROR_PREFIXES, GENERATION_PREFIX,
    INVALID_PREFIX, STREAM_KEY, error_status)
from analytics_zoo_tpu_torch.serving.queues import InputQueue, OutputQueue

torch.set_num_threads(2)

# f32 on both sides: exact arithmetic in another order
ATOL = 1e-5
TINY_KW = dict(vocab=32, dim=16, heads=2, head_dim=8, layers=2,
               max_len=64, seed=0)
TINY = GenModelConfig(**TINY_KW)


def _np_tree(tree):
    """A port parameter tree as numpy (the bridge's input form)."""
    return jax.tree_util.tree_map(lambda t: t.numpy(), tree)


@pytest.fixture(autouse=True)
def _drop_port_flight_recorder():
    # launch() installs the port's process-wide crash hooks; take them
    # out again so later tests in this process see the hooks they set
    yield
    from analytics_zoo_tpu_torch.obs.flight import (
        uninstall_flight_recorder)

    uninstall_flight_recorder()


@pytest.fixture(scope="module")
def tiny_lm():
    return TinyGenLM(TINY)


@pytest.fixture(scope="module")
def jax_lm():
    return JaxLM(JaxGenModelConfig(**TINY_KW))


@pytest.fixture(scope="module")
def jax_params(jax_lm):
    return jax_lm.init_params()


@pytest.fixture(scope="module")
def bridged(jax_params):
    """The JAX package's TinyGenLM parameters carried into the port."""
    return gen_params_from_tree(
        jax.tree_util.tree_map(np.asarray, jax_params), device="cpu")


@pytest.fixture(scope="module")
def engine(tiny_lm, bridged):
    """One warmed engine over the bridged weights, shared by the
    pure-engine tests (they release every slot they take)."""
    return DecodeEngine(tiny_lm, params=bridged, num_slots=4, page_size=4,
                        max_len=64, device="cpu").warm_up()


@pytest.fixture(scope="module")
def jax_engine(jax_lm, jax_params):
    """The JAX package's warmed engine over the same weights (its own
    tests hold it token-exact against its reference_generate, which
    compiles once per prefix length and so is kept to one test here)."""
    return JaxDecodeEngine(jax_lm, params=jax_params, num_slots=4,
                           page_size=4, max_len=64).warm_up()


def _jax_tokens(jax_engine, prompt, n):
    """``n`` greedy tokens of the JAX package's engine, decoding alone."""
    slot, tok0 = jax_engine.admit(prompt, n)
    toks = [tok0]
    while len(toks) < n:
        toks.append(dict(jax_engine.step())[slot])
    jax_engine.release(slot)
    return toks


def _drain_stream(out_q, uris, timeout=30.0):
    """Collect chunk streams for ``uris`` from an OutputQueue:
    {uri: {"toks": [...], "seqs": [...], "reason"|"error": ...}}."""
    got = {u: {"toks": [], "seqs": []} for u in uris}
    done = set()
    deadline = time.time() + timeout
    while len(done) < len(uris) and time.time() < deadline:
        item = out_q.dequeue(timeout=0.2)
        if item is None:
            continue
        uri, tensors = item
        if uri not in got:
            continue
        assert STREAM_KEY in tensors
        seq = int(np.asarray(tensors[STREAM_KEY]).reshape(()))
        rec = got[uri]
        if ERROR_KEY in tensors:
            rec["error"] = str(np.asarray(tensors[ERROR_KEY]).reshape(()))
            assert seq == -1  # error terminals are never dedupable
            done.add(uri)
            continue
        rec["seqs"].append(seq)
        if "token" in tensors:
            rec["toks"].extend(
                int(t) for t in np.asarray(tensors["token"]).reshape(-1))
        if "finish_reason" in tensors:
            rec["reason"] = str(np.asarray(
                tensors["finish_reason"]).reshape(()))
            rec["n_tokens"] = int(np.asarray(
                tensors["n_tokens"]).reshape(()))
            done.add(uri)
    assert len(done) == len(uris), f"incomplete streams: {got}"
    return got


# ------------------------------------------------------------ attention --
def _attn_case(kind, d, seed):
    """q, k, v [B, H, L, D] f32, causal, and a [B, Lk] int32 key-padding
    mask (or None) for one K5b case."""
    rng = np.random.RandomState(seed)
    b, h, lq = 2, 2, 128
    lk = 256 if kind == "cross" else 128
    q = rng.randn(b, h, lq, d).astype(np.float32)
    k = rng.randn(b, h, lk, d).astype(np.float32)
    v = rng.randn(b, h, lk, d).astype(np.float32)
    mask = None
    if kind == "kv_mask":
        mask = (np.arange(lk)[None, :] < np.array([[lk], [0]])).astype(
            np.int32)
        mask[0, lk - 40:] = 0  # row 0: 88 real keys; row 1: none
    return q, k, v, kind == "causal", mask


class TestK5bAttention:
    """K5b's plain version (``flash_attention_reference``) and the port's
    dispatch at head dims that are not a multiple of 64, against the JAX
    package's ``dot_product_attention`` (its einsum path on the CPU):
    causal at lq == lk, non-causal cross-length, and a key-padding mask
    with a row that has no real key (the mean of V)."""

    @pytest.mark.parametrize("fn", ["plain", "dispatch"])
    @pytest.mark.parametrize("kind", ["causal", "cross", "kv_mask"])
    @pytest.mark.parametrize("d", [16, 32, 40, 80, 96])
    def test_matches_jax(self, d, kind, fn):
        q, k, v, causal, mask = _attn_case(kind, d, seed=d)
        want = np.asarray(jax_dot_product_attention(
            q, k, v, key_padding_mask=mask, causal=causal))
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        tm = None if mask is None else torch.from_numpy(mask)
        if fn == "plain":
            got = fa.flash_attention_reference(tq, tk, tv, causal,
                                               key_padding_mask=tm)
        else:
            get_config().set("zoo.ops.attention_impl", "flash")
            try:
                got = port_attention.dot_product_attention(
                    tq, tk, tv, key_padding_mask=tm, causal=causal)
            finally:
                get_config().unset("zoo.ops.attention_impl")
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)

    @pytest.mark.parametrize("d", [16, 80])
    def test_k5b_route_gates(self, d):
        """The reference's gates at such head dims: d <= 128, causal
        only at lq == lk, L and Lk multiples of 128."""
        base = dict(impl="flash", on_cuda=True, l=256, lk=256, d=d,
                    causal=True, has_mask=False, dropout_rate=0.0)
        route = port_attention._flash_route
        assert route(**base) == "k5b"
        assert route(**dict(base, lk=384)) is None
        assert route(**dict(base, lk=384, causal=False)) == "k5b"
        assert route(**dict(base, l=192, lk=192)) is None
        assert route(**dict(base, d=d + 128)) is None

    @pytest.mark.parametrize("d", [20, 100])
    def test_head_dim_not_a_multiple_of_8_raises(self, d):
        with pytest.raises(NotImplementedError, match="multiples of 8"):
            fa._check_head_dim(d)


# ---------------------------------------------------------------- model --
class TestTinyGenLM:
    @pytest.mark.parametrize("kw", [TINY_KW, {}], ids=["tiny", "default"])
    def test_same_seed_same_parameters(self, kw):
        """init_params draws in the reference's order: bit-identical."""
        want = JaxLM(JaxGenModelConfig(**kw)).init_params(pos_len=80)
        got = TinyGenLM(GenModelConfig(**kw)).init_params(pos_len=80,
                                                          device="cpu")
        want, got = (jax.tree_util.tree_flatten_with_path(t)[0]
                     for t in (want, _np_tree(got)))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))

    def test_default_device_is_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is visible")
        with pytest.raises(RuntimeError, match="CUDA"):
            TinyGenLM(TINY).init_params()

    @pytest.mark.parametrize("length", [5, 16])
    def test_prefill_matches(self, tiny_lm, jax_lm, jax_params, bridged,
                             length):
        toks = np.random.RandomState(length).randint(
            0, TINY.vocab, (2, length)).astype(np.int32)
        want = jax_lm.prefill(jax_params, toks)
        got = tiny_lm.prefill(bridged, torch.from_numpy(toks))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)

    def test_decode_step_matches(self, tiny_lm, jax_lm, jax_params, bridged):
        """One decode position per slot against a dense [S, T] context,
        through the same write/gather callbacks in both packages."""
        rng = np.random.RandomState(3)
        s, t, c = 3, 12, TINY
        ctx_k = rng.randn(c.layers, s, t, c.heads, c.head_dim).astype(
            np.float32)
        ctx_v = rng.randn(*ctx_k.shape).astype(np.float32)
        toks = rng.randint(0, c.vocab, s).astype(np.int32)
        pos = np.array([0, 5, 11], np.int32)

        def run(lib, asarray):
            kv = [asarray(ctx_k.copy()), asarray(ctx_v.copy())]
            mask = asarray(np.arange(t)[None, :] <= pos[:, None])

            def write_kv(layer, k, v):
                for plane, x in ((0, k), (1, v)):
                    a = np.array(kv[plane])
                    a[layer, np.arange(s), pos] = np.asarray(x)
                    kv[plane] = asarray(a)

            def gather_kv(layer):
                return kv[0][layer], kv[1][layer], mask

            return lib(toks, pos, gather_kv, write_kv)

        want = run(lambda *a: jax_lm.decode_step(jax_params, *a), np.asarray)
        got = run(lambda tk, ps, g, w: tiny_lm.decode_step(
            bridged, torch.from_numpy(tk), torch.from_numpy(ps), g, w),
            torch.from_numpy)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    def test_reference_generate_token_exact(self, tiny_lm, jax_lm,
                                            jax_params, bridged):
        prompt = np.array([3, 7, 1, 9, 2], np.int32)
        want = jax_lm.reference_generate(jax_params, prompt, 6)
        got = tiny_lm.reference_generate(bridged, prompt, 6)
        assert got.dtype == np.int32 and list(got) == list(want)


# -------------------------------------------------------- paged KV cache --
class TestPagedKVCache:
    def _cache(self, **kw):
        kw.setdefault("num_layers", 1)
        kw.setdefault("num_heads", 1)
        kw.setdefault("head_dim", 4)
        kw.setdefault("page_size", 4)
        kw.setdefault("num_slots", 2)
        kw.setdefault("max_len", 16)
        return PagedKVCache(device="cpu", **kw)

    def test_pool_shape_and_trash_page(self):
        c = self._cache(num_layers=2, num_heads=3, num_pages=5)
        assert tuple(c.kv.shape) == (2, 2, 6, 4, 3, 4)
        assert c.kv.dtype == torch.float32
        assert c.stats()["bytes"] == 2 * 2 * 6 * 4 * 3 * 4 * 4
        assert (c.block_tables() == 0).all()

    def test_pages_for(self):
        c = self._cache()
        assert [c.pages_for(n) for n in (1, 4, 5, 16)] == [1, 1, 2, 4]

    def test_admit_reserves_worst_case(self):
        c = self._cache(num_pages=4)  # 2 slots x 16 tokens won't fit
        s = c.admit(3, 9)  # 12 tokens -> 3 pages reserved
        assert c.can_admit(4) is True     # 1 page left
        assert c.can_admit(5) is False    # would need 2
        with pytest.raises(CacheOverflow):
            c.admit(5, 3)
        c.release(s)
        assert c.can_admit(16)

    def test_lazy_assignment_and_growth(self):
        c = self._cache(num_pages=8)
        s = c.admit(3, 9)
        assert c.utilization() == 0.0  # reserved, nothing assigned
        c.ensure_length(s, 3)
        assert list(c.block_tables()[s] > 0) == [True] + [False] * 3
        c.ensure_length(s, 5)  # crosses a page boundary
        assert (c.block_tables()[s] > 0).sum() == 2
        assert c.lengths()[s] == 5
        with pytest.raises(ValueError):
            c.ensure_length(s, 13)  # past the 12-token reservation

    def test_release_recycles_pages(self):
        c = self._cache(num_pages=4)
        s = c.admit(4, 4)
        c.ensure_length(s, 8)
        used = set(int(p) for p in c.block_tables()[s] if p)
        assert len(used) == 2
        c.release(s)
        c.release(s)  # idempotent
        assert c.utilization() == 0.0
        s2 = c.admit(8, 8)
        c.ensure_length(s2, 16)
        assert used <= set(int(p) for p in c.block_tables()[s2] if p)

    @pytest.mark.parametrize("lens", [[(1, 1), (1, 1), (1, 1)],
                                      [(10, 10)]],
                             ids=["slot_exhaustion", "max_len"])
    def test_refusals(self, lens):
        c = self._cache()
        with pytest.raises(CacheOverflow):
            for prompt_len, new in lens:
                c.admit(prompt_len, new)

    def test_export_schema_matches_reference(self):
        """The same accounting and snapshot schema as the reference's
        cache: a page-aligned numpy ``kv`` with ``length`` and
        ``reserve``; an import writes the pages verbatim."""
        from analytics_zoo_tpu.inference.kv_cache import (
            PagedKVCache as JaxPagedKVCache)

        kw = dict(num_layers=2, num_heads=1, head_dim=4, page_size=4,
                  num_slots=2, max_len=16)
        ours, theirs = self._cache(**kw), JaxPagedKVCache(**kw)
        vals = np.random.RandomState(0).randn(
            *ours.kv.shape).astype(np.float32)
        ours.kv.copy_(torch.from_numpy(vals))
        theirs.kv = jax.numpy.asarray(vals)
        snaps = []
        for c in (ours, theirs):
            s = c.admit(5, 6)
            c.ensure_length(s, 6)
            snaps.append(c.export_pages(s))
        assert sorted(snaps[0]) == sorted(snaps[1])
        assert (snaps[0]["length"], snaps[0]["reserve"]) == (6, 3)
        assert snaps[0]["kv"].dtype == np.float32
        np.testing.assert_array_equal(snaps[0]["kv"],
                                      np.asarray(snaps[1]["kv"]))
        fresh = self._cache(**kw)
        slot = fresh.import_pages(snaps[1])
        pages = fresh.block_tables()[slot, :2]
        np.testing.assert_array_equal(
            fresh.kv[:, :, torch.from_numpy(pages).long()].numpy(),
            snaps[1]["kv"])


# ---------------------------------------------------------------- engine --
class TestDecodeEngine:
    def test_prefill_ladder_page_aligned(self):
        assert prefill_ladder(4, 64) == [4, 8, 16, 32, 64]
        assert prefill_ladder(16, 100) == [16, 32, 64, 128]

    def test_greedy_parity_vs_reference(self, engine, jax_engine):
        """The paged engine, the port's cache-free reference and the JAX
        package's engine give the same tokens."""
        rng = np.random.RandomState(42)
        for _ in range(3):
            prompt = rng.randint(0, TINY.vocab,
                                 rng.randint(2, 12)).astype(np.int32)
            ref = _jax_tokens(jax_engine, prompt, 12)
            assert [int(t) for t in engine.model.reference_generate(
                engine.params, prompt, 12)] == ref
            slot, tok0 = engine.admit(prompt, 12)
            toks = [tok0]
            while len(toks) < 12:
                toks.append(dict(engine.step())[slot])
            engine.release(slot)
            assert toks == ref

    def test_continuous_join_leave_token_exact(self, engine):
        """A request admitted mid-decode produces the same tokens as
        solo decode -- the continuous batcher's correctness contract."""
        pa = np.array([5, 6, 7], np.int32)
        pb = np.array([1, 2, 3, 4, 5, 6], np.int32)
        pc = np.array([30, 2, 19, 11], np.int32)
        want = {"a": 10, "b": 8, "c": 6}
        refs = {u: list(engine.model.reference_generate(engine.params, p,
                                                        want[u]))
                for u, p in {"a": pa, "b": pb, "c": pc}.items()}
        sa, t0a = engine.admit(pa, 10)
        out = {"a": [t0a], "b": [], "c": []}
        for _ in range(3):  # a runs alone for a few steps
            for s, t in engine.step():
                out["a"].append(t)
        sb, t0b = engine.admit(pb, 8)   # b joins mid-decode
        out["b"].append(t0b)
        for _ in range(2):
            for s, t in engine.step():
                {sa: out["a"], sb: out["b"]}[s].append(t)
        sc, t0c = engine.admit(pc, 6)   # c joins later still
        out["c"].append(t0c)
        slots = {sa: "a", sb: "b", sc: "c"}
        while any(len(out[u]) < want[u] for u in out):
            for s, t in engine.step():
                u = slots[s]
                if len(out[u]) < want[u]:
                    out[u].append(t)
                if len(out[u]) >= want[u] and s in engine._active:
                    engine.release(s)  # leave mid-flight of others
        for u in out:
            assert out[u] == refs[u], u

    def test_overflow_refusal_then_reuse(self, tiny_lm):
        eng = DecodeEngine(tiny_lm, num_slots=2, page_size=4, max_len=16,
                           num_pages=4, device="cpu").warm_up()
        s0, _ = eng.admit(np.array([1, 2, 3], np.int32), 9)  # 3 pages
        with pytest.raises(CacheOverflow):
            eng.admit(np.array([1, 2, 3, 4, 5], np.int32), 3)
        eng.release(s0)
        s1, _ = eng.admit(np.array([1, 2, 3, 4, 5], np.int32), 3)
        assert s1 in (0, 1)

    def test_admit_failure_releases_slot(self, tiny_lm):
        """A post-claim failure (prefill bug, poisoned request) gives the
        slot + reservation back."""
        eng = DecodeEngine(tiny_lm, num_slots=2, page_size=4, max_len=16,
                           device="cpu").warm_up()

        def boom(*a, **k):
            raise RuntimeError("injected prefill failure")

        eng._prefill_impl = boom
        for _ in range(4):  # more failures than slots
            with pytest.raises(RuntimeError):
                eng.admit(np.array([1, 2], np.int32), 4)
        del eng._prefill_impl
        assert eng.free_slots() == 2
        assert eng.cache.stats()["pages_reserved_unassigned"] == 0
        slot, _ = eng.admit(np.array([1, 2], np.int32), 4)
        eng.release(slot)

    @pytest.mark.parametrize("prompt,budget", [
        ([1, 2], 0), ([], 4), ([0, 32], 4)],
        ids=["nonpositive_budget", "empty", "out_of_vocab"])
    def test_admit_rejects(self, engine, prompt, budget):
        with pytest.raises(ValueError):
            engine.admit(np.array(prompt, np.int32), budget)
        assert engine.free_slots() == 4

    def test_warm_up_runs_everything(self, tiny_lm):
        """After warm_up, admissions and steps record no live first use
        of a bucket (the zero-storm contract) and no storm."""
        from analytics_zoo_tpu_torch.obs.events import get_event_log

        eng = DecodeEngine(tiny_lm, num_slots=2, page_size=4, max_len=16,
                           device="cpu").warm_up()
        assert eng.stats()["prefill_buckets_compiled"] == eng.ladder
        log = get_event_log()

        def live():
            return len([e for e in log.tail(2048, type="compile")
                        if e["fields"]["fn"].startswith("generation.")
                        and not e["fields"]["warm"]])

        before = live()
        slot, _ = eng.admit(np.array([4, 9, 2, 7, 1], np.int32), 8)
        for _ in range(7):
            eng.step()
        eng.release(slot)
        assert live() == before
        assert [e for e in log.tail(2048, type="recompile_storm")
                if e["subsystem"] == "generation"] == []

    def test_steps_write_the_pool_in_place(self, engine):
        pool = engine.cache.kv
        slot, _ = engine.admit(np.array([1, 2, 3], np.int32), 4)
        engine.step()
        engine.release(slot)
        assert engine.cache.kv is pool


# ------------------------------------------------------------ snapshots --
class TestSnapshots:
    """A slot exported by one package's engine, imported into the
    other's, keeps decoding token-exactly (the reference's handoff
    schema: page-aligned numpy ``kv``, ``length``, ``reserve``,
    ``next_token``, ``position``, ``rng``)."""

    @pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
    def test_handoff_token_exact(self, engine, jax_engine, direction):
        src, dst = ((jax_engine, engine) if direction == "jax_to_port"
                    else (engine, jax_engine))
        prompt = np.array([9, 8, 7, 3, 1, 4, 1], np.int32)
        ref = _jax_tokens(jax_engine, prompt, 12)
        slot, tok0 = src.admit(prompt, 12)
        toks = [tok0]
        for _ in range(4):
            toks.append(dict(src.step())[slot])
        snap = src.export_slot(slot)
        src.release(slot)
        assert sorted(snap) == ["kv", "length", "next_token", "position",
                                "reserve", "rng"]
        assert snap["rng"] is None and isinstance(snap["kv"], np.ndarray)
        new = dst.import_slot(snap)
        while len(toks) < 12:
            toks.append(dict(dst.step())[new])
        dst.release(new)
        assert toks == ref


# ---------------------------------------------------------------- worker --
class TestGenerationWorker:
    def _worker(self, tiny_lm, **eng_kw):
        eng_kw.setdefault("num_slots", 4)
        eng_kw.setdefault("page_size", 4)
        eng_kw.setdefault("max_len", 64)
        eng = DecodeEngine(tiny_lm, device="cpu", **eng_kw).warm_up()
        in_q = InputQueue(backend="memory")
        out_q = OutputQueue(backend="memory")
        return GenerationWorker(eng, in_q, out_q), in_q, out_q

    def test_e2e_exactly_once_token_exact(self, tiny_lm, jax_engine):
        w, in_q, out_q = self._worker(tiny_lm)
        rng = np.random.RandomState(7)
        prompts = {}
        for i in range(9):  # 9 overlapping streams over 4 slots
            p = rng.randint(0, TINY.vocab,
                            rng.randint(2, 10)).astype(np.int32)
            prompts[f"r{i}"] = p
            assert in_q.enqueue_generation(f"r{i}", p, max_tokens=10)
        w.start()
        try:
            got = _drain_stream(out_q, list(prompts))
        finally:
            w.stop()
        for uri, rec in got.items():
            # exactly-once: contiguous chunk seqs, no dupes/gaps
            assert rec["seqs"] == list(range(len(rec["seqs"])))
            # the same seed's weights: the JAX package's tokens
            assert rec["toks"] == _jax_tokens(jax_engine, prompts[uri],
                                              10), uri
            assert rec["reason"] == "length"
            assert rec["n_tokens"] == 10
        assert w.served == 9
        stats = w.engine.cache.stats()
        assert stats["slots_free"] == 4
        assert stats["pages_assigned"] == 0

    def test_admit_window_failure_releases_slot(self, tiny_lm,
                                                monkeypatch):
        """A raise between ``engine.admit`` and the stream-table store
        gives the slot and its page reservation back."""
        import analytics_zoo_tpu_torch.serving.generation.worker as gw

        w, in_q, out_q = self._worker(tiny_lm)
        in_q.enqueue_generation("leaky", np.array([1, 2, 3], np.int32),
                                max_tokens=8)
        blobs = w.batcher.poll(1, wait_timeout=1.0, idle=True)
        assert len(blobs) == 1

        def boom():
            raise RuntimeError("injected inflight-registry failure")

        monkeypatch.setattr(gw, "get_inflight", boom)
        with pytest.raises(RuntimeError, match="injected"):
            w._admit_blob(blobs[0])
        monkeypatch.undo()
        assert w._streams == {}
        stats = w.engine.cache.stats()
        assert stats["slots_free"] == 4
        assert stats["pages_assigned"] == 0
        assert stats["pages_reserved_unassigned"] == 0
        in_q.enqueue_generation("ok", np.array([1, 2, 3], np.int32),
                                max_tokens=4)
        w.start()
        try:
            got = _drain_stream(out_q, ["ok"])
        finally:
            w.stop()
        assert got["ok"]["n_tokens"] == 4

    def test_eos_stops_stream(self, tiny_lm):
        w, in_q, out_q = self._worker(tiny_lm)
        prompt = np.array([3, 7, 1, 9, 2], np.int32)
        ref = tiny_lm.reference_generate(w.engine.params, prompt, 20)
        eos = int(ref[3])  # stop on the 4th generated token
        assert eos not in ref[:3]
        in_q.enqueue_generation("e", prompt, max_tokens=20, eos=eos)
        w.start()
        try:
            got = _drain_stream(out_q, ["e"])
        finally:
            w.stop()
        assert got["e"]["reason"] == "stop"
        assert got["e"]["toks"] == [int(t) for t in ref[:4]]

    def test_overflow_refusal_structured_503(self, tiny_lm):
        # 2 slots but pages for only one worst-case stream at a time
        w, in_q, out_q = self._worker(tiny_lm, num_slots=2, max_len=32,
                                      num_pages=8)
        in_q.enqueue_generation("big", np.arange(2, 10, dtype=np.int32),
                                max_tokens=24)  # 32 tokens = 8 pages
        in_q.enqueue_generation("refused", np.arange(1, 9, dtype=np.int32),
                                max_tokens=24)
        w.start()
        try:
            got = _drain_stream(out_q, ["big", "refused"])
        finally:
            w.stop()
        assert got["big"]["reason"] == "length"
        err = got["refused"]["error"]
        assert err.startswith(GENERATION_PREFIX)
        assert error_status(err) == 503
        assert ERROR_PREFIXES[GENERATION_PREFIX] == 503

    def test_out_of_vocab_prompt_structured_400(self, tiny_lm):
        w, in_q, out_q = self._worker(tiny_lm)
        in_q.enqueue_generation("bad", np.array([0, 9999], np.int32),
                                max_tokens=4)
        w.start()
        try:
            got = _drain_stream(out_q, ["bad"])
        finally:
            w.stop()
        err = got["bad"]["error"]
        assert err.startswith(INVALID_PREFIX)
        assert error_status(err) == 400
        assert w.engine.free_slots() == 4

    def test_drain_finishes_inflight_streams(self, tiny_lm):
        w, in_q, out_q = self._worker(tiny_lm)
        in_q.enqueue_generation("d", np.array([4, 5], np.int32),
                                max_tokens=40)
        w.start()
        deadline = time.time() + 10
        while not w._streams and time.time() < deadline:
            time.sleep(0.01)
        assert w._streams
        assert w.drain(deadline_s=20.0) is True
        got = _drain_stream(out_q, ["d"], timeout=5.0)
        assert got["d"]["reason"] == "length"
        assert got["d"]["n_tokens"] == 40
        # a drained worker admits nothing new
        in_q.enqueue_generation("late", np.array([1], np.int32),
                                max_tokens=2)
        time.sleep(0.2)
        assert out_q.dequeue(timeout=0.2) is None

    def test_midstream_deadline_structured_terminal(self, tiny_lm):
        w, _, out_q = self._worker(tiny_lm)
        in_q = InputQueue(queue=w._in, deadline_ms=400.0)
        chaos.install(chaos.ChaosInjector(chaos.parse_spec(
            "sleep:dispatch:every=1:dur=0.12")))
        try:
            in_q.enqueue_generation("slow", np.array([3, 1], np.int32),
                                    max_tokens=50)
            w.start()
            got = _drain_stream(out_q, ["slow"], timeout=15.0)
        finally:
            chaos.uninstall()
            w.stop()
        assert got["slow"]["error"].startswith(DEADLINE_PREFIX)
        assert 0 < len(got["slow"]["toks"]) < 50

    def test_supervisor_restart_replays_exactly_once(self, tiny_lm):
        """Crash mid-stream -> supervisor requeues -> deterministic
        regeneration; chunk-seq dedup makes delivery exactly-once."""
        from analytics_zoo_tpu_torch.serving.resilience import Supervisor

        w, in_q, out_q = self._worker(tiny_lm)
        sup = Supervisor(w, poll_interval_s=0.05, heartbeat_timeout_s=30.0,
                         backoff_base_s=0.01, backoff_max_s=0.05)
        chaos.install(chaos.ChaosInjector(chaos.parse_spec(
            "crash:dispatch:at=4")))
        prompt = np.array([9, 8, 7], np.int32)
        ref = tiny_lm.reference_generate(w.engine.params, prompt, 12)
        try:
            in_q.enqueue_generation("x", prompt, max_tokens=12)
            w.start()
            sup.start()
            toks, last_seq = [], -1
            deadline = time.time() + 30
            while time.time() < deadline:
                item = out_q.dequeue(timeout=0.2)
                if item is None:
                    continue
                uri, tensors = item
                seq = int(np.asarray(tensors[STREAM_KEY]).reshape(()))
                assert ERROR_KEY not in tensors, tensors
                if seq <= last_seq:
                    continue  # replayed chunk after restart
                last_seq = seq
                toks.extend(int(t) for t in
                            np.asarray(tensors["token"]).reshape(-1))
                if "finish_reason" in tensors:
                    break
            assert toks == list(ref)
            assert w.served >= 1
        finally:
            chaos.uninstall()
            sup.stop()
            w.stop()

    def test_batcher_idle_blocks_busy_does_not(self):
        q = InputQueue(backend="memory")
        b = ContinuousBatcher(q.queue)
        t0 = time.monotonic()
        assert b.poll(2, wait_timeout=0.2, idle=False) == []
        assert time.monotonic() - t0 < 0.15
        threading.Timer(0.05, lambda: q.enqueue_generation(
            "u", np.array([1], np.int32))).start()
        assert len(b.poll(2, wait_timeout=2.0, idle=True)) == 1


# -------------------------------------------------------------- launcher --
GEN_BLOCK = {"model": dict(TINY_KW), "slots": 4, "page_size": 4,
             "max_len": 64}


class TestLaunchGeneration:
    def test_launch_serves_streams(self, jax_engine):
        """Generation only (no model: block): launch() on the CPU answers
        each stream once with the JAX package's tokens, and drains."""
        app = launch({"generation": dict(GEN_BLOCK),
                      "http": {"enabled": False}}, device="cpu")
        try:
            assert app.worker is None and app.model is None
            assert app.gen_worker.engine.device.type == "cpu"
            prompts = {f"g{i}": np.arange(1 + i, 4 + 2 * i, dtype=np.int32)
                       for i in range(3)}
            for uri, p in prompts.items():
                assert app.gen_input_queue.enqueue_generation(
                    uri, p, max_tokens=6)
            got = _drain_stream(app.output_queue, list(prompts))
            assert app.drain(deadline_ms=5000) is True
        finally:
            app.stop()
        for uri, rec in got.items():
            assert rec["seqs"] == list(range(6))
            assert rec["toks"] == _jax_tokens(jax_engine, prompts[uri], 6)

    def test_defaults_to_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is visible")
        with pytest.raises(RuntimeError, match="CUDA"):
            launch({"generation": dict(GEN_BLOCK),
                    "http": {"enabled": False}})

    @pytest.mark.parametrize("config,match", [
        ({"generation": dict(GEN_BLOCK, role="prefill")},
         "ROADMAP queue 1: fleet"),
        ({"generation": dict(GEN_BLOCK, role="decode")},
         "ROADMAP queue 1: fleet"),
        ({"generation": dict(GEN_BLOCK), "http": {"enabled": True}},
         "ROADMAP queue 1: HTTP frontend"),
    ], ids=["prefill", "decode", "http"])
    def test_unported_roles_raise(self, config, match):
        config = dict({"http": {"enabled": False}}, **config)
        with pytest.raises(NotImplementedError, match=match):
            launch(config, device="cpu")
