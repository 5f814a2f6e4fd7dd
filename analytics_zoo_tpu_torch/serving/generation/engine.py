"""DecodeEngine: prefill/decode split over a paged KV cache.

The counterpart of ``analytics_zoo_tpu/serving/generation/engine.py``:

- **Prefill** is compute-bound and ragged: prompts are padded onto a
  *prompt-length ladder* (``prefill_ladder`` -- page-size-aligned
  powers of two, so every bucket scatters into whole pages) and run
  through the model's full causal forward. On the card a bucket of 128
  tokens or more launches the flash kernel (K5b at TinyGenLM's head
  dims). ``warm_up`` walks the ladder under ``obs.events.warming()``
  and the first use of every bucket feeds the recompile-storm detector,
  as in the reference (here it is the first launch's builds and
  allocator growth, not a trace).
- **Decode** is memory-bound and regular: ONE fixed-shape step advances
  every lane of the slot table by one token, so requests join and leave
  the running batch at step boundaries.

The reference jits both with the pool donated; PyTorch runs eagerly, so
here both write into ``cache.kv`` in place (indexed assignment under
``torch.inference_mode()``) and no step copies the pool. A step that
raises part way has written only this step's positions, which the next
step writes again (positions advance only after a step returns).

The engine owns slot *state* (next input token, write position per
slot); :class:`~analytics_zoo_tpu_torch.inference.kv_cache.PagedKVCache`
owns page *accounting*; request metadata (uri, deadline, budget) is the
worker's business. Greedy sampling (argmax) runs on the device so only S
tokens cross to the host per step, and the host sync lives in the
``_finalize_*`` methods.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.context import resolve_device
from analytics_zoo_tpu_torch.inference.kv_cache import PagedKVCache
from analytics_zoo_tpu_torch.obs.events import record_compile, warming
from analytics_zoo_tpu_torch.obs.metrics import get_registry
from analytics_zoo_tpu_torch.serving.generation.model import (
    GenModelConfig, TinyGenLM)

_REG = get_registry()
_M_PREFILL = _REG.histogram(
    "zoo_generation_prefill_duration_seconds",
    "Prefill wall time per admitted request, by prompt bucket",
    labelnames=("bucket",))
_M_STEP = _REG.histogram(
    "zoo_generation_decode_step_duration_seconds",
    "One fixed-shape decode step over the slot table (all active "
    "slots advance one token)")
_M_OCC = _REG.gauge(
    "zoo_generation_slot_occupancy_items",
    "Active decode slots (streams currently in the running batch)")
_M_KV = _REG.gauge(
    "zoo_generation_kv_utilization_ratio",
    "Assigned KV-cache pages / total pages (PagedKVCache accounting)")


def prefill_ladder(page_size: int, max_len: int) -> List[int]:
    """The prompt-length shape ladder: ``page_size`` doubling until it
    covers ``max_len``. Page-aligned by construction, so every bucket
    scatters into whole pages; the top entry is the positional-table
    size prefill can index."""
    out = [int(page_size)]
    while out[-1] < max_len:
        out.append(out[-1] * 2)
    return out


class DecodeEngine:
    """Slot-table decode over a paged KV pool.

    Args:
      model: a :class:`TinyGenLM` (or anything exposing its
        ``config``/``init_params``/``prefill``/``decode_step``
        surface).
      params: model parameter tree on ``device``; None =
        ``model.init_params()`` (seeded -- the test/bench path).
      num_slots / page_size / num_pages / max_len: cache geometry;
        None reads the ``zoo.generation.*`` keys.
      dtype: pool dtype (None = f32).
      device: where the parameters, the pool and every step live (None
        = CUDA, raising without a GPU; ``"cpu"`` runs the plain paths).

    Host API (all called from ONE worker loop thread):
      ``admit(prompt, max_new_tokens) -> (slot, first_token)``,
      ``step() -> [(slot, token), ...]``, ``release(slot)``,
      ``warm_up()``.
    """

    def __init__(self, model: TinyGenLM,
                 params: Optional[Dict[str, Any]] = None,
                 num_slots: Optional[int] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 max_len: Optional[int] = None,
                 dtype: Any = None, device=None):
        from analytics_zoo_tpu_torch.common.config import get_config

        cfg = get_config()
        if num_slots is None:
            num_slots = int(cfg.get("zoo.generation.slots", 8))
        if page_size is None:
            page_size = int(cfg.get("zoo.generation.page_size", 16))
        if num_pages is None:
            num_pages = int(cfg.get("zoo.generation.num_pages", 0))
        if max_len is None:
            max_len = int(cfg.get("zoo.generation.max_len", 256))
        self.device = resolve_device(device)
        self.model = model
        c = model.config
        self.ladder = prefill_ladder(page_size, max_len)
        self.params = (params if params is not None
                       else model.init_params(pos_len=self.ladder[-1],
                                              device=self.device))
        self.cache = PagedKVCache(
            num_layers=c.layers, num_heads=c.heads,
            head_dim=c.head_dim, page_size=page_size,
            num_slots=num_slots, num_pages=num_pages, max_len=max_len,
            dtype=dtype, device=self.device)
        self.num_slots = int(num_slots)
        self.page_size = int(page_size)
        self.max_len = int(max_len)
        # per-slot decode state: the token the next step consumes and
        # the position it writes at (position L for a length-L prefix)
        self._tokens = np.zeros(self.num_slots, np.int32)
        self._positions = np.zeros(self.num_slots, np.int32)
        self._active: set = set()
        self._compiled_prefill: set = set()
        self._step_compiled = False

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    # ------------------------------------------------- device bodies --
    def _prefill_impl(self, tokens, pages, last_idx: int):
        """Full forward over one padded prompt ``tokens`` [Lb]; writes
        its K/V pages into the pool in place (bucket pages beyond the
        prompt's assignment point at the trash page) and returns the
        greedy first token from the true last position, on the
        device."""
        logits, k, v = self.model.prefill(self.params, tokens[None])
        npages = tokens.shape[0] // self.page_size
        c = self.model.config
        kv = self.cache.kv
        shape = (c.layers, npages, self.page_size, c.heads, c.head_dim)
        kv[:, 0, pages] = k[:, 0].reshape(shape).to(kv.dtype)
        kv[:, 1, pages] = v[:, 0].reshape(shape).to(kv.dtype)
        return torch.argmax(logits[0, last_idx])

    def _step_impl(self, tokens, positions, block):
        """One token for every slot lane (inactive lanes write to the
        trash page and produce ignored garbage -- fixed shape is the
        contract). Returns the greedy tokens [S] on the device."""
        page = self.page_size
        t_ctx = block.shape[1] * page
        hd = self.model.config.head_dim
        pp = torch.gather(block, 1, (positions // page)[:, None])[:, 0]
        off = positions % page
        kv = self.cache.kv
        mask = (torch.arange(t_ctx, device=kv.device)[None, :]
                <= positions[:, None])

        def write_kv(layer, k, v):
            kv[layer, 0, pp, off] = k.to(kv.dtype)
            kv[layer, 1, pp, off] = v.to(kv.dtype)

        def gather_kv(layer):
            bk = kv[layer, 0][block].reshape(self.num_slots, t_ctx, -1, hd)
            bv = kv[layer, 1][block].reshape(self.num_slots, t_ctx, -1, hd)
            return bk.float(), bv.float(), mask

        logits = self.model.decode_step(self.params, tokens, positions,
                                        gather_kv, write_kv)
        return torch.argmax(logits, dim=-1)

    # --------------------------------------------------------- admit --
    def can_admit(self, prompt_len: int, max_new_tokens: int) -> bool:
        return self.cache.can_admit(int(prompt_len)
                                    + int(max_new_tokens))

    def free_slots(self) -> int:
        return self.cache.free_slot_count()

    def active_slots(self) -> int:
        return len(self._active)

    def admit(self, prompt, max_new_tokens: int) -> Tuple[int, int]:
        """Join the running batch: claim a slot + pages, prefill the
        prompt into the pool, return ``(slot, first_token)``. Raises
        :class:`CacheOverflow` (the caller maps it to the structured
        ``generation_overflow`` refusal) and ValueError on an empty or
        over-long prompt. On success the CALLER owns the slot and owes
        :meth:`release` on every path; on any failure past the claim,
        the slot is given back here before re-raising."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        lp = int(prompt.shape[0])
        if lp < 1:
            raise ValueError("empty prompt")
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        vocab = self.model.config.vocab
        if prompt.min() < 0 or prompt.max() >= vocab:
            raise ValueError(
                f"prompt token ids must be in [0, {vocab})")
        slot = self.cache.admit(lp, max_new_tokens)  # CacheOverflow
        try:
            return slot, self._prefill_slot(slot, prompt, lp)
        except BaseException:
            # anything after the claim (page assignment, prefill) must
            # give the slot + reservation back, or a poisoned request
            # permanently shrinks capacity
            self.cache.release(slot)
            raise

    def _prefill_slot(self, slot: int, prompt: np.ndarray,
                      lp: int) -> int:
        self.cache.ensure_length(slot, lp)
        bucket = next(b for b in self.ladder if b >= lp)
        padded = np.zeros(bucket, np.int32)
        padded[:lp] = prompt
        npages = bucket // self.page_size
        pages = np.zeros(npages, np.int32)  # trash beyond the prompt
        n_assigned = self.cache.pages_for(lp)
        pages[:n_assigned] = self.cache.block_tables()[
            slot, :n_assigned]
        fresh = bucket not in self._compiled_prefill
        t0 = time.perf_counter()
        with torch.inference_mode():
            tok0 = self._prefill_impl(self._to_device(padded),
                                      self._to_device(pages), lp - 1)
        tok0 = self._finalize_prefill(tok0)
        wall = time.perf_counter() - t0
        if fresh:
            self._compiled_prefill.add(bucket)
            record_compile("generation.prefill",
                           [((bucket,), "int32")], wall,
                           subsystem="generation")
        _M_PREFILL.labels(bucket=str(bucket)).observe(wall)
        self._tokens[slot] = tok0
        self._positions[slot] = lp
        self._active.add(slot)
        self._update_gauges()
        return tok0

    def _finalize_prefill(self, tok0) -> int:
        """Sync the first token (the one host round-trip an admission
        pays; the pool was written in place)."""
        return int(tok0)

    # ---------------------------------------------------------- step --
    def step(self) -> List[Tuple[int, int]]:
        """Advance every active slot one token; returns
        ``[(slot, next_token), ...]`` for active slots only (the token
        each slot's *current* input produced). Empty batch = no-op."""
        if not self._active:
            return []
        for slot in self._active:
            # lazy page assignment at the boundary (never fails inside
            # the admission-time reservation)
            self.cache.ensure_length(slot,
                                     int(self._positions[slot]) + 1)
        fresh = not self._step_compiled
        t0 = time.perf_counter()
        with torch.inference_mode():
            toks = self._step_impl(
                self._to_device(self._tokens),
                self._to_device(self._positions),
                self._to_device(self.cache.block_tables()))
        out = self._finalize_step(toks)
        wall = time.perf_counter() - t0
        if fresh:
            self._step_compiled = True
            record_compile(
                "generation.decode_step",
                [((self.num_slots,), "int32")], wall,
                subsystem="generation")
        _M_STEP.observe(wall)
        results = []
        for slot in sorted(self._active):
            nxt = int(out[slot])
            self._positions[slot] += 1
            self._tokens[slot] = nxt
            results.append((slot, nxt))
        return results

    def _finalize_step(self, toks) -> np.ndarray:
        """Sync the step's S tokens to the host -- the per-step
        device->host barrier (everything before it is queued work)."""
        return toks.cpu().numpy()

    # ------------------------------------------------------- release --
    def release(self, slot: int) -> None:
        """Leave the running batch: free the slot and its pages (block
        reuse -- the next admission takes them over)."""
        self._active.discard(slot)
        self._tokens[slot] = 0
        self._positions[slot] = 0
        self.cache.release(slot)
        self._update_gauges()

    # ------------------------------------------------------- handoff --
    # prefill/decode disaggregation: a prefill engine exports a slot's
    # full decode state -- page-aligned KV snapshot plus the host slot
    # registers (next input token, write position) -- and a decode
    # engine imports it and keeps stepping bit-identically. Sampling is
    # greedy argmax, so the slot carries no sampler RNG; ``rng`` stays in
    # the snapshot as an explicit None (the reference's schema).

    def export_slot(self, slot: int) -> Dict[str, Any]:
        """Serialize an active slot for handoff. The slot stays active
        here -- the caller releases it once the handoff is safely
        published (or keeps decoding if publication failed)."""
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not active")
        snap = self.cache.export_pages(slot)
        snap["next_token"] = int(self._tokens[slot])
        snap["position"] = int(self._positions[slot])
        snap["rng"] = None  # greedy decode: no sampler state
        return snap

    def import_slot(self, snapshot: Dict[str, Any]) -> int:
        """Re-admit a handed-off stream: claims a slot via
        :meth:`PagedKVCache.import_pages` (raising
        :class:`CacheOverflow` on exhaustion), restores the slot
        registers, and joins the running batch. On success the CALLER
        owns the slot and owes :meth:`release` on every path, exactly as
        for :meth:`admit`."""
        slot = self.cache.import_pages(snapshot)  # CacheOverflow
        try:
            self._tokens[slot] = int(snapshot["next_token"])
            self._positions[slot] = int(snapshot["position"])
            self._active.add(slot)
            self._update_gauges()
        except BaseException:
            # a malformed register (non-int next_token) must not
            # strand the pages import_pages just claimed
            self.cache.release(slot)
            self._active.discard(slot)
            raise
        return slot

    def _update_gauges(self) -> None:
        _M_OCC.set(len(self._active))
        _M_KV.set(self.cache.utilization())

    # ------------------------------------------------------- warm-up --
    def warm_up(self) -> "DecodeEngine":
        """Run the whole prefill ladder and the decode step once before
        traffic (first-use costs: kernel builds, cuBLAS plans, allocator
        growth), flagged warm so N buckets in N seconds don't read as a
        recompile storm. Writes land on the trash page; slot state and
        accounting are untouched."""
        with warming(), torch.inference_mode():
            for bucket in self.ladder:
                if bucket in self._compiled_prefill:
                    continue
                t0 = time.perf_counter()
                self._finalize_prefill(self._prefill_impl(
                    self._to_device(np.zeros(bucket, np.int32)),
                    self._to_device(np.zeros(bucket // self.page_size,
                                             np.int32)), 0))
                self._compiled_prefill.add(bucket)
                record_compile("generation.prefill",
                               [((bucket,), "int32")],
                               time.perf_counter() - t0,
                               subsystem="generation", warm=True)
            if not self._step_compiled:
                t0 = time.perf_counter()
                zeros = self._to_device(np.zeros(self.num_slots, np.int32))
                self._finalize_step(self._step_impl(
                    zeros, zeros,
                    self._to_device(self.cache.block_tables())))
                self._step_compiled = True
                record_compile("generation.decode_step",
                               [((self.num_slots,), "int32")],
                               time.perf_counter() - t0,
                               subsystem="generation", warm=True)
        return self

    # --------------------------------------------------------- stats --
    def stats(self) -> Dict[str, Any]:
        return {
            "slots": self.num_slots,
            "active": len(self._active),
            "ladder": list(self.ladder),
            "prefill_buckets_compiled": sorted(self._compiled_prefill),
            "cache": self.cache.stats(),
        }


def engine_from_config(gen_cfg: Dict[str, Any],
                       device=None) -> DecodeEngine:
    """Build an engine from a launcher ``generation:`` block: ``model:``
    holds :class:`GenModelConfig` fields (the seeded builtin LM);
    ``slots``/``page_size``/``num_pages``/``max_len`` override the
    ``zoo.generation.*`` defaults for this launch only. ``device``: None
    = CUDA."""
    model_cfg = dict(gen_cfg.get("model") or {})
    config = GenModelConfig.from_dict(model_cfg)
    return DecodeEngine(
        TinyGenLM(config),
        num_slots=gen_cfg.get("slots"),
        page_size=gen_cfg.get("page_size"),
        num_pages=gen_cfg.get("num_pages"),
        max_len=gen_cfg.get("max_len"),
        device=device)
