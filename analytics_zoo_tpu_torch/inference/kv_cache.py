"""Paged KV cache for autoregressive generation serving.

The counterpart of ``analytics_zoo_tpu/inference/kv_cache.py``, with the
same accounting and snapshot schema:

- **One page pool per engine.** All cached K/V live in a single device
  tensor shaped ``[layers, 2, num_pages + 1, page_size, heads,
  head_dim]`` (2 = key/value planes), f32 by default, allocated once.
  The engine writes into it in place (no step copies the pool).
- **Slot table.** A fixed number of decode *slots*
  (``zoo.generation.slots``); each slot owns a *block table* row
  mapping its logical pages to physical pool pages. Physical page 0 is
  the **trash page**: inactive slots' block tables point at it, so the
  fixed-shape decode step's masked-lane writes land somewhere harmless.
- **Reservation-based admission, lazy assignment.** ``admit`` succeeds
  only when the pool can cover the request's worst case
  (``prompt_len + max_new_tokens``), so a stream can never die
  mid-decode from cache exhaustion -- refusal happens exactly once, at
  admission, as a structured ``generation_overflow`` 503. Physical
  pages are assigned lazily as the sequence crosses page boundaries
  (``ensure_length``), and released pages go straight back on the free
  list for the next admission (block reuse).

The allocator is host-side; only the pool lives in device memory.
Writes and gathers against the pool are the engine's business
(:mod:`analytics_zoo_tpu_torch.serving.generation.engine`).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.context import resolve_device


class CacheOverflow(Exception):
    """Admission refused: the pool cannot cover the request's worst
    case. The serving layer maps this to the structured
    ``generation_overflow`` error (HTTP 503 + Retry-After)."""


class PagedKVCache:
    """Page-pool allocator + device K/V store for one decode engine.

    Args:
      num_layers / num_heads / head_dim: attention geometry of the
        served model (the pool holds one K and one V plane per layer).
      page_size: tokens per page (``zoo.generation.page_size``).
      num_slots: decode slot-table size (``zoo.generation.slots``).
      num_pages: physical pages *excluding* the trash page; 0 = auto:
        enough for every slot to reach ``max_len`` simultaneously
        (``zoo.generation.num_pages``).
      max_len: per-slot length ceiling (prompt + generated,
        ``zoo.generation.max_len``); fixes the block-table width.
      dtype: pool dtype (a ``torch.dtype``; None = f32).
      device: where the pool lives (None = CUDA, raising without one).

    Thread-safety: the allocator is lock-guarded (admission runs on the
    worker loop, stats() on metric scrapes); the pool tensor itself is
    only touched by the engine's loop thread.
    """

    def __init__(self, num_layers: int, num_heads: int, head_dim: int,
                 page_size: int = 16, num_slots: int = 8,
                 num_pages: int = 0, max_len: int = 256,
                 dtype: Any = None, device=None):
        if page_size < 1 or num_slots < 1 or max_len < 2:
            raise ValueError("page_size/num_slots >= 1, max_len >= 2")
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.page_size = int(page_size)
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        # block-table width: the most pages one slot can ever need
        self.pages_per_slot = self.pages_for(self.max_len)
        if num_pages <= 0:
            num_pages = self.num_slots * self.pages_per_slot
        self.num_pages = int(num_pages)
        self.device = resolve_device(device)
        # physical page 0 is the trash page -> pool holds num_pages + 1
        self.kv = torch.zeros(
            (self.num_layers, 2, self.num_pages + 1, self.page_size,
             self.num_heads, self.head_dim),
            dtype=torch.float32 if dtype is None else dtype,
            device=self.device)
        self._lock = threading.Lock()
        self._free_pages: List[int] = list(range(1, self.num_pages + 1))
        self._free_slots: List[int] = list(range(self.num_slots))
        # per-slot accounting (host side; the engine mirrors block
        # tables/lengths to the device per step)
        self._block = np.zeros((self.num_slots, self.pages_per_slot),
                               np.int32)  # 0 = trash (unassigned)
        self._assigned = np.zeros(self.num_slots, np.int32)  # pages
        self._length = np.zeros(self.num_slots, np.int32)    # tokens
        self._reserve = np.zeros(self.num_slots, np.int32)   # worst case
        # pages promised to admitted slots but not yet popped off the
        # free list -- the quantity that makes admission refusal exact
        self._unassigned_reserved = 0

    # ------------------------------------------------------ geometry --
    def pages_for(self, length: int) -> int:
        """Pages covering ``length`` tokens (ceil division)."""
        return -(-int(length) // self.page_size)

    # ----------------------------------------------------- admission --
    def can_admit(self, total_len: int) -> bool:
        with self._lock:
            return self._can_admit_locked(total_len)

    def _can_admit_locked(self, total_len: int) -> bool:
        if total_len > self.max_len or not self._free_slots:
            return False
        need = self.pages_for(total_len)
        avail = len(self._free_pages) - self._unassigned_reserved
        return need <= avail

    def admit(self, prompt_len: int, max_new_tokens: int) -> int:
        """Claim a slot whose sequence may grow to
        ``prompt_len + max_new_tokens`` tokens; reserves (but does not
        yet assign) the worst-case pages. Raises :class:`CacheOverflow`
        when no slot or not enough free pages -- the one refusal point
        of a generation request's lifetime.

        A successful ``admit`` opens an obligation: every code path
        that can run afterwards must reach :meth:`release` or hand the
        slot to an owner that will (e.g. the worker's stream table)."""
        total = int(prompt_len) + int(max_new_tokens)
        with self._lock:
            if total > self.max_len:
                raise CacheOverflow(
                    f"sequence of up to {total} tokens exceeds "
                    f"max_len {self.max_len}")
            need = self.pages_for(total)
            avail = len(self._free_pages) - self._unassigned_reserved
            if not self._free_slots or need > avail:
                raise CacheOverflow(
                    f"kv cache exhausted: need {need} pages for a "
                    f"{total}-token stream, {max(0, avail)} free "
                    f"(slots free: {len(self._free_slots)})")
            slot = self._free_slots.pop(0)
            self._reserve[slot] = need
            self._unassigned_reserved += need
            self._assigned[slot] = 0
            self._length[slot] = 0
            self._block[slot, :] = 0
            return slot

    def ensure_length(self, slot: int, length: int) -> None:
        """Assign physical pages so positions ``[0, length)`` are
        backed; called by the engine before writing K/V at a new
        position. Never fails for an admitted slot growing inside its
        reservation (that is the point of reserving at admit)."""
        need = self.pages_for(length)
        with self._lock:
            if length > int(self._reserve[slot]) * self.page_size:
                raise ValueError(
                    f"slot {slot} growing past its reservation "
                    f"({length} tokens > {int(self._reserve[slot])} "
                    "pages)")
            while int(self._assigned[slot]) < need:
                page = self._free_pages.pop(0)
                self._block[slot, int(self._assigned[slot])] = page
                self._assigned[slot] += 1
                self._unassigned_reserved -= 1
            self._length[slot] = max(int(self._length[slot]),
                                     int(length))

    def release(self, slot: int) -> None:
        """Return the slot and every page it held to the free lists
        (block reuse: the next admission hands these same pages out).
        Idempotent -- a double release is a no-op, not corruption."""
        with self._lock:
            if slot in self._free_slots:
                return
            n = int(self._assigned[slot])
            self._free_pages.extend(
                int(p) for p in self._block[slot, :n])
            self._unassigned_reserved -= max(
                0, int(self._reserve[slot]) - n)
            self._block[slot, :] = 0
            self._assigned[slot] = 0
            self._length[slot] = 0
            self._reserve[slot] = 0
            self._free_slots.append(slot)
            self._free_slots.sort()

    # ------------------------------------------------ page handoff --
    # disaggregated prefill/decode pools: a prefill replica serializes a
    # slot's pages and hands the stream to a decode replica; the
    # snapshot is page-aligned (whole pages, including the unused tail
    # of the last page) so the importer writes physical pages verbatim
    # and the decode step resumes bit-identically.

    def export_pages(self, slot: int) -> Dict[str, Any]:
        """Serialize ``slot``'s assigned pages + accounting into a
        host-side snapshot dict (``kv`` [layers, 2, n, page_size,
        heads, head_dim] numpy, f32 for a bf16 pool, ``length`` tokens,
        ``reserve`` worst-case pages). The slot itself stays admitted --
        callers release it (or keep decoding) after the handoff is
        safely published.

        A successful ``export_pages`` opens an obligation: the
        snapshot must reach :meth:`import_pages` (possibly on another
        cache) or the stream's slot must be released -- an exported
        snapshot abandoned on an error path strands the stream with no
        owner."""
        with self._lock:
            if slot in self._free_slots:
                raise ValueError(f"slot {slot} is not admitted")
            n = int(self._assigned[slot])
            pages = [int(p) for p in self._block[slot, :n]]
            length = int(self._length[slot])
            reserve = int(self._reserve[slot])
        # gather outside the lock: device -> host copy of n pages
        if pages:
            part = self.kv[:, :, torch.as_tensor(pages,
                                                 device=self.kv.device)]
            if part.dtype == torch.bfloat16:  # numpy has no bf16
                part = part.float()
            kv = part.cpu().numpy()
        else:
            kv = np.zeros((self.num_layers, 2, 0, self.page_size,
                           self.num_heads, self.head_dim), np.float32)
        return {"kv": kv, "length": length, "reserve": reserve}

    def import_pages(self, snapshot: Dict[str, Any]) -> int:
        """Re-admit a handed-off stream from an :meth:`export_pages`
        snapshot: claims a slot + its worst-case reservation, assigns
        physical pages for the backed length, and writes the page
        contents verbatim. Returns the (new) slot id. Raises
        :class:`CacheOverflow` when no slot / not enough free pages --
        the importer maps that to the structured ``generation_overflow``
        refusal, same as first admission -- and :class:`ValueError` on
        a snapshot whose geometry does not match this pool."""
        kv = np.asarray(snapshot["kv"])
        length = int(snapshot["length"])
        reserve = int(snapshot["reserve"])
        need = self.pages_for(length)
        expect = (self.num_layers, 2, need, self.page_size,
                  self.num_heads, self.head_dim)
        if kv.shape != expect:
            raise ValueError(
                f"snapshot geometry {kv.shape} does not match pool "
                f"{expect}")
        if reserve < need:
            raise ValueError(
                f"snapshot reserve {reserve} pages < backed {need}")
        with self._lock:
            if reserve * self.page_size > self.max_len:
                raise CacheOverflow(
                    f"snapshot reservation of {reserve} pages exceeds "
                    f"max_len {self.max_len}")
            avail = len(self._free_pages) - self._unassigned_reserved
            if not self._free_slots or reserve > avail:
                raise CacheOverflow(
                    f"kv cache exhausted: need {reserve} pages to "
                    f"import a {length}-token stream, "
                    f"{max(0, avail)} free "
                    f"(slots free: {len(self._free_slots)})")
            slot = self._free_slots.pop(0)
            self._reserve[slot] = reserve
            self._block[slot, :] = 0
            pages = [self._free_pages.pop(0) for _ in range(need)]
            for i, page in enumerate(pages):
                self._block[slot, i] = page
            self._assigned[slot] = need
            self._length[slot] = length
            self._unassigned_reserved += reserve - need
        if pages:
            # scatter outside the lock: host -> device page writes, in
            # place
            idx = torch.as_tensor(pages, device=self.kv.device)
            with torch.inference_mode():
                self.kv[:, :, idx] = torch.tensor(
                    kv, dtype=self.kv.dtype, device=self.kv.device)
        return slot

    # ---------------------------------------------------- step views --
    def block_tables(self) -> np.ndarray:
        """[num_slots, pages_per_slot] int32 physical-page map (0 =
        trash/unassigned) -- a defensive copy the engine ships to the
        device each step."""
        with self._lock:
            return self._block.copy()

    def lengths(self) -> np.ndarray:
        """[num_slots] int32 backed sequence length per slot."""
        with self._lock:
            return self._length.copy()

    # ----------------------------------------------------- accounting --
    def free_slot_count(self) -> int:
        with self._lock:
            return len(self._free_slots)

    def utilization(self) -> float:
        """Assigned pages / usable pages -- the
        ``zoo_generation_kv_utilization_ratio`` gauge."""
        with self._lock:
            return (self.num_pages - len(self._free_pages)) \
                / max(1, self.num_pages)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            assigned = self.num_pages - len(self._free_pages)
            return {
                "num_pages": self.num_pages,
                "page_size": self.page_size,
                "num_slots": self.num_slots,
                "pages_assigned": assigned,
                "pages_reserved_unassigned": self._unassigned_reserved,
                "slots_free": len(self._free_slots),
                "utilization": assigned / max(1, self.num_pages),
                "bytes": self.kv.numel() * self.kv.element_size(),
            }
