"""Flash attention, forward (K1) and backward (K2 dQ, K3 dK/dV), and K5b
(both directions at head dims that are not a multiple of 64): hand-written
CUDA kernels for Hopper, and their gradient (K4).

The counterpart of ``analytics_zoo_tpu/ops/pallas_attention.py``: exact
``softmax(scale * Q K^T) V`` on ``[B, H, L, D]``, causal mask aligned
bottom-right (offset ``lk - lq``), optional per-row logsumexp, and the
backward that rebuilds the probabilities from that logsumexp. The
kernels live in ``csrc/flash_attn_fwd.cu`` and in
``csrc/flash_attn_bwd.cuh`` (design notes there), whose K2 and K3 are
built by ``csrc/flash_attn_bwd_dq.cu`` and ``csrc/flash_attn_bwd_dkv.cu``;
each source is compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/`` at the repository root (a per-user cache for an installed
package), side by side, and loaded through ``ctypes``.

Every function also takes ``key_padding_mask`` (``[B, Lk]``, nonzero =
real token, any pattern): the counterpart of the key-padding branch that
the reference sends to JAX's stock Pallas kernel with segment ids
(``analytics_zoo_tpu/ops/attention.py:116``). The semantics are
``_einsum_attention``'s with the mask as ``[B, 1, 1, Lk]``:

- a query row sees the real keys (and, with ``causal``, only those on or
  below the diagonal); padded query rows are computed like any other;
- a row that sees no key at all (an all-zero mask row, or ``causal``
  with left padding) gets what the einsum path's finite ``-1e30`` fill
  gives: the mean of V over all Lk keys, no gradient to q or k, and
  ``dO / Lk`` to the dV of every key. Its logsumexp is reported as
  ``EMPTY_LSE`` (``-1e30``, what f32 ``logsumexp`` of that filled row
  gives); the backward finds such rows from the mask, not from the lse;
- padded keys get exactly zero dK, and zero dV apart from that uniform
  share of rows that see no key.

Every wrapper takes a CPU tensor to its plain PyTorch version and a CUDA
tensor to its kernel; there is no fallback between the two.
``flash_attention`` goes through ``FlashAttention`` (a
``torch.autograd.Function``: K1 with logsumexp forward, K2 then K3
backward) whenever autograd is recording and an input needs a gradient.
Each wrapper counts its kernel launches in ``<wrapper>.launches``, and
those given a key-padding mask in ``<wrapper>.masked_launches``, and
those at a head dim that is not a multiple of 64 (K5b) in
``<wrapper>.small_d_launches``.

K5b is the counterpart of the reference's stock-kernel branch at such
head dims (``analytics_zoo_tpu/ops/attention.py:116``: JAX's stock Pallas
``flash_attention`` for ``d <= 128``, with its own dQ and dK/dV behind
its custom_vjp; TinyGenLM's prefill at D = 16, a MiniLM-sized BERT's
fine-tune at D = 32): the same sources, K1 and K2/K3 instantiated at
every multiple of 8 up to 128.

Shapes the kernels take: D a multiple of 8 up to 128, in both
directions; L and Lk multiples of ``TILE`` (64);
f32 or bf16; the last dimension contiguous and 16-byte aligned rows
(other strides are free, so q/k/v may be views into a fused qkv
projection); a key-padding mask of ``[B, Lk]`` on the same device, of
any dtype (converted once per call to contiguous bytes, ``mask != 0``).
Anything else raises: a head dim under 128 that is not a multiple of 8
with ``NotImplementedError`` (no kernel covers it yet).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

TILE = 64
# the logsumexp reported for a query row that sees no key
EMPTY_LSE = -1e30

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = tuple(sorted(_CSRC.glob("*.cu")))
# headers the sources include: part of what a build depends on
_HEADERS = tuple(sorted(_CSRC.glob("*.cuh")))
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# key-padding mask and its batch stride, scale, causal, stream
_TAIL = [_P, _L, ctypes.c_float, _I, _P]
# C entry point -> (source stem, argtypes)
_ENTRY_POINTS = {
    "zoo_flash_attn_fwd": ("flash_attn_fwd",
                           [_P] * 5 + [_I] * 6 + [_L] * 12 + _TAIL),
    "zoo_flash_attn_bwd_dq": ("flash_attn_bwd_dq",
                              [_P] * 8 + [_I] * 6 + [_L] * 18 + _TAIL),
    "zoo_flash_attn_bwd_dkv": ("flash_attn_bwd_dkv",
                               [_P] * 8 + [_I] * 6 + [_L] * 18 + _TAIL),
}

_lib: Optional[Dict[str, ctypes.CDLL]] = None
_lib_lock = threading.Lock()
# what the last build printed (ptxas registers / spills per kernel) and
# how long it took; read by chip_smoke.py
build_info = {"log": "", "seconds": None, "path": None}


def _build_dir() -> Path:
    """``build/`` at the repository root in a source checkout (listed in
    .gitignore); a per-user cache directory for an installed package."""
    root = Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").is_file():
        return root / "build"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "analytics_zoo_tpu_torch" / "build"


def _resolve_scale(scale: Optional[float], d: int) -> float:
    return float(scale) if scale is not None else 1.0 / float(np.sqrt(d))


def _causal_keep(lq: int, lk: int, device) -> torch.Tensor:
    return torch.ones(lq, lk, dtype=torch.bool, device=device).tril(lk - lq)


def _visible(lq: int, lk: int, causal: bool,
             key_padding_mask: Optional[torch.Tensor], device
             ) -> Optional[torch.Tensor]:
    """Which (query, key) pairs are visible, broadcastable to
    ``[B, H, Lq, Lk]`` (None: all of them)."""
    keep = _causal_keep(lq, lk, device) if causal else None
    if key_padding_mask is not None:
        real = (key_padding_mask != 0)[:, None, None, :]
        keep = real if keep is None else keep & real
    return keep


def _scores(q, k, scale, keep):
    """f32 ``scale * Q K^T`` with the pairs not in ``keep`` at -inf."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return s if keep is None else s.masked_fill(~keep, float("-inf"))


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False,
                              scale: Optional[float] = None,
                              with_lse: bool = False,
                              key_padding_mask: Optional[torch.Tensor] = None
                              ) -> Union[torch.Tensor,
                                         Tuple[torch.Tensor, torch.Tensor]]:
    """Plain PyTorch version of K1: the same function, computed with the
    whole [Lq, Lk] score matrix in f32. Returns ``out`` in the input
    dtype, plus ``lse`` as ``[B*H, Lq]`` f32 when ``with_lse``. A row
    that sees no key averages V over all keys, with ``EMPTY_LSE``."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if causal and lq > lk:
        raise ValueError("causal attention requires len(q) <= len(kv)")
    s = _scores(q, k, _resolve_scale(scale, d),
                _visible(lq, lk, causal, key_padding_mask, q.device))
    # softmax through exp(s - lse), not logsumexp over a finite fill: in
    # f32 the logsumexp of a row all at -1e30 is -1e30 (log(Lk) is
    # absorbed), which would turn that row's mean into a sum
    lse = torch.logsumexp(s, dim=-1)
    empty = torch.isneginf(lse)
    p = torch.exp(s - lse.masked_fill(empty, 0.0)[..., None])
    p = torch.where(empty[..., None], 1.0 / lk, p)
    out = torch.matmul(p, v.float()).to(q.dtype)
    if with_lse:
        return out, lse.masked_fill(empty, EMPTY_LSE).reshape(b * h, lq)
    return out


def _bwd_plain(q, k, v, lse, delta, do, causal, scale, want_dq, want_dkv,
               key_padding_mask=None):
    """The backward as ``_flash_bwd`` computes it, with whole [Lq, Lk]
    matrices in f32: P rebuilt from ``lse``, dS rounded to the input
    dtype before the dQ and dK products, P rounded to dO's dtype before
    dV. Masked pairs get P = 0 and dS = 0; a row that sees no key gives
    P = 1/Lk to every key in dV alone. Returns the wanted ones of dq,
    dk, dv, in the input dtypes."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    scale = _resolve_scale(scale, d)
    keep = _visible(lq, lk, causal, key_padding_mask, q.device)
    p = torch.exp(_scores(q, k, scale, keep) - lse.reshape(b, h, lq, 1))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta.reshape(b, h, lq, 1)) * scale).to(q.dtype).float()
    out = []
    if want_dq:
        out.append(torch.matmul(ds, k.float()).to(q.dtype))
    if want_dkv:
        if keep is not None:
            p = torch.where(~keep.any(-1, keepdim=True), 1.0 / lk, p)
        out.append(torch.matmul(ds.transpose(-1, -2), q.float()).to(k.dtype))
        out.append(torch.matmul(p.to(do.dtype).float().transpose(-1, -2),
                                do.float()).to(v.dtype))
    return out


def flash_attention_bwd_dq_reference(q, k, v, o, lse, do,
                                     causal: bool = False,
                                     scale: Optional[float] = None,
                                     key_padding_mask=None):
    """Plain PyTorch version of K2: ``(dq, delta)`` with
    ``delta = rowsum(do * o)`` as ``[B*H, Lq]`` f32 (``_flash_bwd``
    :316-320)."""
    b, h, lq, _ = o.shape
    delta = (do.float() * o.float()).sum(-1).reshape(b * h, lq)
    (dq,) = _bwd_plain(q, k, v, lse, delta, do, causal, scale, True, False,
                       key_padding_mask)
    return dq, delta


def flash_attention_bwd_dkv_reference(q, k, v, lse, delta, do,
                                      causal: bool = False,
                                      scale: Optional[float] = None,
                                      key_padding_mask=None):
    """Plain PyTorch version of K3: ``(dk, dv)`` from K2's ``delta``."""
    dk, dv = _bwd_plain(q, k, v, lse, delta, do, causal, scale, False, True,
                        key_padding_mask)
    return dk, dv


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  lse: torch.Tensor, do: torch.Tensor,
                                  causal: bool = False,
                                  scale: Optional[float] = None,
                                  key_padding_mask=None
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain PyTorch version of K2, K3 and delta: (dq, dk, dv) in the
    input dtypes, from the forward's ``o`` and ``lse`` ([B*H, Lq] f32)
    and the output gradient ``do``."""
    dq, delta = flash_attention_bwd_dq_reference(q, k, v, o, lse, do,
                                                 causal, scale,
                                                 key_padding_mask)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, lse, delta, do,
                                               causal, scale,
                                               key_padding_mask)
    return dq, dk, dv


# ----------------------------------------------------------------- build --
def _nvcc() -> str:
    cand = os.environ.get("NVCC") or shutil.which("nvcc")
    if not cand:
        default = Path("/usr/local/cuda/bin/nvcc")
        cand = str(default) if default.is_file() else None
    if not cand:
        raise RuntimeError(
            "nvcc not found (set NVCC or put the CUDA toolkit on PATH): "
            "the flash-attention kernels are built from "
            f"{', '.join(s.name for s in _SOURCES)} at first use")
    return cand


def build_kernels() -> Dict[str, ctypes.CDLL]:
    """Compile every ``csrc/*.cu`` for sm_90a (once per content of all the
    sources and headers together; one ``nvcc`` per source, run side by
    side) and load them. Returns ``{source stem: library}``. Raises if
    ``nvcc`` is missing or fails."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        nvcc = _nvcc()
        digest = hashlib.sha1(" ".join(_NVCC_FLAGS).encode())
        for src in _SOURCES + _HEADERS:
            digest.update(src.name.encode() + b"\0" + src.read_bytes())
        tag = digest.hexdigest()[:12]
        build_dir = _build_dir()
        build_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        sos = {src.stem: build_dir / f"libzoo_{src.stem}_{tag}.so"
               for src in _SOURCES}
        procs = {}
        for src in _SOURCES:
            so = sos[src.stem]
            if not so.is_file():
                tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
                procs[src] = (tmp, subprocess.Popen(
                    [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
        logs, failed = [], []
        for src, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) on "
                              f"{src.name}:\n{out}")
            else:
                os.replace(tmp, sos[src.stem])
        if failed:
            raise RuntimeError("\n".join(failed))
        if logs:
            build_info["log"] = "\n".join(logs)
        build_info["seconds"] = time.perf_counter() - t0
        build_info["path"] = str(build_dir)
        libs = {stem: ctypes.CDLL(str(so)) for stem, so in sos.items()}
        for name, (stem, argtypes) in _ENTRY_POINTS.items():
            fn = getattr(libs[stem], name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
        _lib = libs
        return libs


def _entry(name: str):
    return getattr(build_kernels()[_ENTRY_POINTS[name][0]], name)


# ---------------------------------------------------------------- launch --
def _check_layout(name: str, t: torch.Tensor) -> None:
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: last dimension must be contiguous")
    align = 16 // t.element_size()
    if (t.data_ptr() % 16 or any(s % align for s in t.stride()[:3])):
        raise ValueError(f"{name}: rows must start on 16-byte boundaries "
                         f"(strides {tuple(t.stride())})")


def _check_head_dim(d: int) -> None:
    """Raise unless a kernel covers head dim ``d``, in both directions:
    every multiple of 8 up to 128 (K1-K3 at 64 and 128, K5b the rest)."""
    if d > 128:
        raise ValueError(f"flash kernel: head_dim {d} > 128")
    if d % 8:
        raise NotImplementedError(
            f"flash kernel at head_dim {d}: K5b covers multiples of 8 up "
            "to 128 (16-byte rows); other head dims have no kernel yet "
            "(ROADMAP section 2)")


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, mask: Optional[torch.Tensor] = None,
                  **more: torch.Tensor) -> None:
    b, h, lq, d = q.shape
    lk = k.shape[2]
    tensors = dict(q=q, k=k, v=v, **more)
    if not (q.is_cuda and all(t.device == q.device for t in
                              (*tensors.values(),
                               *([mask] if mask is not None else [])))):
        raise ValueError("flash kernel: every tensor must be on one CUDA "
                         "device")
    if mask is not None and tuple(mask.shape) != (b, lk):
        raise ValueError(f"flash kernel: key_padding_mask must be "
                         f"[{b}, {lk}], got {tuple(mask.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash kernel takes float32 or bfloat16 q/k/v, "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (b, h, lk, d) or v.shape != k.shape:
        raise ValueError(f"flash kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    _check_head_dim(d)
    if lq % TILE or lk % TILE:
        raise ValueError(f"flash kernel: seq lens ({lq},{lk}) must be "
                         f"multiples of {TILE}")
    if causal and lq > lk:
        # rows attending to nothing are undefined under flash semantics
        raise ValueError("causal attention requires len(q) <= len(kv)")
    if b * h > 65535:
        raise ValueError(f"flash kernel: batch*heads {b * h} > 65535")
    for name, t in tensors.items():
        if name in ("lse", "delta"):
            if (t.dtype != torch.float32 or t.shape != (b * h, lq)
                    or not t.is_contiguous()):
                raise ValueError(f"flash kernel: {name} must be a "
                                 f"contiguous [{b * h}, {lq}] f32 tensor")
            continue
        if name in ("o", "do") and (t.dtype != q.dtype
                                    or t.shape != q.shape):
            raise ValueError(f"flash kernel: {name} must match q "
                             f"({tuple(q.shape)}, {q.dtype})")
        _check_layout(name, t)


def _empty_bhld(b, h, l, d, like: torch.Tensor) -> torch.Tensor:
    """``[B, H, L, D]`` laid out as ``[B, L, H, D]``: merging heads back
    into ``[B, L, H*D]`` is then a free view."""
    return torch.empty(b, l, h, d, dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _kernel_mask(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The key-padding mask as the kernels read it: contiguous bytes,
    nonzero = real. A contiguous uint8 mask is taken as it is; any
    other is converted once (``mask != 0``)."""
    if mask is None or (mask.dtype == torch.uint8 and mask.is_contiguous()):
        return mask
    return mask.ne(0).contiguous().view(torch.uint8)


def _mask_args(mask: Optional[torch.Tensor]) -> tuple:
    """(pointer, batch stride) of a ``_kernel_mask``; null for none."""
    return (None, 0) if mask is None else (mask.data_ptr(), mask.stride(0))


def _count(wrapper, mask, d: int = 64) -> None:
    wrapper.launches += 1
    if mask is not None:
        wrapper.masked_launches += 1
    if d % 64:
        wrapper.small_d_launches += 1


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, scale: Optional[float], with_lse: bool,
            key_padding_mask: Optional[torch.Tensor] = None):
    fn = _entry("zoo_flash_attn_fwd")
    _check_inputs(q, k, v, causal, key_padding_mask)
    mask = _kernel_mask(key_padding_mask)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    out = _empty_bhld(b, h, lq, d, q)
    lse = (torch.empty(b * h, lq, dtype=torch.float32, device=q.device)
           if with_lse else None)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            _DTYPE_CODE[q.dtype], b, h, lq, lk, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], *_mask_args(mask), _resolve_scale(scale, d),
            int(causal), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash kernel launch failed: code {rc}")
    _count(flash_attention, mask, d)
    return (out, lse) if with_lse else out


def _last_dim_contiguous(t: torch.Tensor) -> torch.Tensor:
    # autograd may hand over a gradient whose head dimension is strided;
    # the kernels read rows of D contiguous elements (a layout step)
    return t if t.stride(-1) == 1 else t.contiguous()


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, o: torch.Tensor,
                           lse: torch.Tensor, do: torch.Tensor,
                           causal: bool = False,
                           scale: Optional[float] = None,
                           key_padding_mask: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: ``(dq, delta)``, where ``delta = rowsum(do * o)`` ([B*H, Lq]
    f32) is what K3 reads. The kernel on CUDA, the plain version on the
    CPU."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, o, lse, do, causal,
                                                scale, key_padding_mask)
    fn = _entry("zoo_flash_attn_bwd_dq")
    _check_inputs(q, k, v, causal, key_padding_mask, o=o, do=do, lse=lse)
    mask = _kernel_mask(key_padding_mask)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    dq = _empty_bhld(b, h, lq, d, q)
    delta = torch.empty(b * h, lq, dtype=torch.float32, device=q.device)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            _DTYPE_CODE[q.dtype], b, h, lq, lk, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], *do.stride()[:3], *dq.stride()[:3],
            *_mask_args(mask), _resolve_scale(scale, d), int(causal),
            _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash dq kernel launch failed: code {rc}")
    _count(flash_attention_bwd_dq, mask, d)
    return dq, delta


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, lse: torch.Tensor,
                            delta: torch.Tensor, do: torch.Tensor,
                            causal: bool = False,
                            scale: Optional[float] = None,
                            key_padding_mask: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: ``(dk, dv)`` from the ``delta`` that K2 returned. The kernel
    on CUDA, the plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, lse, delta, do,
                                                 causal, scale,
                                                 key_padding_mask)
    fn = _entry("zoo_flash_attn_bwd_dkv")
    _check_inputs(q, k, v, causal, key_padding_mask, do=do, lse=lse,
                  delta=delta)
    mask = _kernel_mask(key_padding_mask)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    dk = _empty_bhld(b, h, lk, d, k)
    dv = _empty_bhld(b, h, lk, d, v)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _DTYPE_CODE[q.dtype], b, h, lq, lk, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
            *_mask_args(mask), _resolve_scale(scale, d), int(causal),
            _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash dkv kernel launch failed: code {rc}")
    _count(flash_attention_bwd_dkv, mask, d)
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = False,
                        scale: Optional[float] = None,
                        key_padding_mask: Optional[torch.Tensor] = None):
    """The backward of K1: delta and dQ (K2), then dK and dV (K3)."""
    do = _last_dim_contiguous(do)
    key_padding_mask = _kernel_mask(key_padding_mask)  # once for both
    dq, delta = flash_attention_bwd_dq(q, k, v, o, lse, do, causal, scale,
                                       key_padding_mask)
    dk, dv = flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal, scale,
                                     key_padding_mask)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K4, the counterpart of ``pallas_flash_attention_fwd``'s custom_vjp:
    forward K1 with logsumexp (saving q, k, v, o, lse and the key-padding
    mask, which takes no gradient), backward K2 then K3, at every head
    dim the kernels take (K5b's included). On CPU tensors the same wiring
    runs the plain versions. On CUDA at a head dim no kernel takes, it
    raises before the forward runs."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: Optional[float],
                key_padding_mask: Optional[torch.Tensor] = None):
        mask = _kernel_mask(key_padding_mask)  # once for K1, K2 and K3
        if q.device.type == "cpu":
            out, lse = flash_attention_reference(q, k, v, causal, scale,
                                                 True, mask)
        else:
            # raise on a head dim no kernel takes before K1-lse builds
            _check_head_dim(q.shape[-1])
            out, lse = _launch(q, k, v, causal, scale, True, mask)
        ctx.save_for_backward(q, k, v, out, lse, mask)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse, mask = ctx.saved_tensors
        # positional: callers that wrap flash_attention_bwd see every
        # argument in *args
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.causal,
                                         ctx.scale, mask)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    with_lse: bool = False,
                    key_padding_mask: Optional[torch.Tensor] = None):
    """Flash attention on ``[B, H, L, D]``: the CUDA kernels for CUDA
    tensors, the plain versions for CPU tensors. Returns ``out`` (input
    dtype), plus ``lse`` ``[B*H, Lq]`` f32 (not differentiable) when
    ``with_lse``. ``key_padding_mask`` is ``[B, Lk]``, nonzero = real
    token. Differentiable through ``FlashAttention`` whenever autograd
    records and an input needs a gradient."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, lse = FlashAttention.apply(q, k, v, causal, scale,
                                        key_padding_mask)
        return (out, lse) if with_lse else out
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale, with_lse,
                                         key_padding_mask)
    return _launch(q, k, v, causal, scale, with_lse, key_padding_mask)


# kernel launches of each wrapper, those of them given a mask, and those
# at a head dim that is not a multiple of 64 (K5b, forward and backward)
for _wrapper in (flash_attention, flash_attention_bwd_dq,
                 flash_attention_bwd_dkv):
    _wrapper.launches = 0
    _wrapper.masked_launches = 0
    _wrapper.small_d_launches = 0
del _wrapper
