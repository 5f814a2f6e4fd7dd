"""Flash-attention forward (K1): a hand-written CUDA kernel for Hopper.

The counterpart of ``analytics_zoo_tpu/ops/pallas_attention.py``: exact
``softmax(scale * Q K^T) V`` on ``[B, H, L, D]``, causal mask aligned
bottom-right (offset ``lk - lq``), optional per-row logsumexp. The
kernel lives in ``csrc/flash_attn_fwd.cu`` (design notes there); it is
compiled with ``nvcc`` for ``sm_90a`` at first use into ``build/`` at the
repository root (a per-user cache for an installed package) and loaded
through ``ctypes``.

``flash_attention`` takes a CPU tensor to ``flash_attention_reference``,
the plain PyTorch version, and a CUDA tensor to the kernel; there is no
fallback between the two. ``flash_attention.launches`` counts kernel
launches.

Shapes the kernel takes: D in {64, 128}; L and Lk multiples of
``TILE`` (64); f32 or bf16; the last dimension contiguous and 16-byte
aligned rows (other strides are free, so q/k/v may be views into a fused
qkv projection). Anything else raises.
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
from typing import Optional, Tuple, Union

import numpy as np
import torch

TILE = 64
NEG_INF = -1e30

_SRC = Path(__file__).resolve().parent / "csrc" / "flash_attn_fwd.cu"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lib = None
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


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False,
                              scale: Optional[float] = None,
                              with_lse: bool = False
                              ) -> Union[torch.Tensor,
                                         Tuple[torch.Tensor, torch.Tensor]]:
    """Plain PyTorch version of the kernel: the same function, computed
    with the whole [Lq, Lk] score matrix in f32. Returns ``out`` in the
    input dtype, plus ``lse`` as ``[B*H, Lq]`` f32 when ``with_lse``."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if causal and lq > lk:
        raise ValueError("causal attention requires len(q) <= len(kv)")
    scale = _resolve_scale(scale, d)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        keep = torch.ones(lq, lk, dtype=torch.bool,
                          device=q.device).tril(lk - lq)
        s = s.masked_fill(~keep, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.matmul(torch.exp(s - lse[..., None]), v.float()).to(q.dtype)
    if with_lse:
        return out, lse.reshape(b * h, lq)
    return out


# ----------------------------------------------------------------- build --
def _nvcc() -> str:
    cand = os.environ.get("NVCC") or shutil.which("nvcc")
    if not cand:
        default = Path("/usr/local/cuda/bin/nvcc")
        cand = str(default) if default.is_file() else None
    if not cand:
        raise RuntimeError(
            "nvcc not found (set NVCC or put the CUDA toolkit on PATH): "
            "the flash-attention kernel is built from "
            f"{_SRC.name} at first use")
    return cand


def build_kernels() -> ctypes.CDLL:
    """Compile ``csrc/flash_attn_fwd.cu`` for sm_90a (once per source
    content) and load it. Raises if ``nvcc`` is missing or fails."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        nvcc = _nvcc()
        src = _SRC.read_bytes()
        tag = hashlib.sha1(src + " ".join(_NVCC_FLAGS).encode()
                           ).hexdigest()[:12]
        build_dir = _build_dir()
        build_dir.mkdir(parents=True, exist_ok=True)
        so = build_dir / f"libzoo_flash_attn_fwd_{tag}.so"
        t0 = time.perf_counter()
        if not so.is_file():
            tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
            proc = subprocess.run(
                [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {_SRC.name}:\n"
                    f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, so)
            build_info["log"] = proc.stdout + proc.stderr
        build_info["seconds"] = time.perf_counter() - t0
        build_info["path"] = str(so)
        lib = ctypes.CDLL(str(so))
        fn = lib.zoo_flash_attn_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        _lib = lib
        return lib


# ---------------------------------------------------------------- launch --
def _check_layout(name: str, t: torch.Tensor) -> None:
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: last dimension must be contiguous")
    align = 16 // t.element_size()
    if (t.data_ptr() % 16 or any(s % align for s in t.stride()[:3])):
        raise ValueError(f"{name}: rows must start on 16-byte boundaries "
                         f"(strides {tuple(t.stride())})")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, scale: Optional[float], with_lse: bool):
    lib = build_kernels()
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash kernel: q, k, v must be on one CUDA device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash kernel takes float32 or bfloat16 q/k/v, "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (b, h, lk, d) or v.shape != k.shape:
        raise ValueError(f"flash kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in (64, 128):
        raise ValueError(f"flash kernel: head_dim {d} not in (64, 128)")
    if lq % TILE or lk % TILE:
        raise ValueError(f"flash kernel: seq lens ({lq},{lk}) must be "
                         f"multiples of {TILE}")
    if causal and lq > lk:
        # rows attending to nothing are undefined under flash semantics
        raise ValueError("causal attention requires len(q) <= len(kv)")
    if b * h > 65535:
        raise ValueError(f"flash kernel: batch*heads {b * h} > 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t)
    # output [B, H, L, D] laid out as [B, L, H, D]: the caller's merge
    # of heads back into [B, L, H*D] is then a free view
    out = torch.empty(b, lq, h, d, dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = (torch.empty(b * h, lq, dtype=torch.float32, device=q.device)
           if with_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.zoo_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        _DTYPE_CODE[q.dtype], b, h, lq, lk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], _resolve_scale(scale, d), int(causal), stream)
    if rc != 0:
        raise RuntimeError(f"flash kernel launch failed: code {rc}")
    flash_attention.launches += 1
    return (out, lse) if with_lse else out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    with_lse: bool = False):
    """Flash attention on ``[B, H, L, D]``: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. Returns ``out`` (input
    dtype), plus ``lse`` ``[B*H, Lq]`` f32 when ``with_lse``."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale, with_lse)
    return _launch(q, k, v, causal, scale, with_lse)


flash_attention.launches = 0
