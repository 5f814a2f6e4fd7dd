#!/usr/bin/env python3
"""How far one bf16 train step's gradients lie from the f32 step's, for
the port's BERTSQuAD at its seeded initial weights, with the port's
``Dense`` draw (flax's ``lecun_normal``) and with a narrower one in its
place (a normal of std 1/sqrt(fan_in) truncated at +-2 std, 0.88x the
spread): the quantities ``chip_smoke.py``'s learn phases hold to
``BF16_GRAD_RATIO`` and ``BF16_GRAD_SLACK`` (||g_a - g_b|| / ||g_b||
on the layer-0 qkv weight and the head).

    python3 scripts/bf16_grad_spread.py               # on the card
    python3 scripts/bf16_grad_spread.py --reference   # on the CPU

On the card (the default): BERT-base (seq 384, batch 48, no mask) and
MiniLM-L12-H384's widths (the same batch, with and without a padding
mask), each Dense draw, with ``zoo.ops.attention_impl = flash`` and
TF32 off: the bf16 step with flash and with einsum attention against
each other and against the f32 step with einsum attention. One JSON
line a case, with the card's name and power limit.

``--reference`` (the CPU; imports JAX and the JAX package): the JAX
package's BERTForSQuAD at BERT-base's widths and flax's own initial
weights (batch 4, seq 128), its bf16 gradients against its f32 ones,
and the port's at the same weights (copied by ``bridge``) likewise.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

BERT_BASE = dict(vocab=30522, hidden_size=768, n_block=12, n_head=12,
                 intermediate_size=3072, max_position_len=512)
MINILM = dict(BERT_BASE, hidden_size=384, intermediate_size=1536)
NAMES = ("squad.bert.encoder_0.attention.qkv.weight", "squad.head.weight")


def _rel(a, b):
    return {k.split(".")[-2]: float((a[k] - b[k]).norm() / b[k].norm())
            for k in b}


def _grads(torch, module, x, y, impl):
    """{param: gradient} of one step (hidden dropout off) with ``impl``
    attention."""
    from analytics_zoo_tpu_torch.common.config import get_config
    from analytics_zoo_tpu_torch.models.text.bert_squad import (
        squad_span_loss)

    get_config().set("zoo.ops.attention_impl", impl)
    params = dict(module.named_parameters())
    module.zero_grad(set_to_none=True)
    squad_span_loss(module(x, train=False), y).backward()
    out = {k: params[k].grad.double().clone() for k in NAMES}
    module.zero_grad(set_to_none=True)
    return out


def card(torch) -> None:
    from analytics_zoo_tpu_torch.keras.layers import transformer
    from analytics_zoo_tpu_torch.models.text.bert_squad import BERTSQuAD
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    fa.build_kernels()
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 30522, (48, 384)).astype(np.int32)
    lens = rng.randint(64, 385, 48)
    mask = (np.arange(384)[None] < lens[:, None]).astype(np.int32)
    y = torch.from_numpy(np.stack([rng.randint(0, 64, 48),
                                   rng.randint(0, 64, 48)], 1)).cuda()
    port_draw = transformer.Dense.reset_parameters

    def narrow_draw(self, gen):
        port_draw(self, gen)
        std = 1.0 / self.in_features ** 0.5
        with torch.no_grad():
            torch.nn.init.trunc_normal_(self.weight, std=std, a=-2 * std,
                                        b=2 * std, generator=gen)

    cases = [("bert_base", BERT_BASE, False), ("minilm", MINILM, False),
             ("minilm", MINILM, True)]
    for draw_name, draw in (("narrow", narrow_draw), ("flax", port_draw)):
        transformer.Dense.reset_parameters = draw
        try:
            for name, base, masked in cases:
                x = {"input_ids": torch.from_numpy(ids).cuda()}
                if masked:
                    x["attention_mask"] = torch.from_numpy(mask).cuda()
                f32 = BERTSQuAD(device="cuda", seed=0, dtype="float32",
                                **base)
                ref = _grads(torch, f32.module, x, y, "einsum")
                del f32
                bf16 = BERTSQuAD(device="cuda", seed=0, dtype="bfloat16",
                                 **base)
                g_f = _grads(torch, bf16.module, x, y, "flash")
                g_e = _grads(torch, bf16.module, x, y, "einsum")
                del bf16
                torch.cuda.empty_cache()
                print(json.dumps({
                    "model": name, "masked": masked, "dense_draw": draw_name,
                    "flash_vs_einsum": _rel(g_f, g_e),
                    "flash_vs_f32": _rel(g_f, ref),
                    "einsum_vs_f32": _rel(g_e, ref), "card": card_line}),
                    flush=True)
        finally:
            transformer.Dense.reset_parameters = port_draw


def reference(torch) -> None:
    import jax
    import jax.numpy as jnp

    from analytics_zoo_tpu.models.text.bert_squad import BERTForSQuAD as J
    from analytics_zoo_tpu_torch.bridge import load_flax_into
    from analytics_zoo_tpu_torch.models.text.bert_squad import (
        BERTForSQuAD as P)

    jax.config.update("jax_platforms", "cpu")
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 30522, (4, 128)).astype(np.int32)
    y = np.stack([rng.randint(0, 128, 4), rng.randint(0, 128, 4)],
                 1).astype(np.int32)
    x = {"input_ids": jnp.asarray(ids)}
    variables = J(dtype=jnp.float32, **BERT_BASE).init(
        jax.random.PRNGKey(0), {"input_ids": jnp.asarray(ids[:1])})
    tree = jax.tree_util.tree_map(np.asarray, variables)

    def jax_grads(dtype):
        module = J(dtype=dtype, **BERT_BASE)

        def loss(p):
            s, e = module.apply({"params": p}, x, train=False)
            ls = jax.nn.log_softmax(s.astype(jnp.float32), -1)
            le = jax.nn.log_softmax(e.astype(jnp.float32), -1)
            return -(jnp.take_along_axis(ls, y[:, :1], -1)
                     + jnp.take_along_axis(le, y[:, 1:], -1)).mean() / 2

        g = jax.jit(jax.grad(loss))(variables["params"])["squad"]
        return {NAMES[0]: torch.from_numpy(np.asarray(
                    g["bert"]["encoder_0"]["attention"]["qkv"]["kernel"],
                    np.float64)).reshape(768, -1).T,
                NAMES[1]: torch.from_numpy(np.asarray(
                    g["head"]["kernel"], np.float64)).T}

    def port_grads(dtype):
        module = P(dtype=dtype, **BERT_BASE)
        load_flax_into(module, tree)
        g = _grads(torch, module, {"input_ids": torch.from_numpy(ids)},
                   torch.from_numpy(y), "einsum")
        return {k: v.reshape(v.shape[0] * v.shape[1], -1)
                if v.dim() == 3 else v for k, v in g.items()}

    jf, jb = jax_grads(jnp.float32), jax_grads(jnp.bfloat16)
    pf, pb = port_grads(None), port_grads(torch.bfloat16)
    print(json.dumps({"device": "cpu", "batch": [4, 128],
                      "jax_bf16_vs_f32": _rel(jb, jf),
                      "port_bf16_vs_f32": _rel(pb, pf),
                      "port_f32_vs_jax_f32": _rel(pf, jf)}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reference", action="store_true",
                    help="the JAX package against the port, on the CPU")
    args = ap.parse_args()
    import torch

    if args.reference:
        reference(torch)
        return
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: run with --reference on the CPU")
    card(torch)


if __name__ == "__main__":
    main()
