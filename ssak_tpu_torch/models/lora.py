"""LoRA adapters on the port's modules (counterpart of ssak_tpu.models.lora).

An adapter lives on a dense layer (`layers.Linear` or `layers.QuantLinear`)
as the parameters lora_A (in, r) and lora_B (r, out) and the buffer
lora_scale (alpha / r), under ssak_tpu's names: the module path
'decoder.blocks.0.attn.query' is ssak_tpu's '/decoder/blocks/0/attn/query',
whose dense dict holds the same three leaves. `layers.dense` applies it;
`partition_trainable` (models.quant) trains only the adapters when any
exists; `extract_lora` and `load_lora` carry them as numpy arrays keyed by
ssak_tpu's paths, so an adapters.npz written by either package loads into
the other.

Seeded adapters are drawn from a `torch.Generator` (normal × (1/d_in)^½
for A, zeros for B); ssak_tpu draws from jax.random.fold_in, so the two
packages' fresh A matrices differ for the same seed.
"""

import re

import numpy as np
import torch

from ssak_tpu_torch.models.layers import Linear, QuantLinear, _Dense

DEFAULT_TARGETS = r"/(attn|cross_attn)/(query|value)/kernel$"
LORA_LEAVES = ("lora_A", "lora_B", "lora_scale")


def _path(name: str) -> str:
    """A module name ('decoder.blocks.0.attn.query') as ssak_tpu's path."""
    return "/" + name.replace(".", "/") if name else ""


def _dense_layers(module):
    return [(name, sub) for name, sub in module.named_modules() if isinstance(sub, _Dense)]


def add_lora(module, rank: int = 8, alpha: float = 16.0, targets: str = DEFAULT_TARGETS, generator=None):
    """Attach adapters, IN PLACE, to every float dense layer whose path
    ('/<module path>/kernel') matches `targets`: A ~ N(0, 1/d_in) and B = 0
    in f32 on the layer's device, scale alpha / rank. Draws from
    `generator` (a CPU torch.Generator; seed 0 when None), in module
    order. Returns the module."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    rx = re.compile(targets)
    for name, sub in _dense_layers(module):
        if isinstance(sub, Linear) and rx.search(_path(name) + "/kernel"):
            d_out, d_in = sub.weight.shape
            a = torch.randn((d_in, rank), generator=gen, dtype=torch.float32) * (1.0 / max(1, d_in)) ** 0.5
            dev = sub.weight.device
            sub.set_lora(a.to(dev), torch.zeros((rank, d_out), dtype=torch.float32, device=dev), alpha / rank)
    return module


def is_lora_name(name: str) -> bool:
    """A trainable adapter leaf: lora_A or lora_B (lora_scale is fixed)."""
    leaf = name.rsplit(".", 1)[-1]
    return leaf.startswith("lora_") and leaf != "lora_scale"


def lora_grad_mask(grads: dict) -> dict:
    """Zero every gradient but the adapters' (name -> tensor dicts)."""
    return {k: g if is_lora_name(k) else torch.zeros_like(g) for k, g in grads.items()}


def merge_lora(module):
    """Fold each adapter into its layer's weight, IN PLACE, and drop it:
    W + scale · A B, formed in f32 as ssak_tpu's numpy export path does, so
    the merged weight is f32. A quantized layer's adapter cannot be folded
    into its integer payload. Returns the module."""
    for name, sub in _dense_layers(module):
        if sub.lora_A is None:
            continue
        if isinstance(sub, QuantLinear):
            raise TypeError(f"{name}: cannot merge a LoRA adapter into an int{sub.bits} kernel")
        with torch.no_grad():
            f32 = torch.float32
            delta = (sub.lora_scale.to(f32) * sub.lora_A.to(f32)) @ sub.lora_B.to(f32)
            sub.weight = torch.nn.Parameter((sub.weight.to(f32).t() + delta).t().contiguous(), requires_grad=False)
        sub.lora_A = sub.lora_B = None
        sub.lora_scale = None
    return module


def extract_lora(module) -> dict:
    """The adapter leaves only, as numpy arrays (bf16 as f32) under
    ssak_tpu's paths ('/decoder/blocks/0/attn/query/lora_A')."""
    out = {}
    for name, sub in _dense_layers(module):
        for leaf in LORA_LEAVES:
            t = getattr(sub, leaf)
            if t is not None:
                t = t.detach().cpu()
                out[f"{_path(name)}/{leaf}"] = (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()
    return out


def load_lora(module, adapters: dict):
    """Insert adapter leaves keyed by ssak_tpu's paths (extract_lora's, or
    an adapters.npz of either package) into the matching dense layers, IN
    PLACE, on each layer's device and in the arrays' dtype. Returns the
    module."""
    for name, sub in _dense_layers(module):
        p = _path(name)
        got = {leaf: adapters[f"{p}/{leaf}"] for leaf in LORA_LEAVES if f"{p}/{leaf}" in adapters}
        if not got:
            continue
        dev = next(t.device for t in (getattr(sub, "weight", None), getattr(sub, "scale", None)) if t is not None)

        def put(leaf, default):
            if leaf in got:
                return torch.from_numpy(np.array(got[leaf], copy=True)).to(dev)
            return default

        a, b = put("lora_A", sub.lora_A), put("lora_B", sub.lora_B)
        scale = put("lora_scale", sub.lora_scale if sub.lora_scale is not None else 1.0)
        if a is None or b is None:
            raise ValueError(f"{p}: an adapter needs both lora_A and lora_B")
        sub.set_lora(a, b, scale)
    return module
