"""Weight-only int8 quantization (counterpart of the int8 half of
ssak_tpu.models.quant).

A quantized dense layer is a `layers.QuantLinear` holding `q8` int8
(d_in, d_out) and `scale` f32 (1, d_out): symmetric per-output-channel
scales, the same values as the numpy original bit for bit (f32 division,
round-half-to-even, clip to [-127, 127]). Quantization runs on whatever
device the weights are on. The int4 half comes with its kernel (K3).
"""

import re

import torch

DEFAULT_TARGETS = r"/kernel$"
MIN_SIZE = 64 * 64


def quantize_kernel(w, bits: int = 8):
    """w: (d_in, d_out) float tensor -> (q8 int8 (d_in, d_out) contiguous,
    scale f32 (1, d_out))."""
    if bits != 8:
        raise NotImplementedError(f"{bits}-bit quantization is not ported yet (int4 comes with its kernel)")
    w = w.to(torch.float32)
    scale = torch.amax(torch.abs(w), dim=0, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q.contiguous(), scale


def dequantize_kernel(qd, dtype=torch.bfloat16):
    """QuantLinear (or anything with q8/scale) -> dense (d_in, d_out)."""
    return (qd.q8.to(torch.float32) * qd.scale).to(dtype)


def quantize_params(module, bits: int = 8, targets: str = DEFAULT_TARGETS, min_size: int = MIN_SIZE):
    """Replace, IN PLACE, every `layers.Linear` whose ssak_tpu parameter
    path ('/decoder/blocks/0/attn/query/kernel' for the module
    'decoder.blocks.0.attn.query') matches `targets` and whose weight has at
    least `min_size` values by a QuantLinear. Returns the module."""
    from ssak_tpu_torch.models.layers import Linear, QuantLinear

    rx = re.compile(targets)
    todo = []
    for name, sub in module.named_modules():
        if isinstance(sub, Linear) and sub.weight.numel() >= min_size:
            if rx.search("/" + name.replace(".", "/") + "/kernel"):
                todo.append(name)
    for name in todo:
        parent_name, _, attr = name.rpartition(".")
        parent = module.get_submodule(parent_name) if parent_name else module
        lin = getattr(parent, attr)
        q8, scale = quantize_kernel(lin.weight.t(), bits=bits)
        setattr(parent, attr, QuantLinear(q8, scale, lin.bias))
    return module
