"""Weight-only int8 / int4 quantization (counterpart of
ssak_tpu.models.quant: is_quantized_kernel, quantize_kernel,
dequantize_kernel, quantize_params, dequantize_params, quantized_bytes,
partition_trainable, merge_partition).

A quantized dense layer is a `layers.QuantLinear` holding ssak_tpu's
payload, bit for bit the numpy original's (f32 division,
round-half-to-even, clip):
  - int8: `q8` int8 (d_in, d_out) and `scale` f32 (1, d_out), symmetric
    per-output-channel scales, values in [-127, 127];
  - int4: `q4` int8 (d_in/2, d_out), two rows per byte (low nibble = row
    2r, high nibble = row 2r+1), and `scale` f32 (nb, 1, d_out), one scale
    per block of d_in/nb input rows and output channel, values in [-7, 7].
The scale's rank tells the two apart. Quantization runs on whatever device
the weights are on.
"""

import copy
import re
import types

import numpy as np
import torch

DEFAULT_TARGETS = r"/kernel$"
MIN_SIZE = 64 * 64
INT4_BLOCK = 64


def is_quantized_kernel(leaf) -> bool:
    """True for a quantized kernel in either form: ssak_tpu's leaf dict
    (with q8 or q4) or the port's layers.QuantLinear."""
    from ssak_tpu_torch.models.layers import QuantLinear

    return isinstance(leaf, QuantLinear) or (isinstance(leaf, dict) and ("q8" in leaf or "q4" in leaf))


def quantize_kernel(w, bits: int = 8):
    """w: (d_in, d_out) float tensor -> (payload, scale): (q8 (d_in, d_out),
    scale (1, d_out)) for bits=8; (q4 (d_in/2, d_out), scale (nb, 1, d_out))
    for bits=4, where the block of INT4_BLOCK rows halves until it divides
    d_in, and an odd d_in falls back to int8. Payloads are int8 and
    contiguous."""
    w = w.to(torch.float32)
    d_in, d_out = w.shape
    if bits == 8:
        scale = torch.amax(torch.abs(w), dim=0, keepdim=True) / 127.0
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
        return q.contiguous(), scale
    if bits != 4:
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    b = INT4_BLOCK
    while b > 2 and d_in % b:
        b //= 2
    if d_in % b:
        return quantize_kernel(w, bits=8)  # odd d_in: int8 fallback
    nb = d_in // b
    wb = w.reshape(nb, b, d_out)
    scale = torch.amax(torch.abs(wb), dim=1, keepdim=True) / 7.0  # (nb, 1, d_out)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(wb / scale), -7, 7).to(torch.int8).reshape(d_in, d_out)
    packed = (q[0::2] & 0x0F) | (q[1::2] << 4)  # int8 arithmetic wraps as numpy's does
    return packed.contiguous(), scale


def unpack_int4(q4):
    """(d_in/2, d_out) packed nibbles -> (d_in, d_out) int32 values in
    [-8, 7], rows interleaved back (sign extension on int32, as the
    kernel does: low = (v << 28) >> 28, high = v >> 4)."""
    v = q4.to(torch.int32)
    low = torch.bitwise_right_shift(torch.bitwise_left_shift(v, 28), 28)
    high = torch.bitwise_right_shift(v, 4)
    return torch.stack([low, high], dim=1).reshape(2 * q4.shape[0], q4.shape[1])


def dequantize_int4(q4, scale, dtype=torch.bfloat16):
    """q4 (d_in/2, d_out) packed nibbles, scale (nb, 1, d_out) or
    (nb, d_out) f32 -> (d_in, d_out) in `dtype`: each value times its block
    scale in f32, rounded once."""
    q = unpack_int4(q4)
    rows, d_out = q.shape
    nb = scale.shape[0]
    w = q.reshape(nb, rows // nb, d_out).to(torch.float32) * scale.reshape(nb, 1, d_out).to(torch.float32)
    return w.reshape(rows, d_out).to(dtype)


def dequantize_kernel(qd, dtype=torch.bfloat16):
    """QuantLinear (anything with q8 or q4, and scale) -> dense (d_in, d_out)
    in `dtype`: the values times their scale in f32, then rounded once."""
    q8 = getattr(qd, "q8", None)
    if q8 is not None:
        return (q8.to(torch.float32) * qd.scale).to(dtype)
    return dequantize_int4(qd.q4, qd.scale, dtype)


def quantize_params(module, bits: int = 8, targets: str = DEFAULT_TARGETS, min_size: int = MIN_SIZE):
    """Replace, IN PLACE, every `layers.Linear` whose ssak_tpu parameter
    path ('/decoder/blocks/0/attn/query/kernel' for the module
    'decoder.blocks.0.attn.query') matches `targets` and whose weight has at
    least `min_size` values by a QuantLinear. A layer's LoRA adapter stays
    on it, float, as ssak_tpu leaves the lora leaves untouched. Returns the
    module."""
    from ssak_tpu_torch.models.layers import Linear, QuantLinear

    rx = re.compile(targets)
    todo = [name for name, sub in module.named_modules()
            if isinstance(sub, Linear) and sub.weight.numel() >= min_size
            and rx.search("/" + name.replace(".", "/") + "/kernel")]
    return _swap_layers(module, todo, lambda lin: QuantLinear(*quantize_kernel(lin.weight.t(), bits=bits), lin.bias))


def _swap_layers(module, names, make):
    """Replace, IN PLACE, each named dense layer of `module` by make(layer),
    its LoRA adapter moved onto the new layer. Returns the module."""
    for name in names:
        parent_name, _, attr = name.rpartition(".")
        parent = module.get_submodule(parent_name) if parent_name else module
        old = getattr(parent, attr)
        new = make(old)
        if old.lora_A is not None:
            new.set_lora(old.lora_A, old.lora_B, old.lora_scale)
        setattr(parent, attr, new)
    return module


def dequantize_params(params, dtype=torch.float32):
    """Fully materialize dense weights (export / debugging); the input is
    left as it is. A module comes back as a copy in which every
    QuantLinear is a layers.Linear holding its dequantized weight (out, in)
    in `dtype`, its bias and LoRA adapter kept. An ssak_tpu-layout tree
    (nested dicts, lists, tuples) comes back with every quantized leaf
    dict replaced by its dense (d_in, d_out) numpy array: bf16, which numpy
    lacks, is carried in f32."""
    from ssak_tpu_torch.models.layers import Linear, QuantLinear

    if isinstance(params, torch.nn.Module):
        module = copy.deepcopy(params)
        todo = [name for name, sub in module.named_modules() if isinstance(sub, QuantLinear)]
        return _swap_layers(module, todo, lambda ql: Linear(dequantize_kernel(ql, dtype).t().contiguous(), ql.bias))

    def rec(node):
        if is_quantized_kernel(node):
            qd = types.SimpleNamespace(**{k: torch.as_tensor(np.asarray(v)) for k, v in node.items()})
            w = dequantize_kernel(qd, dtype)
            return (w.float() if w.dtype == torch.bfloat16 else w).numpy()
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            vals = [rec(v) for v in node]
            return vals if isinstance(node, list) else tuple(vals)
        return node

    return rec(params)


def quantized_bytes(module) -> tuple:
    """(quantized bytes, the same weights' bytes in bf16) over the
    QuantLinears of `module`: an int8 value is 1 byte (2 in bf16), a packed
    int4 byte holds two weights (4 bytes in bf16)."""
    from ssak_tpu_torch.models.layers import QuantLinear

    qb = db = 0
    for sub in module.modules():
        if isinstance(sub, QuantLinear):
            n = sub.payload.numel()
            qb += n
            db += n * (2 if sub.bits == 8 else 4)
    return qb, db


def partition_trainable(module):
    """(trainable, frozen): the module's parameters and buffers split by
    name into two dicts name -> tensor. Trainable are the float parameters
    named lora_A or lora_B when any LoRA leaf exists (adapter-only
    training), otherwise every float parameter; integer payloads, scales
    and lora_scale never train. Gradients and optimizer state cover the
    trainable half only (train.steps)."""
    tensors = {**dict(module.named_buffers()), **dict(module.named_parameters())}
    has_lora = any(k.rsplit(".", 1)[-1].startswith("lora_") for k in tensors)
    params = dict(module.named_parameters())
    trainable, frozen = {}, {}
    for name, t in tensors.items():
        leaf = name.rsplit(".", 1)[-1]
        ok = name in params and t.is_floating_point() and (
            not has_lora or (leaf.startswith("lora_") and leaf != "lora_scale"))
        (trainable if ok else frozen)[name] = t
    return trainable, frozen


def merge_partition(trainable: dict, frozen: dict) -> dict:
    """Inverse of partition_trainable: one dict name -> tensor."""
    return {**frozen, **trainable}
