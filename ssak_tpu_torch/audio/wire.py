"""The int16 host->device wire format for audio (counterpart of
ssak_tpu.audio.wire — the port keeps its own copy of the host half).

File-sourced audio ships as int16 PCM sample words: exact for such audio
(scale 32768 round-trips the original words) and half the bytes of f32.
Arrays outside [-1, 1] would hard-clip, so they ship as f32 unchanged.
The f32 decode happens on the device (`to_device_f32`).
"""

import numpy as np

SCALE = 32768.0


def int16_ok(a) -> bool:
    """True when `a` is normalized audio that int16 represents without
    clipping (file-sourced audio always is). Empty arrays are fine."""
    a = np.asarray(a)
    return a.size == 0 or float(np.abs(a).max()) <= 1.0


def to_int16(a) -> np.ndarray:
    return np.rint(np.asarray(a, np.float32) * SCALE).clip(-32768, 32767).astype(np.int16)


def encode_array(x: np.ndarray) -> np.ndarray:
    """A pre-padded (B, T) float batch -> int16 wire format when safe,
    unchanged otherwise."""
    if int16_ok(x):
        return to_int16(x)
    return x


def encode_rows(rows, W: int, T: int) -> np.ndarray:
    """Pack variable-length 1-D rows into a zero-padded (W, T) matrix in
    the wire format: int16 when EVERY row is normalized, f32 otherwise."""
    if all(int16_ok(r) for r in rows):
        x = np.zeros((W, T), np.int16)
        for i, r in enumerate(rows):
            n = min(len(r), T)
            x[i, :n] = to_int16(r[:n])
    else:
        x = np.zeros((W, T), np.float32)
        for i, r in enumerate(rows):
            n = min(len(r), T)
            x[i, :n] = r[:n]
    return x


def to_device_f32(x, device):
    """Ship `x` (host wire-format array) to `device` and decode to
    normalized f32 there. Float input passes through as f32."""
    import torch

    t = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    if not t.is_floating_point():
        return t.to(torch.float32) * (1.0 / SCALE)
    return t.to(torch.float32)
