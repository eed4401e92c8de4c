"""wav2vec2-style time masking (counterpart of
ssak_tpu.augment.specaugment.mask_time_indices).

The mask is drawn from a torch.Generator on the batch's device, so it does
not reproduce jax.random's bits: tests that compare the two packages pass
one explicit mask to both, and this function is tested for its count and
span rule. Waveform augmentation (`augment/speech`, `--data_augment`) is a
later slice of the port.
"""

import torch


def mask_time_indices(gen, shape, mask_prob: float = 0.05, mask_length: int = 10):
    """bool (B, T) with max(1, int(mask_prob * T / mask_length)) span starts
    per row, each drawn uniformly from [0, max(1, T - mask_length)), and
    every frame of [start, start + mask_length) masked (HF mask_time_prob
    semantics; spans may overlap), on the generator's device."""
    B, T = shape
    device = gen.device
    n_starts = max(1, int(mask_prob * T / mask_length))
    starts = torch.randint(0, max(1, T - mask_length), (B, n_starts), generator=gen, device=device)
    pos = torch.arange(T, device=device)[None, None, :]
    spans = (pos >= starts[..., None]) & (pos < starts[..., None] + mask_length)
    return spans.any(dim=1)
