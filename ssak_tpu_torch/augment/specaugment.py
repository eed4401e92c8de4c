"""wav2vec2-style time masking and SpecAugment's time and frequency masks
(counterpart of ssak_tpu.augment.specaugment).

The masks are drawn from a torch.Generator on the batch's device, so they
do not reproduce jax.random's bits. The draws and the masking are split
(draw_masks, apply_masks): tests hold the masking to ssak_tpu's bit for
bit on jax.random's draws, and the draws to its ranges. Waveform
augmentation is `augment/speech` (`--data_augment`).
"""

import torch


def spec_augment(gen, features, n_time_masks: int = 2, time_mask_width: int = 40, n_freq_masks: int = 2,
                 freq_mask_width: int = 20, mask_value: float = 0.0):
    """features: (B, T, F). Per row, n masks along time and along
    frequency (draw_masks, time first), set to mask_value (apply_masks);
    drawn from `gen` on its device."""
    B, T, F = features.shape
    t_starts, t_widths = draw_masks(gen, B, n_time_masks, time_mask_width, T)
    f_starts, f_widths = draw_masks(gen, B, n_freq_masks, freq_mask_width, F)
    return apply_masks(features, t_starts, t_widths, f_starts, f_widths, mask_value)


def draw_masks(gen, batch: int, n_masks: int, width: int, axis_len: int):
    """(starts, widths), each int64 (batch, n_masks): starts from [0,
    max(1, axis_len - width)), then widths from [0, width], on the
    generator's device."""
    starts = torch.randint(0, max(1, axis_len - width), (batch, n_masks), generator=gen, device=gen.device)
    widths = torch.randint(0, width + 1, (batch, n_masks), generator=gen, device=gen.device)
    return starts, widths


def apply_masks(features, t_starts, t_widths, f_starts, f_widths, mask_value: float = 0.0):
    """features (B, T, F) with every frame of [start, start + width) of
    each time mask, then every bin of each frequency mask, of its row set
    to mask_value."""
    B, T, F = features.shape

    def mask_axis(starts, widths, axis_len):
        starts, widths = starts.to(features.device), widths.to(features.device)
        pos = torch.arange(axis_len, device=features.device)[None, None, :]
        return ((pos >= starts[..., None]) & (pos < (starts + widths)[..., None])).any(dim=1)

    out = torch.where(mask_axis(t_starts, t_widths, T)[:, :, None], mask_value, features)
    return torch.where(mask_axis(f_starts, f_widths, F)[:, None, :], mask_value, out)


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
