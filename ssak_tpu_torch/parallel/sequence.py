"""Sequence (context) parallelism over a 'seq' mesh dim (counterpart of
ssak_tpu.parallel.sequence).

The encoder's time axis is split over the ranks of 'seq': layer norms,
MLPs and the Q/K/V projections are local; each attention all-gathers K and
V over 'seq' (in rank order, i.e. time order) while the queries stay
local, so every rank computes its F/P query rows against all the keys and
the (B, H, F/P, F) scores never gather on one rank. The unfused
`layers.attention` runs, as in ssak_tpu, at any length; the key mask
counts from the gathered keys, the padded tail included. Composes with
data parallelism on the batch dim through a ('data', 'seq') mesh.
"""

import torch
import torch.nn.functional as F

from ssak_tpu_torch.models import layers as L
from ssak_tpu_torch.parallel.collectives import all_gather, copy_to_region
from ssak_tpu_torch.parallel.mesh import axis_group, data_sharding


def _pad_to_multiple(x, multiple: int, axis: int):
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - axis - 1) + [0, pad]
    return F.pad(x, widths)


def sp_self_attention(x, attn, n_heads: int, lengths, group, dtype):
    """Self-attention of a rank's time slice x (B, F_local, D): K and V
    all-gathered over `group` (the 'seq' ranks), the queries local."""
    q = L.split_heads(L.dense(x, attn.query, dtype), n_heads)
    k = L.split_heads(L.dense(x, attn.key, dtype), n_heads)
    v = L.split_heads(L.dense(x, attn.value, dtype), n_heads)
    k = all_gather(k, 1, group)
    v = all_gather(v, 1, group)
    mask = (torch.arange(k.shape[1], device=x.device)[None, :] < lengths[:, None])[:, None, None, :]
    y = L.attention(q, k, v, mask=mask, dtype=dtype)
    return L.dense(L.merge_heads(y), attn.out, dtype)


def encode_sp(model, waveform, cfg, mesh, *, lengths=None, seq_axis: str = "seq", data_axis: str = None):
    """wav2vec2 encoder with the transformer stack time-sharded ->
    (hidden (B, F, D), frame_lengths), like models.wav2vec2.encode: its
    blocks (wav2vec2.block_fn) with sp_self_attention in place of the
    attention. The conv stack, projection and positional conv run
    replicated before the split (they are local in time). With data_axis,
    the rows are this rank's data shard. An MMS adapter runs as in encode
    (ssak_tpu's encode_sp leaves it out)."""
    from ssak_tpu_torch.models import wav2vec2 as W2V

    if cfg.num_experts:
        raise ValueError("encode_sp: an MoE layer routes over all of a batch's frames; its blocks are not "
                         "time-sharded (nor are they in ssak_tpu)")
    if data_axis is not None:
        place = data_sharding(mesh, data_axis)
        waveform = place(waveform)
        lengths = None if lengths is None else place(torch.as_tensor(lengths, device=waveform.device))
    x, frame_lengths = W2V.embed(model, waveform, cfg, lengths)
    group, rank, n = axis_group(mesh, seq_axis)
    Fr = x.shape[1]
    x = copy_to_region(_pad_to_multiple(x, n, 1), group)
    x = x.chunk(n, dim=1)[rank]

    def attend(blk, h, fl, cfg):
        return sp_self_attention(h, blk.attn, cfg.num_heads, fl, group, cfg.compute_dtype)

    enc = model.encoder
    block = W2V.block_fn(cfg)
    if not cfg.do_stable_layer_norm:
        x = L.layer_norm(x, enc.layer_norm)
    for blk in enc.blocks:
        x = block(blk, x, frame_lengths, cfg, attend=attend)
    if cfg.do_stable_layer_norm:
        x = L.layer_norm(x, enc.layer_norm)
    return all_gather(x, 1, group, replicated=True)[:, :Fr], frame_lengths


def ctc_log_probs_sp(model, waveform, cfg, mesh, *, lengths=None, seq_axis: str = "seq", data_axis: str = None):
    """Sequence-parallel CTC forward (the long-context serving path) ->
    (log_probs (B, F, V) f32, frame_lengths)."""
    hidden, frame_lengths = encode_sp(model, waveform, cfg, mesh, lengths=lengths, seq_axis=seq_axis,
                                      data_axis=data_axis)
    logits = L.dense(hidden, model.lm_head, cfg.compute_dtype)
    return torch.log_softmax(logits.to(torch.float32), dim=-1), frame_lengths
