"""Pipeline parallelism (GPipe schedule) over a 'pipe' mesh dim
(counterpart of ssak_tpu.parallel.pipeline).

Each pipe rank keeps the L/P encoder blocks of its stage
(`shard_pp_params`). The batch is split into M microbatches; over M + P - 1
ticks every stage applies its blocks to the microbatch it holds and the
activations move one stage on with `ppermute`. The last stage's outputs are masked and summed
to every pipe rank, so what follows the pipeline (the final layer norm, the
CTC head, the loss) runs replicated. Backward runs the reverse schedule
through the collectives' transposes; activations of every microbatch in
flight stay live (GPipe's trade-off, no 1F1B).

Gradients of replicated parameters: those before the pipeline
(feature_projection, pos_conv) are used by stage 0 alone, so the pipeline's
input enters through `copy_to_region` and their gradients are summed over
'pipe'; those after it (lm_head, the final layer norm of the stable
variant) are computed on every pipe rank and are not summed. With a 'data'
dim each data rank runs its slice of the batch, and the step averages the
gradients over 'data'.

ssak_tpu stacks the blocks' parameters along a leading layer axis; the
port keeps its per-layer modules and carries the stacked layout only for
trees (`stack_blocks`, `stack_wav2vec2_params`, read back by
models.convert).
"""

import functools

import numpy as np
import torch
import torch.nn as nn

from ssak_tpu_torch.parallel.collectives import all_reduce, copy_to_region, ppermute
from ssak_tpu_torch.parallel.mesh import axis_group, data_sharding


def stack_blocks(blocks):
    """List of per-layer trees (numpy leaves) -> one tree whose leaves carry
    a leading layer axis."""
    first = blocks[0]
    if isinstance(first, dict):
        return {k: stack_blocks([b[k] for b in blocks]) for k in first}
    return np.stack([np.asarray(b) for b in blocks])


def unstack_blocks(stacked, num_layers: int = None):
    """The inverse of stack_blocks: a list of num_layers per-layer trees
    (num_layers defaults to the leaves' leading dim)."""
    if num_layers is None:
        node = stacked
        while isinstance(node, dict):
            node = next(iter(node.values()))
        num_layers = np.asarray(node).shape[0]

    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return np.asarray(node)[i]

    return [take(stacked, i) for i in range(num_layers)]


def stack_wav2vec2_params(params):
    """A wav2vec2 tree with its encoder blocks stacked (ssak_tpu's pipeline
    layout)."""
    out = dict(params)
    enc = dict(params["encoder"])
    enc["blocks"] = stack_blocks(params["encoder"]["blocks"])
    out["encoder"] = enc
    return out


def wav2vec2_block_fn(cfg):
    """One encoder layer of either variant as a stage body: fn(blk, state)
    -> state, state {"x": (B, F, D), "lengths": (B,)}."""
    from ssak_tpu_torch.models import wav2vec2 as W2V

    block = W2V.block_fn(cfg)

    def fn(blk, state):
        return {"x": block(blk, state["x"], state["lengths"], cfg), "lengths": state["lengths"]}

    return fn


def shard_pp_params(model, mesh, pipe_axis: str = "pipe"):
    """Keep this pipe rank's stage, layers [s L/P, (s+1) L/P), of the
    encoder's blocks, IN PLACE; every other parameter stays replicated.
    The stage's parameters carry `shard_group` (the pipe group) for the
    global gradient norm. Returns the model."""
    group, stage, n = axis_group(mesh, pipe_axis)
    blocks = list(model.encoder.blocks)
    if len(blocks) % n:
        raise ValueError(f"{len(blocks)} layers do not split over {pipe_axis}={n}")
    k = len(blocks) // n
    model.encoder.blocks = nn.ModuleList(blocks[stage * k : (stage + 1) * k])
    if n > 1:
        for p in model.encoder.blocks.parameters():
            p.shard_group = group
    return model


def gpipe_apply(block_fn, blocks, state, mesh, *, n_microbatches: int, pipe_axis: str = "pipe"):
    """Run `state` through the stage's `blocks` (this rank's ModuleList)
    with a GPipe schedule over the mesh's `pipe_axis`.

    block_fn(blk, state) -> state applies ONE layer; `state` is a dict of
    tensors whose leading dim is the batch (e.g. {"x": (B, T, D),
    "lengths": (B,)}); every leaf travels with its microbatch. The batch
    must divide by n_microbatches. Returns the last stage's outputs on
    every pipe rank."""
    group, idx, n_stages = axis_group(mesh, pipe_axis)
    M = n_microbatches
    if next(iter(state.values())).shape[0] % M:
        raise ValueError(f"batch does not split into {M} microbatches")
    state = {k: copy_to_region(v, group) if v.is_floating_point() else v for k, v in state.items()}
    mbs = [dict(zip(state, vals)) for vals in zip(*(v.chunk(M) for v in state.values()))]
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    def apply_local(x):
        for blk in blocks:
            x = block_fn(blk, x)
        return x

    # Every stage computes on every tick, as in ssak_tpu's scan, and picks
    # its input with a `where`: each rank then builds the same autograd
    # graph, so the ranks run their collectives' backwards in one order
    # (a ppermute whose output a rank left unused would never run its
    # backward there, and its neighbour would wait for it).
    dev = next(iter(state.values())).device
    is_first = torch.tensor(idx == 0, device=dev)
    is_last = torch.tensor(idx == n_stages - 1, device=dev)
    inflight = {k: torch.zeros_like(v) for k, v in mbs[0].items()}
    ys = []
    for t in range(M + n_stages - 1):
        inp = mbs[min(t, M - 1)]
        y = apply_local({k: torch.where(is_first, inp[k], inflight[k]) for k in inp})
        ys.append(y)
        if t < M + n_stages - 2:
            inflight = {k: ppermute(v, perm, group) for k, v in y.items()}
    # the last stage emitted microbatch m at tick m + n_stages - 1
    out = {k: torch.cat([y[k] for y in ys[n_stages - 1 :]]) for k in state}
    return {k: all_reduce(torch.where(is_last, v, torch.zeros_like(v)), group) for k, v in out.items()}


def ctc_log_probs_gpipe(model, waveform, cfg, mesh, *, lengths=None, n_microbatches: int = 2,
                        pipe_axis: str = "pipe", data_axis: str = "data", freeze_feature_encoder=False):
    """wav2vec2 CTC forward with the encoder's blocks pipelined ->
    (log_probs (B_local, F, V) f32, frame_lengths) for this rank's data
    shard of the batch (all of it without a data dim). The model holds
    this rank's stage (shard_pp_params). The conv stack, projection,
    positional conv and CTC head run outside the pipeline."""
    from ssak_tpu_torch.models import layers as L
    from ssak_tpu_torch.models import wav2vec2 as W2V

    place = data_sharding(mesh, data_axis)
    waveform = place(waveform)
    if lengths is not None:
        lengths = place(torch.as_tensor(lengths, device=waveform.device))
    x, frame_lengths = W2V.embed(model, waveform, cfg, lengths, freeze_feature_encoder=freeze_feature_encoder)
    enc = model.encoder
    if not cfg.do_stable_layer_norm:
        x = L.layer_norm(x, enc.layer_norm)
    state = gpipe_apply(wav2vec2_block_fn(cfg), enc.blocks, {"x": x, "lengths": frame_lengths}, mesh,
                        n_microbatches=n_microbatches, pipe_axis=pipe_axis)
    x = state["x"]
    if cfg.do_stable_layer_norm:
        x = L.layer_norm(x, enc.layer_norm)
    logits = L.dense(x, model.lm_head, cfg.compute_dtype)
    return torch.log_softmax(logits.to(torch.float32), dim=-1), frame_lengths


def make_pp_ctc_train_step(cfg, optimizer, mesh, *, n_microbatches: int = 2, pipe_axis: str = "pipe",
                           data_axis: str = "data", frozen_feature_encoder: bool = True):
    """CTC train step with a pipeline-parallel encoder: step(state, batch)
    -> (state, {"loss", "grad_norm"}), the state from
    train.steps.init_train_state over the rank's model (its stage). The
    batch is the global one; each data rank takes its slice. Gradients are
    averaged over 'data'; the stage's block gradients stay on their pipe
    rank, and the clip and the reported norm are over all of them
    (parallel.mesh.global_grad_norm). The loss is the mean over 'data', as
    ssak_tpu's is over the global batch (equal slices)."""
    from ssak_tpu_torch.ops.ctc_fused import ctc_loss_fast as ctc_loss
    from ssak_tpu_torch.parallel.mesh import global_grad_norm, sync_grads
    from ssak_tpu_torch.train import optim
    from ssak_tpu_torch.train.steps import _cudnn_benchmark, audio_to_f32

    place = data_sharding(mesh, data_axis)
    data_group, _, n_data = axis_group(mesh, data_axis)

    def step(state, batch):
        with _cudnn_benchmark():
            return _step(state, batch)

    def _step(state, batch):
        model = state["model"]
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        log_probs, frame_lengths = ctc_log_probs_gpipe(
            model, audio_to_f32(batch["audio"]), cfg, mesh, lengths=batch["audio_lengths"],
            n_microbatches=n_microbatches, pipe_axis=pipe_axis, data_axis=data_axis,
            freeze_feature_encoder=frozen_feature_encoder)
        loss = ctc_loss(log_probs, frame_lengths, place(batch["labels"]), place(batch["label_lengths"]),
                        blank_id=cfg.blank_id)
        loss.backward()
        grads = {}
        for name, p in params.items():
            frozen = frozen_feature_encoder and name.startswith("feature_extractor.")
            grads[name] = torch.zeros_like(p) if frozen or p.grad is None else p.grad
        sync_grads(grads, data_group)
        norm_fn = functools.partial(global_grad_norm, params=params)
        gnorm = norm_fn(grads)
        updates, state["opt_state"] = optimizer.update(grads, state["opt_state"],
                                                       {k: p.detach() for k, p in params.items()}, norm_fn)
        optim.apply_updates(params, updates)
        for p in params.values():
            p.grad = None
        state["step"] += 1
        loss = all_reduce(loss.detach(), data_group) / n_data
        return state, {"loss": loss, "grad_norm": gnorm}

    return step
