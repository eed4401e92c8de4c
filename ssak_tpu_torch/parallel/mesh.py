"""Process groups, device meshes and parameter sharding (counterpart of
ssak_tpu.parallel.mesh).

The JAX package runs one program over a Mesh of devices and lets XLA
insert the collectives. The port runs one process per rank:
`init_distributed` joins them (torchrun's environment, or explicit
arguments), `make_mesh` lays the world out as a DeviceMesh with named dims
('data', 'model'; or 'data' with 'pipe', 'seq' or 'expert'), and the
parallel code takes its process groups by name (`mesh['model'].get_group()`).
`shard_params` cuts each rank's slice out of a full model IN PLACE by the
rules of parallel.sharding and marks the layers that then communicate;
layers.dense and layers.mha read those marks.
"""

import os
import re
from collections import namedtuple

import torch
import torch.distributed as dist
import torch.nn as nn

from ssak_tpu_torch.parallel.sharding import (GATHERED_OUTPUTS, VOCAB_PARALLEL, axis_sizes, jax_shape,
                                              partition_spec_for, tree_path)

# A layer's tensor parallelism: for a dense layer mode 'col' (output
# features sharded; the output stays local), 'gather' (the same, its output
# all-gathered) or 'row' (input features sharded; the f32 partial product
# all-reduced before the bias); for a module holding an embedding table
# cut along its vocabulary, 'vocab' (its `vocab_tp`); over `group`.
TensorParallel = namedtuple("TensorParallel", ["mode", "group"])


def init_distributed(coordinator_address: str = None, num_processes: int = None, process_id: int = None,
                     backend: str = None, device=None) -> torch.device:
    """Join this process to the world (jax.distributed.initialize's role)
    and return its device. Without a coordinator the world comes from
    torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT);
    with one ('host:port' or an init URL such as file:///path) from the
    arguments. device: cuda (default; raises without a card) or cpu; rank
    r takes cuda:(LOCAL_RANK % device_count) unless an index is given.
    backend None means nccl on a card and gloo on the CPU; nothing switches
    backend after a failure. An already joined process keeps its group."""
    from ssak_tpu_torch.utils.env import resolve_device
    from ssak_tpu_torch.utils.monitoring import logger

    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            local = os.environ.get("LOCAL_RANK", process_id if process_id is not None else os.environ.get("RANK", 0))
            dev = torch.device("cuda", int(local) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if coordinator_address:
        init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=init, world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(backend)
    logger.info(f"distributed: rank {dist.get_rank()}/{dist.get_world_size()} over {backend} on {dev}")
    return dev


def make_mesh(data: int = None, model: int = 1, names=("data", "model"), device_type: str = None):
    """A 2-D DeviceMesh (data x model) over the joined world, its dims named
    `names`; data defaults to world size / model. device_type: 'cuda'
    where a card is visible, else 'cpu'."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise ValueError("make_mesh needs a process group: start the ranks with torchrun, or call init_distributed")
    n = dist.get_world_size()
    if data is None:
        if n % model:
            raise ValueError(f"{n} ranks are not divisible by {names[1]}={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    device_type = device_type or ("cuda" if torch.cuda.is_available() else "cpu")
    return init_device_mesh(device_type, (data, model), mesh_dim_names=tuple(names))


def axis_group(mesh, axis: str):
    """(process group, rank in it, size) of a named mesh dim; (None, 0, 1)
    where the mesh is None or lacks it."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return None, 0, 1
    return mesh[axis].get_group(), mesh.get_local_rank(axis), mesh.size(mesh.mesh_dim_names.index(axis))


def replicate(module, mesh=None):
    """Every parameter and buffer of `module` broadcast from global rank 0,
    so all ranks hold the same weights (half tensors travel as f32). IN
    PLACE; returns the module."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return module
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            w = t.to(torch.float32) if t.is_floating_point() and t.dtype != torch.float64 else t.clone()
            w = w.contiguous()
            dist.broadcast(w, 0)
            t.copy_(w)
    return module


def _unit(modules, owner_name):
    """The layer group a parameter belongs to for tensor parallelism: its
    nearest MultiHeadAttention or MLP, else its own module."""
    from ssak_tpu_torch.models import layers as L

    parts = owner_name.split(".")
    for i in range(len(parts), 0, -1):
        name = ".".join(parts[:i])
        if isinstance(modules.get(name), (L.MultiHeadAttention, L.MLP)):
            return name
    return owner_name


def _leaf_specs(module, modules, sizes, rules):
    """(owner name, owner, leaf, ssak_tpu path, spec) of every parameter of
    `module`, the spec read on its ssak_tpu-layout shape."""
    for name, p in module.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        owner, path = modules[owner_name], tree_path(name)
        yield owner_name, owner, leaf, path, partition_spec_for(path, jax_shape(owner, leaf, p), rules, sizes)


def shardings_like(module, mesh, rules) -> dict:
    """{ssak_tpu path: PartitionSpec} of every parameter of `module` under
    `rules` on `mesh` (a DeviceMesh or {axis: size}), as ssak_tpu's
    shardings_like places leaves."""
    specs = _leaf_specs(module, dict(module.named_modules()), axis_sizes(mesh), rules)
    return {path: spec for _name, _owner, _leaf, path, spec in specs}


def _heads(num_heads, unit: str):
    """The head count of the attention `unit`: num_heads itself, or for a
    model with several (Whisper's encoder and decoder) the entry of the
    dict num_heads under the unit's top-level module name."""
    if isinstance(num_heads, dict):
        return num_heads[unit.split(".")[0]]
    return num_heads


def shard_params(module, mesh, rules, num_heads=None):
    """Cut this rank's slice of every parameter that `rules` shard on
    `mesh` out of the full `module`, IN PLACE, and mark the layers that
    then communicate. Returns the module.

    A spec is read in ssak_tpu's (in, out) layout and applied to the port's
    (out, in) dense weights: a sharded out dim makes the layer column-
    parallel ('col', or 'gather' for parallel.sharding.GATHERED_OUTPUTS),
    a sharded in dim row-parallel. An attention's heads divide over the
    axis (its tp_size is set) or the whole attention stays replicated, with
    no collective, even where its kernels' dims would divide: num_heads is
    needed for that, an int, or {top-level module name: heads} where the
    model's attentions differ (Whisper: {"encoder": n_audio_head,
    "decoder": n_text_head}). A group holding a quantized layer stays
    replicated (the rules match only float kernels and biases). An
    embedding of parallel.sharding.VOCAB_PARALLEL keeps this rank's range
    of ids (its module's `vocab_tp` is set); where the vocabulary does not
    divide, the rules keep it whole. MoE expert tensors shard their leading
    dim (the MoE's `ep` group is set)."""
    from ssak_tpu_torch.models import layers as L
    from ssak_tpu_torch.parallel.moe import MoE

    sizes = axis_sizes(mesh)
    modules = dict(module.named_modules())
    plans = [(_unit(modules, owner_name), owner, leaf, path, spec)
             for owner_name, owner, leaf, path, spec in _leaf_specs(module, modules, sizes, rules)
             if any(a is not None for a in spec)]
    drop = set()
    for unit, owner, leaf, path, spec in plans:
        u = modules[unit]
        # an embedding table's module holds the blocks around it: only its own leaf decides
        table = any(re.search(v, path) for v in VOCAB_PARALLEL)
        if isinstance(owner, L.QuantLinear) or (not table and any(isinstance(m, L.QuantLinear) for m in u.modules())):
            drop.add(unit)
        if isinstance(u, L.MultiHeadAttention):
            axis = next(a for a in spec if a is not None)
            if num_heads is None:
                raise ValueError("shard_params: sharding an attention needs num_heads")
            if _heads(num_heads, unit) % sizes[axis]:
                drop.add(unit)
    with torch.no_grad():
        for unit, owner, leaf, path, spec in plans:
            if unit in drop:
                continue
            jdim = next(i for i, a in enumerate(spec) if a is not None)
            axis = spec[jdim]
            group, rank, n = axis_group(mesh, axis)
            t = getattr(owner, leaf)
            dense_weight = isinstance(owner, L.Linear) and leaf == "weight"
            dim = (t.ndim - 1 - jdim) if dense_weight else jdim
            k = t.shape[dim] // n
            new = nn.Parameter(t.narrow(dim, rank * k, k).clone(), requires_grad=t.requires_grad)
            new.shard_group = group
            setattr(owner, leaf, new)
            u = modules[unit]
            if dense_weight:
                gathered = any(re.search(g, path) for g in GATHERED_OUTPUTS)
                owner.tp = TensorParallel("row" if dim == 1 else ("gather" if gathered else "col"), group)
            elif isinstance(owner, MoE):
                owner.ep = group
            elif any(re.search(v, path) for v in VOCAB_PARALLEL):
                owner.vocab_tp = TensorParallel("vocab", group)
            elif not (isinstance(owner, L.Linear) and leaf == "bias") and not leaf.startswith("pos_bias_"):
                raise NotImplementedError(f"{path}: no layer of the port reads this leaf sharded")
            if isinstance(u, L.MultiHeadAttention):
                u.tp_size = n
    return module


def global_grad_norm(grads: dict, params: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient entry over the whole
    model: a gradient of a parameter split over ranks (its `shard_group`,
    set by shard_params and pipeline.shard_pp_params) adds its group's sum,
    a replicated one its own once."""
    sums = {}
    for name, g in grads.items():
        grp = getattr(params[name], "shard_group", None)
        sq = torch.sum(g.to(torch.float32) ** 2)
        key = id(grp)
        sums[key] = (grp, sq if key not in sums else sums[key][1] + sq)
    total = None
    for grp, sq in sums.values():
        if grp is not None and dist.get_world_size(grp) > 1:
            sq = sq.clone()
            dist.all_reduce(sq, group=grp)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def sync_grads(grads: dict, data_group=None):
    """Average `grads` over the ranks of data_group IN PLACE (one f32
    all-reduce of all of them)."""
    n = 1 if data_group is None else dist.get_world_size(data_group)
    if n > 1:
        names = list(grads)
        flat = torch.cat([grads[k].reshape(-1).to(torch.float32) for k in names])
        dist.all_reduce(flat, group=data_group)
        flat /= n
        off = 0
        for k in names:
            g = grads[k]
            g.copy_(flat[off : off + g.numel()].view_as(g))
            off += g.numel()


def data_sharding(mesh, axis: str = "data"):
    """place(x) -> this rank's slice of x's leading (batch) dim on the
    mesh's `axis`, equal slices in rank order (ssak_tpu's P('data'))."""
    _, rank, n = axis_group(mesh, axis)

    def place(x):
        if n == 1:
            return x
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} rows does not split over {axis}={n}")
        k = x.shape[0] // n
        return x[rank * k : (rank + 1) * k]

    return place
