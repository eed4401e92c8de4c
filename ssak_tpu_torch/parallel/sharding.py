"""Tensor-parallel sharding rules: parameter-path regex -> PartitionSpec
(counterpart of ssak_tpu.parallel.sharding; the tables are the same).

Megatron-style TP over the 'model' mesh axis: attention q/k/v and mlp fc1
shard their output features (column parallel), attention out and mlp fc2
their input features (row parallel), the CTC head and Whisper's token
embedding their vocabulary. Paths
and specs are ssak_tpu's: '/encoder/blocks/3/attn/query/kernel', a dense
kernel laid out (in, out). `parallel.mesh.shard_params` reads a spec in
that layout and cuts the port's (out, in) weights by it; `tree_path` and
`jax_shape` give a port parameter's ssak_tpu path and shape.
"""

import re


class PartitionSpec(tuple):
    """One mesh axis name (or None) per dimension of a leaf, as jax's
    PartitionSpec: P() replicates, P(None, 'model') shards dim 1."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec

# (path_regex, spec). First match wins. Paths look like
# /encoder/blocks/3/attn/query/kernel
WHISPER_RULES = [
    (r"/(attn|cross_attn)/(query|key|value)/kernel$", P(None, "model")),
    (r"/(attn|cross_attn)/(query|key|value)/bias$", P("model")),
    (r"/(attn|cross_attn)/out/kernel$", P("model", None)),
    (r"/mlp/fc1/kernel$", P(None, "model")),
    (r"/mlp/fc1/bias$", P("model")),
    (r"/mlp/fc2/kernel$", P("model", None)),
    (r"/token_embedding$", P("model", None)),
]

WAV2VEC2_RULES = [
    (r"/attn/(query|key|value)/kernel$", P(None, "model")),
    (r"/attn/(query|key|value)/bias$", P("model")),
    (r"/attn/out/kernel$", P("model", None)),
    (r"/mlp/fc1/kernel$", P(None, "model")),
    (r"/mlp/fc1/bias$", P("model")),
    (r"/mlp/fc2/kernel$", P("model", None)),
    (r"/lm_head/kernel$", P(None, "model")),
    (r"/lm_head/bias$", P("model")),
]

# Conformer: the two macaron FFNs and the attention projections; the
# rel-pos machinery shards with the heads (linear_pos column-parallel,
# pos_bias (H, Dh) on the head dim). The conv module stays replicated.
CONFORMER_RULES = [
    (r"/attn/(query|key|value)/kernel$", P(None, "model")),
    (r"/attn/(query|key|value)/bias$", P("model")),
    (r"/attn/linear_pos/kernel$", P(None, "model")),
    (r"/attn/pos_bias_[uv]$", P("model", None)),
    (r"/attn/out/kernel$", P("model", None)),
    (r"/(ff1|ff2)/fc1/kernel$", P(None, "model")),
    (r"/(ff1|ff2)/fc1/bias$", P("model")),
    (r"/(ff1|ff2)/fc2/kernel$", P("model", None)),
    (r"/lm_head/kernel$", P(None, "model")),
    (r"/lm_head/bias$", P("model")),
]

# expert parallelism: expert-stacked MoE tensors shard their leading E dim
# on the 'expert' axis (parallel.moe). Composes with the TP rules above
# when the mesh has both axes.
WAV2VEC2_MOE_RULES = [
    (r"/moe/(w1|w2)$", P("expert", None, None)),
    (r"/moe/(b1|b2)$", P("expert", None)),
] + WAV2VEC2_RULES

# Column-parallel layers whose output leaves the parallel region: the port
# all-gathers them (the CTC head's logits, before log_softmax); every other
# column-parallel output feeds the rank's own heads or its row-parallel
# partner.
GATHERED_OUTPUTS = [r"/lm_head/kernel$"]

# Embedding tables cut along the vocabulary (P('model', None)): each rank
# holds a contiguous range of ids. A lookup gives zeros for ids outside the
# rank's range and sums the ranks' rows (parallel.collectives.
# vocab_parallel_lookup); Whisper's tied logits are the rank's slice of the
# vocabulary, all-gathered (models.whisper).
VOCAB_PARALLEL = [r"/token_embedding$"]


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh with named dims, or of such a dict."""
    if mesh is None or isinstance(mesh, dict):
        return mesh
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def partition_spec_for(path: str, shape, rules, mesh=None) -> P:
    """The PartitionSpec of a parameter at `path` with ssak_tpu-layout
    `shape` (a tuple, or anything with .shape): first matching rule, else
    replication; replication also where a sharded dim does not divide by
    its axis or the mesh (a DeviceMesh or {axis: size}) lacks the axis."""
    shape = tuple(getattr(shape, "shape", shape))
    sizes = axis_sizes(mesh)
    for pattern, spec in rules:
        if re.search(pattern, path):
            if sizes is not None and not _divisible(shape, spec, sizes):
                return P()
            return spec
    return P()


def _divisible(shape, spec, sizes) -> bool:
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        if not isinstance(axis, tuple) and axis not in sizes:
            return False  # the rule names an axis this mesh lacks
        size = sizes[axis] if not isinstance(axis, tuple) else 1
        if dim >= len(shape) or shape[dim] % size != 0:
            return False
    return True


_LEAF_NAMES = {"weight": "kernel"}


def tree_path(name: str) -> str:
    """A port parameter's name ('encoder.blocks.3.attn.query.weight') ->
    its ssak_tpu tree path ('/encoder/blocks/3/attn/query/kernel'); the
    wav2vec2 conv stack sits under 'feature_extractor/convs' there."""
    parts = name.split(".")
    parts[-1] = _LEAF_NAMES.get(parts[-1], parts[-1])
    if parts[0] == "feature_extractor":
        parts.insert(1, "convs")
    return "/" + "/".join(parts)


def jax_shape(module, leaf: str, tensor) -> tuple:
    """The ssak_tpu-layout shape of `tensor`, leaf `leaf` of `module`: a
    dense weight (out, in) is a kernel (in, out), a conv weight (Cout, Cin,
    K...) a kernel (K..., Cin, Cout); every other leaf keeps its shape."""
    shape = tuple(tensor.shape)
    if leaf != "weight":
        return shape
    if len(shape) == 2:
        return shape[::-1]
    return shape[2:] + (shape[1], shape[0])
