"""Checkpoints in ssak_tpu's format (counterpart of ssak_tpu.train.checkpoint).

A checkpoint is ckpt_dir/checkpoint-<step>/ with state.npz (the state
flattened to '/'-joined keys, with '__len__' / '__tuple__' / '__none__'
markers for sequences and None) and metadata.json ({"step", ...}).
Rotation keeps the newest `limit` checkpoints plus any kept one (the best).

The port writes `params` as ssak_tpu's wav2vec2, Conformer or Whisper tree
(dense kernels (in, out), conv kernels (K, Cin, Cout); a Whisper tree in its
parameters' own dtypes, f16 kept, with quantized kernels and LoRA leaves
where present) and `step` under the same keys, so either package reads the
other's params and step. Its optimizer state goes
under `opt_state` in the port's own layout (tensors keyed by parameter
name), marked in the metadata; it round-trips through the port only.
"""

import json
import os
import shutil

import numpy as np
import torch

OPT_STATE_FORMAT = "ssak_tpu_torch"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/{i}"))
        out[f"{prefix}/__len__"] = np.asarray(len(tree))
        if isinstance(tree, tuple):
            out[f"{prefix}/__tuple__"] = np.asarray(1)
    elif tree is None:
        out[f"{prefix}/__none__"] = np.asarray(1)
    else:
        out[prefix] = np.asarray(tree)
    return out


def _unflatten(flat):
    root = {}
    for path, val in flat.items():
        parts = [p for p in path.split("/") if p]
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def materialize(node):
        if not isinstance(node, dict):
            return node
        if "__none__" in node:
            return None
        if "__len__" in node:
            items = [materialize(node[str(i)]) for i in range(int(node["__len__"]))]
            return tuple(items) if "__tuple__" in node else items
        return {k: materialize(v) for k, v in node.items()}

    return materialize(root)


def _to_numpy(tree):
    """Tensors -> numpy (bf16 via f32); Python numbers stay numbers."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree


def opt_state_from_numpy(tree, device):
    """Inverse of the optimizer-state half of `state_to_tree`: arrays of
    rank >= 1 become tensors on `device`, 0-d arrays Python numbers."""
    if isinstance(tree, dict):
        return {k: opt_state_from_numpy(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.ndim == 0:
        return a.item()
    return torch.from_numpy(a.copy()).to(device)


def state_to_tree(state) -> dict:
    """Port train state {"model", "opt_state", "step"} -> the numpy tree a
    checkpoint stores."""
    from ssak_tpu_torch.models.convert import ctc_to_tree, whisper_to_tree
    from ssak_tpu_torch.models.whisper import WhisperModel

    model = state["model"]
    params = whisper_to_tree(model) if isinstance(model, WhisperModel) else ctc_to_tree(model)
    return {"params": params, "opt_state": _to_numpy(state["opt_state"]),
            "step": np.asarray(int(state["step"]), np.int32)}


def save_checkpoint(ckpt_dir: str, state, metadata: dict = None, save_total_limit: int = None):
    """Write a port train state {"model", "opt_state", "step"} under
    ckpt_dir/checkpoint-<step>."""
    tree = state_to_tree(state)
    step = int(tree["step"])
    path = os.path.join(ckpt_dir, f"checkpoint-{step}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "state.npz"), **_flatten(tree))
    meta = {"step": step, **(metadata or {}), "opt_state_format": OPT_STATE_FORMAT}
    with open(os.path.join(tmp, "metadata.json"), "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=1)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    if save_total_limit:
        rotate_checkpoints(ckpt_dir, save_total_limit)
    return path


def list_checkpoints(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("checkpoint-") and not name.endswith(".tmp"):
            try:
                out.append((int(name.split("-")[1]), os.path.join(ckpt_dir, name)))
            except ValueError:
                pass
    return [p for _s, p in sorted(out)]


def rotate_checkpoints(ckpt_dir: str, limit: int, keep=()):
    cks = list_checkpoints(ckpt_dir)
    for c in [c for c in cks if c not in keep][: max(0, len(cks) - limit)]:
        shutil.rmtree(c)


def get_last_checkpoint(ckpt_dir: str):
    cks = list_checkpoints(ckpt_dir)
    return cks[-1] if cks else None


def load_checkpoint(path: str):
    """Returns (state tree with numpy leaves, metadata)."""
    with np.load(os.path.join(path, "state.npz"), allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    with open(os.path.join(path, "metadata.json"), encoding="utf-8") as f:
        meta = json.load(f)
    return _unflatten(flat), meta
