"""Rank bodies of tests/test_torch_parallel_dist.py (no tests of its own): each runs in a process
of its own, spawned by that test module, joined over gloo on the CPU by a
file rendezvous. Imports torch and ssak_tpu_torch only, never JAX: the
test process computes the JAX references and passes weights and inputs
here as numpy (a pickle it wrote), and reads back what each rank returns.
"""

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist


def run(rank, world, init_file, task, inp_path, out_dir):
    """Join the world, run TASKS[task](rank, world, inp) and pickle its
    result to out_dir/rank<r>.pkl."""
    from ssak_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    init_distributed(f"file://{init_file}", world, rank, backend="gloo", device="cpu")
    try:
        with open(inp_path, "rb") as f:
            inp = pickle.load(f)
        res = TASKS[task](rank, world, inp)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _np(t):
    return t.detach().to(torch.float32).cpu().numpy()


def _w2v(tree, cfg_kw):
    from ssak_tpu_torch.models import wav2vec2 as W2V
    from ssak_tpu_torch.models.convert import wav2vec2_from_tree

    return wav2vec2_from_tree(tree), W2V.Wav2Vec2Config(**cfg_kw)


def _loaded(tree, cfg):
    from ssak_tpu_torch.infer.general import from_tree

    return from_tree(tree, cfg, device="cpu")


def _tp_log_probs(item, mesh):
    """Log-probs of a model sharded by shard_model over the mesh's 'model' dim."""
    from ssak_tpu_torch.infer.general import compute_log_probas, shard_model
    from ssak_tpu_torch.models import conformer as C
    from ssak_tpu_torch.models import wav2vec2 as W2V

    cfg_cls = C.ConformerConfig if item["family"] == "conformer" else W2V.Wav2Vec2Config
    m = _loaded(item["tree"], cfg_cls(**item["cfg"]))
    shard_model(m, mesh=mesh)
    lp, fl = compute_log_probas(m, item["audio"], item["lengths"])
    attn = m.module.blocks[0].attn if item["family"] == "conformer" else m.module.encoder.blocks[0].attn
    tp = {name: getattr(getattr(mod, "tp", None), "mode", None) for name, mod in m.module.named_modules()
          if hasattr(mod, "tp") and mod.tp is not None}
    shards = {name: _np(p) for name, p in m.module.named_parameters() if hasattr(p, "shard_group")}
    return {"lp": _np(lp), "fl": fl.numpy(), "tp_size": attn.tp_size, "modes": tp, "shards": shards,
            "model_rank": mesh.get_local_rank("model")}


def task_main(rank, world, inp):
    """The world of 4: tensor parallelism at tp 4 (mesh 1 x 4) and tp 2
    (mesh 2 x 2), CTC models and Whisper's decode, GPipe forward at (2, 2)
    and (1, 4), GPipe gradients at (2, 2), the PP step over 8 steps at (2,
    2), sequence parallelism at (2, 2) and (1, 4), expert-sharded MoE at
    (1, 4), MoE CTC training at (data 2, expert 2)."""
    from ssak_tpu_torch.parallel.mesh import make_mesh

    out = {}
    mesh14 = make_mesh(model=4, device_type="cpu")
    mesh22 = make_mesh(data=2, model=2, device_type="cpu")
    for name, item in inp["tp"].items():
        out[f"tp4/{name}"] = _tp_log_probs(item, mesh14)
        out[f"tp2/{name}"] = _tp_log_probs(item, mesh22)
    for tp, mesh in ((4, mesh14), (2, mesh22)):
        out[f"tp{tp}/whisper"] = _whisper_tp(inp["whisper"], mesh)
    out.update(_gpipe(inp["gpipe"]))
    out.update(_sp(inp["sp"]))
    out.update(_moe(inp["moe"]))
    return out


def whisper_model(item, bits=0):
    """The f32 Whisper of item["tree"] on the CPU, quantized to `bits` (8
    or 4) with int8 K/V caches as load_model quantizes."""
    import dataclasses

    from ssak_tpu_torch.infer.general import from_tree
    from ssak_tpu_torch.models import whisper as W
    from ssak_tpu_torch.models.quant import quantize_params

    cfg = W.WhisperConfig(**item["cfg"])
    if bits:
        cfg = dataclasses.replace(cfg, kv_int8=True)
    m = from_tree(item["tree"], cfg, device="cpu")
    if bits:
        quantize_params(m.module, bits=bits)
    return m


class StepLogits:
    """Records the logits of every cached decoder step (models.whisper._step)
    while installed."""

    def __init__(self):
        from ssak_tpu_torch.models import whisper as W

        self.W, self.orig, self.logits = W, W._step, []

    def __enter__(self):
        def step(*a, **kw):
            logits, caches = self.orig(*a, **kw)
            self.logits.append(_np(logits))
            return logits, caches

        self.W._step = step
        return self

    def __exit__(self, *exc):
        self.W._step = self.orig


# The temperature chain of the fallback and long-form runs: T = 0, then two sampled retries (every collective
# of a decode step waits for all the ranks, so the spawned ranks run few steps)
TEMPERATURES = (0.0, 0.5, 1.0)


def whisper_decode_runs(m, item):
    """Every Whisper decode loop of the port on `m` (sharded or not) over
    item's inputs: teacher-forced logits, greedy (tokens and each step's
    logits), beam 5, sampling best_of 3 at T = 0.6, transcribe_with_fallback
    (beam 5, then best_of 3 at each of TEMPERATURES: logprob_threshold 0
    sends every row through the whole chain), and the long-form seek loop
    with timestamps, at T = 0 alone and through the chain with best_of 3."""
    from ssak_tpu_torch.infer.whisper_infer import transcribe_longform_batch, transcribe_with_fallback
    from ssak_tpu_torch.models import whisper as W

    cfg, mod = m.cfg, m.module
    mel = torch.tensor(item["mel"])
    prompt, n = item["prompt"], item["max_tokens"]
    out = {}
    with torch.no_grad():
        out["decode_train"] = _np(W.decode_train(mod, torch.tensor(item["tokens"]), W.encode(mod, mel, cfg), cfg))
    with StepLogits() as rec:
        tokens, lengths = W.greedy_decode(mod, mel, cfg, prompt, max_tokens=n)
    out["greedy"] = {"tokens": tokens.numpy(), "lengths": lengths.numpy(), "step_logits": rec.logits}
    tokens, lengths, scores = W.beam_decode(mod, mel, cfg, prompt, beam_size=5, max_tokens=n)
    out["beam"] = {"tokens": tokens.numpy(), "lengths": lengths.numpy(), "scores": scores.numpy()}
    with StepLogits() as rec:
        tokens, lengths, acc = W.sample_decode(mod, mel, cfg, prompt, seed=3, temperature=0.6, max_tokens=n, best_of=3)
    out["sample"] = {"tokens": tokens.numpy(), "lengths": lengths.numpy(), "sum_logprob": acc.numpy(),
                     "step_logits": rec.logits}
    out["fallback"] = transcribe_with_fallback(m, mel, prompt, max_tokens=n, beam_size=5, best_of=3,
                                               temperatures=TEMPERATURES, logprob_threshold=0.0)
    audios = [np.asarray(a, np.float32) for a in item["long_audio"]]
    with StepLogits() as rec:
        out["longform_t0"] = transcribe_longform_batch(m, audios, temperatures=(0.0,), max_tokens=item["lf_tokens"])
    out["longform_t0_step_logits"] = rec.logits
    out["longform"] = transcribe_longform_batch(m, audios, best_of=3, temperatures=TEMPERATURES,
                                                logprob_threshold=0.0, max_tokens=item["lf_tokens"])
    return out


def _tp_marks(module):
    """What shard_params cut and marked: each cut parameter's slice, each
    dense layer's mode, each attention's tp_size, the embedding's mark."""
    from ssak_tpu_torch.models import layers as L

    return {"shards": {name: _np(p) for name, p in module.named_parameters() if hasattr(p, "shard_group")},
            "modes": {name: mod.tp.mode for name, mod in module.named_modules()
                      if isinstance(mod, L._Dense) and mod.tp is not None},
            "tp_size": {name: mod.tp_size for name, mod in module.named_modules()
                        if isinstance(mod, L.MultiHeadAttention)},
            "vocab_tp": getattr(module.decoder.vocab_tp, "mode", None)}


def _whisper_tp(item, mesh):
    """The tiny f32 Whisper sharded by shard_model over the mesh's 'model'
    dim: its marks and every decode loop (whisper_decode_runs)."""
    from ssak_tpu_torch.infer.general import shard_model

    m = whisper_model(item)
    shard_model(m, mesh=mesh)
    return {**_tp_marks(m.module), **whisper_decode_runs(m, item), "model_rank": mesh.get_local_rank("model")}


def _whisper_quantized_tp(item):
    """The tiny Whisper quantized to int8 and int4 (int8 K/V caches),
    unsharded and sharded at tp 2: the marks, the teacher-forced logits and
    greedy's tokens and step logits of both."""
    from ssak_tpu_torch.infer.general import shard_model
    from ssak_tpu_torch.models import whisper as W
    from ssak_tpu_torch.parallel.mesh import make_mesh

    mel = torch.tensor(item["mel"])
    out = {}
    for bits in (8, 4):
        res = {}
        for tag in ("dense", "tp2"):
            m = whisper_model(item, bits)
            if tag == "tp2":
                shard_model(m, mesh=make_mesh(model=2, device_type="cpu"))
                res.update(_tp_marks(m.module))
            cfg, mod = m.cfg, m.module
            with torch.no_grad():
                train = W.decode_train(mod, torch.tensor(item["tokens"]), W.encode(mod, mel, cfg), cfg)
            with StepLogits() as rec:
                tokens, _ = W.greedy_decode(mod, mel, cfg, item["prompt"], max_tokens=item["max_tokens"])
            res[tag] = {"decode_train": _np(train), "tokens": tokens.numpy(), "step_logits": rec.logits}
        out[f"int{bits}"] = res
    return out


def _gpipe(inp):
    from ssak_tpu_torch.models import wav2vec2 as W2V
    from ssak_tpu_torch.models.convert import wav2vec2_from_tree
    from ssak_tpu_torch.ops.ctc_fused import ctc_loss_fast
    from ssak_tpu_torch.parallel.mesh import axis_group, data_sharding, make_mesh, sync_grads
    from ssak_tpu_torch.parallel.pipeline import ctc_log_probs_gpipe, make_pp_ctc_train_step, shard_pp_params
    from ssak_tpu_torch.train.steps import init_train_state, make_optimizer

    out = {}
    for shape in ((2, 2), (1, 4)):
        mesh = make_mesh(data=shape[0], model=shape[1], names=("data", "pipe"), device_type="cpu")
        for variant, item in inp["fwd"].items():
            model, cfg = _w2v(item["tree"], item["cfg"])
            shard_pp_params(model, mesh)
            with torch.no_grad():
                lp, fl = ctc_log_probs_gpipe(model, torch.tensor(item["audio"]), cfg, mesh,
                                             lengths=torch.tensor(item["lengths"]), n_microbatches=2)
            out[f"gpipe{shape}/{variant}"] = {"lp": _np(lp), "fl": fl.numpy(), "rows": _rows(mesh, len(item["audio"]))}
    mesh = make_mesh(data=2, model=2, names=("data", "pipe"), device_type="cpu")
    g = inp["grads"]
    model, cfg = _w2v(g["tree"], g["cfg"])
    shard_pp_params(model, mesh)
    model.requires_grad_(True)
    b = {k: torch.tensor(v) for k, v in g["batch"].items()}
    place = data_sharding(mesh)
    lp, fl = ctc_log_probs_gpipe(model, b["audio"], cfg, mesh, lengths=b["audio_lengths"], n_microbatches=2)
    loss = ctc_loss_fast(lp, fl, place(b["labels"]), place(b["label_lengths"]), blank_id=cfg.blank_id)
    loss.backward()
    params = dict(model.named_parameters())
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p) for k, p in params.items()}
    data_group = axis_group(mesh, "data")[0]
    sync_grads(grads, data_group)
    loss = loss.detach().clone()
    dist.all_reduce(loss, group=data_group)
    _, stage, _ = axis_group(mesh, "pipe")
    out["gpipe_grads"] = {"loss": float(loss) / 2, "stage": stage, "grads": {k: _np(v) for k, v in grads.items()}}
    s = inp["step"]
    cfg = W2V.Wav2Vec2Config(**s["cfg"])
    model = wav2vec2_from_tree(s["tree"])
    shard_pp_params(model, mesh)
    opt = make_optimizer(learning_rate=3e-3, warmup_steps=1, total_steps=30)
    state = init_train_state(model, opt)
    step = make_pp_ctc_train_step(cfg, opt, mesh, n_microbatches=2)
    batch = {k: torch.tensor(v) for k, v in s["batch"].items()}
    losses, norms = [], []
    for _ in range(8):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out["pp_step"] = {"losses": losses, "grad_norms": norms}
    return out


def _rows(mesh, batch):
    """The global rows this rank's data shard holds."""
    from ssak_tpu_torch.parallel.mesh import axis_group

    _, r, n = axis_group(mesh, "data")
    k = batch // n
    return list(range(r * k, (r + 1) * k))


def _sp(inp):
    from ssak_tpu_torch.models import wav2vec2 as W2V
    from ssak_tpu_torch.parallel.mesh import make_mesh
    from ssak_tpu_torch.parallel.sequence import ctc_log_probs_sp

    out = {}
    for shape in ((2, 2), (1, 4)):
        mesh = make_mesh(data=shape[0], model=shape[1], names=("data", "seq"), device_type="cpu")
        for variant, item in inp.items():
            model, cfg = _w2v(item["tree"], item["cfg"])
            with torch.no_grad():
                lp, fl = ctc_log_probs_sp(model, torch.tensor(item["audio"]), cfg, mesh,
                                          lengths=torch.tensor(item["lengths"]), data_axis="data")
            rows = _rows(mesh, len(item["audio"]))
            out[f"sp{shape}/{variant}"] = {"lp": _np(lp), "fl": fl.numpy(), "rows": rows}
            if variant == "adapter":
                with torch.no_grad():
                    lp, fl = W2V.ctc_log_probs(model, torch.tensor(item["audio"][rows]), cfg,
                                               torch.tensor(item["lengths"][rows]))
                out[f"sp{shape}/adapter_dense"] = {"lp": _np(lp), "fl": fl.numpy(), "rows": rows}
    return out


def _moe(inp):
    import torch.nn as nn

    from ssak_tpu_torch.models import layers as L
    from ssak_tpu_torch.models import wav2vec2 as W2V
    from ssak_tpu_torch.models.convert import wav2vec2_from_tree, wav2vec2_to_tree
    from ssak_tpu_torch.parallel.mesh import axis_group, data_sharding, make_mesh, shard_params
    from ssak_tpu_torch.parallel.moe import MoE, moe_mlp
    from ssak_tpu_torch.parallel.sharding import WAV2VEC2_MOE_RULES
    from ssak_tpu_torch.train.steps import init_train_state, make_ctc_train_step, make_optimizer, shard_train_step

    out = {}
    e = inp["ep"]
    p = e["params"]

    def layer():
        holder = nn.Module()
        holder.moe = MoE(L.Linear(torch.tensor(p["gate"]["kernel"].T.copy())),
                         *(torch.tensor(p[k]) for k in ("w1", "b1", "w2", "b2")))
        return holder

    x = torch.tensor(e["x"])
    y1, a1 = moe_mlp(x, layer().moe, top_k=2, dtype=torch.float32)
    mesh = make_mesh(data=1, model=4, names=("data", "expert"), device_type="cpu")
    h = shard_params(layer(), mesh, WAV2VEC2_MOE_RULES)
    y4, a4 = moe_mlp(x, h.moe, top_k=2, dtype=torch.float32)
    out["moe_ep"] = {"y1": _np(y1), "aux1": float(a1), "y4": _np(y4), "aux4": float(a4),
                     "local_experts": int(h.moe.w1.shape[0])}

    # data-parallel routing: each data rank's rows of x, routed over the global batch
    for shape in ((2, 2), (4, 1)):
        mesh = make_mesh(data=shape[0], model=shape[1], names=("data", "expert"), device_type="cpu")
        h = shard_params(layer(), mesh, WAV2VEC2_MOE_RULES)
        group = axis_group(mesh, "data")[0]
        for cf in e["capacity_factors"]:
            y, aux = moe_mlp(data_sharding(mesh)(x), h.moe, top_k=2, capacity_factor=cf, dtype=torch.float32,
                             data_group=group)
            out[f"moe_dp{shape}/{cf}"] = {"y": _np(y), "aux": float(aux), "rows": _rows(mesh, len(x))}

    t = inp["train"]
    cfg = W2V.Wav2Vec2Config(**t["cfg"])
    mesh = make_mesh(data=2, model=2, names=("data", "expert"), device_type="cpu")
    model = shard_params(wav2vec2_from_tree(t["tree"]), mesh, WAV2VEC2_MOE_RULES, num_heads=cfg.num_heads)
    opt = make_optimizer(**t["opt"])
    state = init_train_state(model, opt)
    step = shard_train_step(make_ctc_train_step(cfg, opt, moe_aux_weight=t["moe_aux_weight"]), mesh)
    batch = {k: torch.tensor(v) for k, v in t["batch"].items()}
    losses, norms, tree = [], [], None
    for i in range(t["steps"]):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if i + 1 == t["compare_after"]:
            tree = wav2vec2_to_tree(model)
    out["moe_train"] = {"losses": losses, "grad_norms": norms, "tree": tree,
                        "local_experts": int(model.encoder.blocks[0].moe.w1.shape[0]),
                        "expert_rank": axis_group(mesh, "expert")[1]}
    return out


def task_pair(rank, world, inp):
    """The world of 2: ctc_infer --tensor_parallel 2 on the seeded tiny
    wav2vec2 and whisper_infer --tensor_parallel 2 on the seeded tiny
    Whisper, the quantized Whisper at tp 2, shard_train_step over 2 data
    ranks, the tarred interleave and a cross-process all-reduce, and
    replicate."""
    from ssak_tpu_torch.infer.ctc_infer import ctc_infer
    from ssak_tpu_torch.models import wav2vec2 as W2V
    from ssak_tpu_torch.models.convert import wav2vec2_from_tree, wav2vec2_to_tree
    from ssak_tpu_torch.parallel.mesh import make_mesh
    from ssak_tpu_torch.train.steps import init_train_state, make_ctc_train_step, make_optimizer, shard_train_step

    from ssak_tpu_torch.infer.whisper_infer import whisper_infer

    out = {"texts": list(ctc_infer(None, inp["files"], seeded_test_config="wav2vec2", tensor_parallel=2,
                                   device="cpu", output_ids=True))}
    out["whisper_texts"] = {bits: list(whisper_infer(None, inp["files"], seeded_test_config="whisper", tensor_parallel=2,
                                                     quantize_bits=bits, device="cpu", output_ids=True,
                                                     max_tokens=inp["whisper_max_tokens"])) for bits in (0, 8)}
    out["whisper_quantized"] = _whisper_quantized_tp(inp["whisper"])
    d = inp["dp"]
    cfg = W2V.Wav2Vec2Config(**d["cfg"])
    model = wav2vec2_from_tree(d["tree"])
    opt = make_optimizer(**d["opt"])
    state = init_train_state(model, opt)
    step = shard_train_step(make_ctc_train_step(cfg, opt), make_mesh(data=2, model=1, device_type="cpu"))
    batch = {k: torch.tensor(v) for k, v in d["batch"].items()}
    losses, norms = [], []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out["dp"] = {"losses": losses, "grad_norms": norms, "tree": wav2vec2_to_tree(model)}

    from ssak_tpu_torch.data.tarred import iterate_tarred_dataset

    ids, total = [], 0.0
    for x, lens, rows in iterate_tarred_dataset(inp["tarred"], batch_size=2, process_index=rank, process_count=world):
        ids.extend(r["id"] for r in rows if r)
        total += float(np.abs(np.asarray(x)).sum())
    s = torch.tensor([total], dtype=torch.float64)
    dist.all_reduce(s)
    out["tarred"] = {"ids": ids, "local_stat": total, "global_sum": float(s[0])}

    from ssak_tpu_torch.parallel.mesh import replicate

    model = wav2vec2_from_tree(d["tree"])  # every rank its own weights, then rank 0's everywhere
    with torch.no_grad():
        for p in model.parameters():
            p.add_(rank)
    replicate(model)
    out["replicated"] = wav2vec2_to_tree(model)
    return out


TASKS = {"main": task_main, "pair": task_pair}
