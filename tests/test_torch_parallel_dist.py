"""parallel/ over real ranks: gloo processes on the CPU (spawned, a file
rendezvous under tmp_path, a timeout on every join so a hung collective
fails) against ssak_tpu's sharded programs on its 8 CPU devices.

One world of 4 ranks runs tensor parallelism (shard_model at tp 4 and tp
2, heads that do not divide; Whisper's decode loops on the ranks' heads
with its vocabulary cut at tp 2 and whole at tp 4), GPipe (forward at
(data 2, pipe 2) and (1, 4), gradients, the PP step), sequence
parallelism and the MoE (expert-sharded, and CTC training on (data 2,
expert 2)); one world of 2 runs ctc_infer and whisper_infer
--tensor_parallel 2, the quantized Whisper at tp 2, shard_train_step and
the tarred interleave. The JAX references are computed here and the
weights passed to the ranks as numpy; the ranks never import JAX
(tests/test_torch_parallel_ranks.py)."""

import dataclasses
import multiprocessing as mp
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ssak_tpu.models import conformer as JC
from ssak_tpu.models import wav2vec2 as JW
from ssak_tpu.models import whisper as JWh
from ssak_tpu.parallel.sharding import WAV2VEC2_MOE_RULES, WAV2VEC2_RULES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def spawn(task, world, inp, tmp, timeout=300):
    """TASKS[task] on `world` spawned gloo ranks; their results in rank order."""
    import test_torch_parallel_ranks

    tmp.mkdir(parents=True, exist_ok=True)
    inp_path = str(tmp / "inp.pkl")
    with open(inp_path, "wb") as f:
        pickle.dump(inp, f)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=test_torch_parallel_ranks.run,
                         args=(r, world, str(tmp / "rdv"), task, inp_path, str(tmp))) for r in range(world)]
    env = {"OMP_NUM_THREADS": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        for p in procs:
            p.start()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    try:
        for p in procs:
            p.join(timeout=timeout)
            assert not p.is_alive(), f"rank of {task!r} still running after {timeout} s (a hung collective?)"
            assert p.exitcode == 0, f"rank of {task!r} exited with {p.exitcode}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32) if np.asarray(a).dtype != np.int32 else np.asarray(a), tree)


def _w2v_cfg(**kw):
    base = dict(conv_dim=(16, 16), conv_kernel=(10, 8), conv_stride=(5, 4), hidden_size=32, num_layers=2, num_heads=4,
                intermediate_size=64, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=2, vocab_size=16,
                dtype="float32")
    base.update(kw)
    return JW.Wav2Vec2Config(**base)


def _mesh(names, shape):
    return Mesh(np.asarray(jax.devices()[: shape[0] * shape[1]]).reshape(shape), names)


def _audio(seed, B, T, lengths):
    rng = np.random.RandomState(seed)
    return rng.randn(B, T).astype(np.float32) * 0.1, np.asarray(lengths, np.int32)


def _tree(cfg, seed, family=JW):
    """A seeded parameter tree of the JAX config `cfg`, drawn by the port
    (torch's generator is quicker than JAX's eager initializers) and read
    by both packages."""
    from ssak_tpu_torch.models import conformer as TC
    from ssak_tpu_torch.models import wav2vec2 as TW
    from ssak_tpu_torch.models.convert import conformer_to_tree, wav2vec2_to_tree

    if family is JC:
        return conformer_to_tree(TC.init_params(TC.ConformerConfig(**dataclasses.asdict(cfg)), seed=seed))
    return wav2vec2_to_tree(TW.init_params(TW.Wav2Vec2Config(**dataclasses.asdict(cfg)), seed=seed))


def _valid(lp, fl):
    return np.arange(lp.shape[1])[None, :] < np.asarray(fl)[:, None]


# --- inputs and JAX references -----------------------------------------------------------


def _tp_items():
    items = {}
    audio, lengths = _audio(0, 2, 1600, [1600, 1100])
    for name, kw in (("w2v_post", {}), ("w2v_stable", dict(do_stable_layer_norm=True, conv_bias=True)),
                     ("w2v_heads2", dict(num_heads=2))):
        cfg = _w2v_cfg(**kw)
        params = _tree(cfg, len(items))
        items[name] = dict(family="wav2vec2", cfg=dataclasses.asdict(cfg), tree=params, audio=audio,
                           lengths=lengths, jcfg=cfg, params=params)
    cfg = JC.make_config("tiny_test", num_heads=4, pos_type="relpos", dtype="float32", vocab_size=32)
    params = _tree(cfg, 7, JC)
    rng = np.random.RandomState(7)
    for b in params["blocks"]:
        for k in ("pos_bias_u", "pos_bias_v"):
            b["attn"][k] = rng.randn(*b["attn"][k].shape).astype(np.float32) * 0.1
    audio_c, lengths_c = _audio(1, 2, 8000, [8000, 5600])
    items["conformer"] = dict(family="conformer", cfg=dataclasses.asdict(cfg), tree=params, audio=audio_c,
                              lengths=lengths_c, jcfg=cfg, params=params)
    return items


def _jax_tp_refs(items):
    """ssak_tpu's log-probs unsharded and under its shard_model at tp 4."""
    from ssak_tpu.infer.general import LoadedModel, ModelType, shard_model

    refs = {}
    for name, it in items.items():
        fam = JC if it["family"] == "conformer" else JW
        fn = jax.jit(lambda p, a, l, fam=fam, cfg=it["jcfg"]: fam.ctc_log_probs(p, a, cfg, l))
        refs[name] = {"dense": np.asarray(fn(it["params"], jnp.asarray(it["audio"]), jnp.asarray(it["lengths"]))[0])}
        mtype = ModelType.CONFORMER_CTC if it["family"] == "conformer" else ModelType.WAV2VEC2_CTC
        for tp in (4,):
            m = shard_model(LoadedModel(mtype, it["params"], it["jcfg"], None), model_axis=tp)
            with m.mesh:
                refs[name][tp] = np.asarray(fn(m.params, jnp.asarray(it["audio"]), jnp.asarray(it["lengths"]))[0])
    return refs


def _gpipe_inputs():
    from ssak_tpu.parallel.pipeline import ctc_log_probs_gpipe, shard_pp_params, stack_wav2vec2_params

    fwd, refs = {}, {}
    audio, lengths = _audio(0, 8, 1600, [1600, 1600, 1200, 800, 1600, 1000, 600, 1600])
    for variant, stable in (("post", False), ("stable", True)):
        cfg = _w2v_cfg(num_layers=4, do_stable_layer_norm=stable, num_heads=2)
        params = _tree(cfg, 10 + stable)
        fwd[variant] = dict(cfg=dataclasses.asdict(cfg), tree=params, audio=audio, lengths=lengths)
        for shape in ((2, 2), (1, 4)):
            mesh = _mesh(("data", "pipe"), shape)
            pp = shard_pp_params(stack_wav2vec2_params(params), mesh)
            with mesh:
                lp, fl = jax.jit(lambda p, a, l, cfg=cfg, mesh=mesh: ctc_log_probs_gpipe(p, a, cfg, mesh, lengths=l,
                                                                                        n_microbatches=2))(
                    pp, jnp.asarray(audio), jnp.asarray(lengths))
            refs[(shape, variant)] = (np.asarray(lp), np.asarray(fl))
    return fwd, refs


def _grad_inputs():
    from ssak_tpu.ops.ctc import ctc_loss as ctc_loss_scan

    cfg = _w2v_cfg(num_layers=2, num_heads=2)
    params = _tree(cfg, 1)
    rng = np.random.RandomState(1)
    B, T, U = 4, 1200, 5
    batch = {"audio": rng.randn(B, T).astype(np.float32) * 0.1, "audio_lengths": np.asarray([T, 900, T, 700], np.int32),
             "labels": rng.randint(1, cfg.vocab_size, (B, U)).astype(np.int32),
             "label_lengths": np.asarray([U, 3, U, 2], np.int32)}

    def dense_loss(p):
        lp, fl = JW.ctc_log_probs(p, jnp.asarray(batch["audio"]), cfg, jnp.asarray(batch["audio_lengths"]))
        return ctc_loss_scan(lp, fl, jnp.asarray(batch["labels"]), jnp.asarray(batch["label_lengths"]),
                             blank_id=cfg.blank_id)

    loss, grads = jax.jit(jax.value_and_grad(dense_loss))(params)
    return dict(cfg=dataclasses.asdict(cfg), tree=params, batch=batch), (float(loss), grads)


def _step_inputs():
    from ssak_tpu.parallel.pipeline import make_pp_ctc_train_step, shard_pp_params, stack_wav2vec2_params
    from ssak_tpu.train.steps import init_train_state, make_optimizer

    cfg = _w2v_cfg(num_layers=4, num_heads=2)
    tree = _tree(cfg, 2)
    params = jax.tree.map(jnp.asarray, tree)
    rng = np.random.RandomState(2)
    B, T, U = 4, 1600, 4
    batch = {"audio": rng.randn(B, T).astype(np.float32) * 0.1, "audio_lengths": np.full((B,), T, np.int32),
             "labels": rng.randint(1, cfg.vocab_size, (B, U)).astype(np.int32),
             "label_lengths": np.full((B,), U, np.int32)}
    mesh = _mesh(("data", "pipe"), (2, 2))
    opt = make_optimizer(learning_rate=3e-3, warmup_steps=1, total_steps=30)
    losses = []
    with mesh:
        state = init_train_state(shard_pp_params(stack_wav2vec2_params(params), mesh), opt)
        step = make_pp_ctc_train_step(cfg, opt, mesh, n_microbatches=2)
        for _ in range(3):
            state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
            losses.append(float(m["loss"]))
    return dict(cfg=dataclasses.asdict(cfg), tree=tree, batch=batch), losses


def _sp_inputs():
    from ssak_tpu.parallel.sequence import ctc_log_probs_sp

    items, refs = {}, {}
    audio, lengths = _audio(3, 2, 4000, [4000, 2500])
    for variant, stable in (("post", False), ("stable", True)):
        cfg = _w2v_cfg(num_layers=2, do_stable_layer_norm=stable)
        params = _tree(cfg, 3 + stable)
        items[variant] = dict(cfg=dataclasses.asdict(cfg), tree=params, audio=audio, lengths=lengths)
        for shape in ((2, 2), (1, 4)):
            mesh = _mesh(("data", "seq"), shape)
            with mesh:
                lp, fl = jax.jit(lambda p, a, l, cfg=cfg, mesh=mesh: ctc_log_probs_sp(
                    p, a, cfg, mesh, lengths=l, seq_axis="seq", data_axis="data"))(
                    params, jnp.asarray(audio), jnp.asarray(lengths))
            refs[(shape, variant)] = (np.asarray(lp), np.asarray(fl))
    cfg = _w2v_cfg(num_layers=2, do_stable_layer_norm=True, conv_bias=True, adapter_attn_dim=8)
    items["adapter"] = dict(cfg=dataclasses.asdict(cfg), tree=_tree(cfg, 5), audio=audio, lengths=lengths)
    return items, refs


# Whisper: tiny_test in f32 with a vocabulary of 130 ids (divides by 2, not
# by 4: the embedding is cut at tp 2 and stays whole at tp 4, as ssak_tpu's
# rules keep it) and 2 encoder and 4 decoder heads (at tp 4 the encoder's
# attention stays whole while the decoder's splits). Its token embedding is
# scaled up so that the tied logits spread: ssak_tpu's own TP test notes
# that a seeded model's near-uniform logits make exact tokens ill-posed,
# so the tokens are compared only where every pick of the unsharded port's
# loops wins by WHISPER_MARGIN times the 1e-5 of the largest logit that
# the sharded logits are held to.
WHISPER_EMB_SCALE = 10.0
WHISPER_MARGIN = 10.0


def _whisper_item():
    """(JAX config, the inputs the ranks get): the port's seeded tree, a mel
    batch (3, 80, 200), teacher-forcing tokens, a greedy prompt and budget,
    two long-form files of 4 and 2.5 s (2 s windows)."""
    from ssak_tpu_torch.models import whisper as TWh
    from ssak_tpu_torch.models.convert import whisper_to_tree

    jcfg = JWh.make_config("tiny_test", n_vocab=130, n_audio_head=2, n_text_head=4, dtype="float32")
    fields = {f.name for f in dataclasses.fields(TWh.WhisperConfig)}
    cfg = TWh.WhisperConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})
    tree = whisper_to_tree(TWh.init_params(torch.Generator().manual_seed(0), cfg))
    tree["decoder"]["token_embedding"] = tree["decoder"]["token_embedding"] * np.float32(WHISPER_EMB_SCALE)
    rng = np.random.RandomState(1)
    item = dict(family="whisper", cfg=dataclasses.asdict(cfg), tree=tree,
                mel=(rng.randn(3, cfg.n_mels, 200) * 0.3).astype(np.float32),
                tokens=rng.randint(0, cfg.n_vocab, (3, 7)).astype(np.int64), prompt=[cfg.sot, cfg.no_timestamps],
                max_tokens=8, long_audio=[(rng.randn(n) * 0.1).astype(np.float32) for n in (64000, 40000)],
                lf_tokens=6)
    return jcfg, item


class _Margins:
    """The least gap, in logit units, by which any pick of the port's
    decode loops wins while installed: greedy's argmax over each step's
    logits (top-1 against top-2), each draw's logits plus T times its
    Gumbel noise (re-drawn from a copy of the generator's state), each
    beam's K-th candidate against its (K+1)-th. Rows that have finished
    and the prompt's steps count too, so the gap is a lower bound."""

    def __init__(self):
        from ssak_tpu_torch.models import whisper as TWh

        self.W, self.least, self.greedy = TWh, float("inf"), False

    def _gap(self, v, k=1):
        v = torch.sort(v, dim=-1, descending=True).values
        self.least = min(self.least, float((v[..., k - 1] - v[..., k]).min()))

    def __enter__(self):
        W = self.W
        self.orig = (W._step, W._pick, W._top_k, W.greedy_decode)
        step, pick, top_k, greedy = self.orig

        def step_(*a, **kw):
            logits, caches = step(*a, **kw)
            if self.greedy:
                self._gap(logits)
            return logits, caches

        def pick_(logits, temperature, generator):
            score = logits
            if temperature > 0:
                g = torch.Generator(device=logits.device)
                g.set_state(generator.get_state())
                u = torch.rand(logits.shape, generator=g, device=logits.device, dtype=torch.float32)
                score = logits - temperature * torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))
            self._gap(score)
            return pick(logits, temperature, generator)

        def top_k_(x, k):
            self._gap(x, k)
            return top_k(x, k)

        def greedy_(*a, **kw):
            self.greedy = True
            try:
                return greedy(*a, **kw)
            finally:
                self.greedy = False

        W._step, W._pick, W._top_k, W.greedy_decode = step_, pick_, top_k_, greedy_
        return self

    def __exit__(self, *exc):
        self.W._step, self.W._pick, self.W._top_k, self.W.greedy_decode = self.orig


def _whisper_refs(jcfg, item):
    """The port's loops unsharded (the least margin of their picks) and
    ssak_tpu's references: decode_train logits unsharded and under its
    shard_model at tp 2 and 4; greedy, beam 5 and the long-form loop at T
    = 0."""
    import test_torch_parallel_ranks as R
    import ssak_tpu.infer.whisper_infer as JWI
    from ssak_tpu.infer.general import LoadedModel, ModelType, shard_model

    with _Margins() as margins:
        port = R.whisper_decode_runs(R.whisper_model(item), item)
    params = jax.tree.map(jnp.asarray, item["tree"])
    mel, toks = jnp.asarray(item["mel"]), jnp.asarray(item["tokens"].astype(np.int32))
    fn = jax.jit(lambda p, t, m: JWh.decode_train(p, t, JWh.encode(p, m, jcfg), jcfg))
    train = {"dense": np.asarray(fn(params, toks, mel))}
    for tp in (2, 4):
        m = shard_model(LoadedModel(ModelType.WHISPER, params, jcfg, None), model_axis=tp)
        with m.mesh:
            train[tp] = np.asarray(fn(m.params, toks, mel))
    n, prompt = item["max_tokens"], item["prompt"]
    greedy = jax.jit(lambda p, m: JWh.greedy_decode(p, m, jcfg, prompt, max_tokens=n)[0])
    beam = jax.jit(lambda p, m: JWh.beam_decode(p, m, jcfg, prompt, beam_size=5, max_tokens=n)[0])
    ref = {"decode_train": train, "greedy": np.asarray(greedy(params, mel)), "beam": np.asarray(beam(params, mel)),
           "longform_t0": JWI.transcribe_longform_batch(LoadedModel(ModelType.WHISPER, params, jcfg, None),
                                                        item["long_audio"], temperatures=(0.0,),
                                                        max_tokens=item["lf_tokens"])}
    return {"port": port, "margin": margins.least, "jax": ref}


MOE_CAPACITY_FACTORS = (1.25, 0.5)
MOE_OPT = dict(learning_rate=3e-3, warmup_steps=1, total_steps=40, schedule="constant")
MOE_STEPS, MOE_COMPARED_STEPS = 15, 3


def _sharded_steps(cfg, params, batch, mesh, rules, opt_kw, n_steps, **step_kw):
    """ssak_tpu's shard_train_step(make_ctc_train_step(...), mesh) over
    `n_steps` on the same batch: (losses, grad norms, final params)."""
    from ssak_tpu.parallel.mesh import shard_params
    from ssak_tpu.train.steps import init_train_state, make_ctc_train_step, make_optimizer, shard_train_step

    opt = make_optimizer(**opt_kw)
    losses, norms = [], []
    with mesh:
        state = init_train_state(shard_params(jax.tree.map(jnp.asarray, params), mesh, rules), opt)
        step = shard_train_step(make_ctc_train_step(cfg, opt, **step_kw), mesh)
        for _ in range(n_steps):
            state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return losses, norms, _np_tree(state["params"])


def _moe_inputs():
    from ssak_tpu.parallel.moe import moe_init, moe_mlp

    p = moe_init(jax.random.PRNGKey(4), 16, 32, num_experts=4)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (4, 16, 16)))
    refs = {}
    for cf in MOE_CAPACITY_FACTORS:
        y, aux = jax.jit(lambda p, x, cf=cf: moe_mlp(x, p, top_k=2, capacity_factor=cf, dtype=jnp.float32))(
            p, jnp.asarray(x))
        refs[cf] = (np.asarray(y), float(aux))
    cfg = JW.make_config("tiny_test", num_experts=4, moe_top_k=2, dtype="float32")
    params = _tree(cfg, 0)
    rng = np.random.RandomState(0)
    B = 4
    batch = {"audio": rng.randn(B, 3200).astype(np.float32) * 0.1, "audio_lengths": np.full((B,), 3200, np.int32),
             "labels": rng.randint(1, cfg.vocab_size, (B, 4)).astype(np.int32),
             "label_lengths": np.full((B,), 4, np.int32)}
    step_ref = {shape: _sharded_steps(cfg, params, batch, _mesh(("data", "expert"), shape), WAV2VEC2_MOE_RULES,
                                      MOE_OPT, MOE_COMPARED_STEPS, moe_aux_weight=0.01) for shape in ((2, 2), (2, 1))}
    inp = {"ep": {"params": _np_tree(p), "x": x, "capacity_factors": MOE_CAPACITY_FACTORS},
           "train": {"cfg": dataclasses.asdict(cfg), "tree": params, "batch": batch, "opt": MOE_OPT,
                     "moe_aux_weight": 0.01, "steps": MOE_STEPS, "compare_after": MOE_COMPARED_STEPS}}
    return inp, {"layer": refs, "step": step_ref}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    import time

    t0 = time.perf_counter()
    tp = _tp_items()
    fwd, gpipe_refs = _gpipe_inputs()
    grads_inp, grads_ref = _grad_inputs()
    step_inp, step_ref = _step_inputs()
    sp_inp, sp_refs = _sp_inputs()
    moe_inp, moe_ref = _moe_inputs()
    jcfg, whisper = _whisper_item()
    inp = {"tp": {k: {kk: vv for kk, vv in v.items() if kk not in ("jcfg", "params")} for k, v in tp.items()},
           "gpipe": {"fwd": fwd, "grads": grads_inp, "step": step_inp}, "sp": sp_inp, "moe": moe_inp,
           "whisper": whisper}
    t1 = time.perf_counter()
    ranks = spawn("main", 4, inp, tmp_path_factory.mktemp("world4"))
    print(f"world4: references {t1 - t0:.1f} s, ranks {time.perf_counter() - t1:.1f} s")
    return {"ranks": ranks, "tp": {**tp, "whisper": whisper}, "tp_refs": _jax_tp_refs(tp), "gpipe": gpipe_refs,
            "grads": grads_ref, "step": step_ref, "sp": sp_refs, "moe": moe_ref,
            "whisper": _whisper_refs(jcfg, whisper)}


# --- tensor parallelism ---------------------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", ["w2v_post", "w2v_stable", "w2v_heads2", "conformer"])
def test_shard_model_log_probs_match_ssak_tpu(world4, name, tp):
    """shard_model over the mesh's 'model' dim: every rank's log-probs
    equal ssak_tpu's unsharded and under its shard_model at tp 4 (f32,
    1e-5), and rank 0's equal the other ranks'."""
    got = [r[f"tp{tp}/{name}"] for r in world4["ranks"]]
    ref = world4["tp_refs"][name]
    fl = got[0]["fl"]
    mask = _valid(ref["dense"], fl)
    for g in got:
        np.testing.assert_array_equal(g["fl"], fl)
        assert np.abs(g["lp"] - ref["dense"])[mask].max() < 1e-5
        assert np.abs(g["lp"] - ref[4])[mask].max() < 1e-5
        assert np.abs(g["lp"] - got[0]["lp"])[mask].max() < 1e-6


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_model_marks_layers_and_keeps_indivisible_heads_replicated(world4, tp):
    """Column-parallel q/k/v/fc1, row-parallel out/fc2, the head gathered;
    2 heads over 4 ranks: the attention stays whole (no collective) while
    the MLP shards."""
    post = world4["ranks"][0][f"tp{tp}/w2v_post"]
    assert post["tp_size"] == tp
    modes = post["modes"]
    assert modes["encoder.blocks.0.attn.query"] == "col" and modes["encoder.blocks.0.attn.out"] == "row"
    assert modes["encoder.blocks.0.mlp.fc1"] == "col" and modes["encoder.blocks.0.mlp.fc2"] == "row"
    assert modes["lm_head"] == "gather" and "feature_projection.projection" not in modes
    h2 = world4["ranks"][0][f"tp{tp}/w2v_heads2"]
    assert h2["tp_size"] == (2 if tp == 2 else 1)
    assert ("encoder.blocks.0.attn.query" in h2["modes"]) == (tp == 2)
    assert h2["modes"]["encoder.blocks.0.mlp.fc1"] == "col"
    conf = world4["ranks"][0][f"tp{tp}/conformer"]["modes"]
    assert conf["blocks.0.attn.linear_pos"] == "col" and conf["blocks.0.ff1.fc1"] == "col"
    assert "blocks.0.conv.pointwise1" not in conf


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", ["w2v_post", "w2v_heads2", "conformer", "whisper"])
def test_shard_model_slices_leaf_by_leaf(world4, name, tp):
    """Each rank's slice of every sharded parameter is the JAX leaf cut by
    ssak_tpu's spec (read in the (in, out) layout) at the rank's index on
    'model', then laid out as the port's (out, in) weight; Whisper's token
    embedding keeps its rows (ids) [r V / tp, (r + 1) V / tp)."""
    from ssak_tpu.parallel.sharding import CONFORMER_RULES, WAV2VEC2_RULES, WHISPER_RULES, partition_spec_for
    from ssak_tpu_torch.parallel.sharding import tree_path

    item = world4["tp"][name]
    rules = {"conformer": CONFORMER_RULES, "whisper": WHISPER_RULES}.get(item["family"], WAV2VEC2_RULES)
    jmesh = type("M", (), {"shape": {"data": 4 // tp, "model": tp}})()
    for r in world4["ranks"]:
        got = r[f"tp{tp}/{name}"]
        assert got["shards"]
        for pname, local in got["shards"].items():
            node = item["tree"]
            path = tree_path(pname)
            for part in path.strip("/").split("/"):
                node = node[int(part)] if isinstance(node, list) else node[part]
            leaf = np.asarray(node)
            spec = partition_spec_for(path, leaf, rules, jmesh)
            dim = next(i for i, a in enumerate(spec) if a == "model")
            want = np.split(leaf, tp, axis=dim)[got["model_rank"]]
            if path.endswith("/kernel"):
                want = want.T
            np.testing.assert_array_equal(local, want, err_msg=pname)


# --- Whisper's tensor-parallel decode ------------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
def test_whisper_shard_model_places_every_leaf_as_ssak_tpu(world4, tp):
    """Every leaf that ssak_tpu's WHISPER_RULES shard on (data 4 / tp,
    model tp) is cut on every rank, but for an attention whose heads do not
    divide (the encoder's 2 at tp 4: whole, no collective); nothing else is
    cut. q/k/v and fc1 are column-, out and fc2 row-parallel in the encoder
    and in both decoder attentions; the token embedding is cut at tp 2 (V =
    130 rows, 65 a rank) and whole at tp 4, as ssak_tpu's rules keep a
    vocabulary that does not divide."""
    from ssak_tpu.parallel.sharding import WHISPER_RULES, partition_spec_for
    from ssak_tpu_torch.models import whisper as TWh
    from ssak_tpu_torch.parallel.mesh import shardings_like
    from ssak_tpu_torch.parallel.sharding import tree_path

    item = world4["whisper"]
    jmesh = type("M", (), {"shape": {"data": 4 // tp, "model": tp}})()
    module = TWh.init_params(torch.Generator().manual_seed(0), TWh.WhisperConfig(**world4["tp"]["whisper"]["cfg"]))
    specs = shardings_like(module, {"data": 4 // tp, "model": tp}, WHISPER_RULES)
    for r in world4["ranks"]:
        got = r[f"tp{tp}/whisper"]
        cut = {tree_path(n) for n in got["shards"]}
        want = set()
        for path, spec in specs.items():
            node = world4["tp"]["whisper"]["tree"]
            for part in path.strip("/").split("/"):
                node = node[int(part)] if isinstance(node, list) else node[part]
            assert spec == partition_spec_for(path, np.asarray(node), WHISPER_RULES, jmesh), path
            whole_heads = tp == 4 and path.startswith("/encoder/") and "/attn/" in path
            if any(a is not None for a in spec) and not whole_heads:
                want.add(path)
        assert cut == want
        assert ("/decoder/token_embedding" in cut) == (tp == 2)
        assert got["vocab_tp"] == ("vocab" if tp == 2 else None)
        for pre in ("decoder.blocks.1.attn", "decoder.blocks.0.cross_attn") + (("encoder.blocks.0.attn",) if tp == 2 else ()):
            assert got["tp_size"][pre] == tp
            assert [got["modes"][f"{pre}.{k}"] for k in ("query", "key", "value", "out")] == ["col"] * 3 + ["row"]
        assert got["tp_size"]["encoder.blocks.0.attn"] == (2 if tp == 2 else 1)
        assert got["modes"]["encoder.blocks.1.mlp.fc1"] == "col" and got["modes"]["decoder.blocks.0.mlp.fc2"] == "row"


@pytest.mark.parametrize("tp", [2, 4])
def test_whisper_decode_train_matches_ssak_tpu(world4, tp):
    """Teacher-forced logits (f32) of every rank within 1e-5 of their
    largest value of ssak_tpu's unsharded ones and of ssak_tpu's under its
    shard_model at the same tp, and equal bit for bit across ranks (the
    tied logits are all-gathered)."""
    ref = world4["whisper"]["jax"]["decode_train"]
    got = [r[f"tp{tp}/whisper"]["decode_train"] for r in world4["ranks"]]
    tol = 1e-5 * float(np.abs(ref["dense"]).max())
    for g in got:
        assert g.shape == ref["dense"].shape
        assert np.abs(g - ref["dense"]).max() <= tol
        assert np.abs(g - ref[tp]).max() <= tol
        np.testing.assert_array_equal(g, got[0])


def _segments_equal(got, want, rel=1e-4):
    """Long-form results: the same texts and segments (tokens, seek,
    start, end, temperature); the scores to `rel`."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["text"] == w["text"] and len(g["segments"]) == len(w["segments"]) > 0
        for a, b in zip(g["segments"], w["segments"]):
            assert (a["tokens"], a["seek"], a["temperature"]) == (b["tokens"], b["seek"], b["temperature"])
            assert a["start"] == pytest.approx(b["start"]) and a["end"] == pytest.approx(b["end"])
            assert a["avg_logprob"] == pytest.approx(b["avg_logprob"], rel=rel)
            assert a["no_speech_prob"] == pytest.approx(b["no_speech_prob"], rel=rel)


def _step_logits_close(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.abs(g - w).max() <= 1e-5 * float(np.abs(w).max())


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("loop", ["greedy", "beam", "sample", "fallback", "longform"])
def test_whisper_decode_loops_on_rank_heads(world4, tp, loop):
    """Every decode loop on the ranks' heads gives the tokens of the port's
    unsharded run on every rank (each rank took the same host branches: a
    rank that branched alone would leave its peers in a collective, and
    spawn() would fail on its timeout), and ssak_tpu's where it decodes at
    T = 0 (greedy, beam 5, the long-form loop at T = 0; at T > 0 ssak_tpu
    draws from another generator). Sampling is best_of 3 at T = 0.6 with
    one seed on every rank; transcribe_with_fallback and the long-form loop
    run a chain of three temperatures to its end (logprob_threshold 0,
    best_of 3).
    Each cached step's logits within 1e-5 of their largest value. Well
    posed: every pick of the unsharded loops wins by at least WHISPER_MARGIN
    times that tolerance."""
    w = world4["whisper"]
    tol = 1e-5 * float(np.abs(w["port"]["decode_train"]).max())
    assert w["margin"] >= WHISPER_MARGIN * tol, (w["margin"], tol)
    port, jref = w["port"], w["jax"]
    for r in world4["ranks"]:
        got = r[f"tp{tp}/whisper"]
        if loop in ("greedy", "beam", "sample"):
            np.testing.assert_array_equal(got[loop]["tokens"], port[loop]["tokens"])
            np.testing.assert_array_equal(got[loop]["lengths"], port[loop]["lengths"])
            if loop in jref:
                np.testing.assert_array_equal(got[loop]["tokens"], jref[loop])
            if loop != "beam":
                _step_logits_close(got[loop]["step_logits"], port[loop]["step_logits"])
        elif loop == "fallback":
            assert got["fallback"] == port["fallback"] and len(got["fallback"]) == 3
        else:
            _segments_equal(got["longform"], port["longform"])
            _segments_equal(got["longform_t0"], port["longform_t0"])
            _segments_equal(got["longform_t0"], jref["longform_t0"])
            _step_logits_close(got["longform_t0_step_logits"], port["longform_t0_step_logits"])
    assert {s["temperature"] for res in port["longform"] for s in res["segments"]} == {1.0}  # the chain ran to its end


# --- pipeline ------------------------------------------------------------------------------------


def _assemble(ranks, key):
    """Rows of the global batch from the ranks' data shards."""
    out = {}
    for r in ranks:
        g = r[key]
        for i, row in enumerate(g["rows"]):
            out[row] = (g["lp"][i], g["fl"][i])
    rows = sorted(out)
    return np.stack([out[i][0] for i in rows]), np.asarray([out[i][1] for i in rows])


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("variant", ["post", "stable"])
def test_gpipe_forward_matches_ssak_tpu(world4, shape, variant):
    lp, fl = _assemble(world4["ranks"], f"gpipe{shape}/{variant}")
    ref_lp, ref_fl = world4["gpipe"][(shape, variant)]
    np.testing.assert_array_equal(fl, ref_fl)
    assert np.abs(lp - ref_lp)[_valid(lp, fl)].max() < 2e-4


def _jax_leaf(tree, name, stage):
    """The JAX gradient leaf of a port parameter (a stage's block index
    shifted by its stage), in the port's layout."""
    parts = name.split(".")
    if parts[:2] == ["encoder", "blocks"]:
        parts[2] = str(int(parts[2]) + stage)
    node = tree
    leaf = parts[-1]
    for p in parts[:-1]:
        node = node[int(p)] if isinstance(node, list) else node[p]
    if leaf == "weight":
        k = np.asarray(node["kernel"])
        return k.T if k.ndim == 2 else k.transpose(2, 1, 0)
    return np.asarray(node[leaf])


def test_gpipe_gradients_match_dense(world4):
    """The stage's block gradients, feature_projection's (summed over
    'pipe': used by stage 0 alone) and lm_head's (not summed: computed on
    every pipe rank) against jax.grad of the dense model."""
    ref_loss, ref_grads = world4["grads"]
    for r in world4["ranks"]:
        g = r["gpipe_grads"]
        assert abs(g["loss"] - ref_loss) < 1e-4
        checked = 0
        for name, got in g["grads"].items():
            if name.startswith("feature_extractor."):
                continue
            want = _jax_leaf(ref_grads, name, g["stage"])
            np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3, err_msg=name)
            checked += 1
        assert "feature_projection.projection.weight" in g["grads"] and "lm_head.weight" in g["grads"]
        assert checked > 20


def test_pp_train_step_matches_ssak_tpu_and_learns(world4):
    """make_pp_ctc_train_step at (data 2, pipe 2): the first 3 losses are
    ssak_tpu's (f32), and the loss falls over 8 steps."""
    losses = world4["ranks"][0]["pp_step"]["losses"]
    for r in world4["ranks"][1:]:
        np.testing.assert_allclose(r["pp_step"]["losses"], losses, rtol=1e-6)
    np.testing.assert_allclose(losses[:3], world4["step"], rtol=1e-4)
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


# --- sequence parallelism ------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("variant", ["post", "stable"])
def test_sequence_parallel_matches_ssak_tpu(world4, shape, variant):
    lp, fl = _assemble(world4["ranks"], f"sp{shape}/{variant}")
    ref_lp, ref_fl = world4["sp"][(shape, variant)]
    np.testing.assert_array_equal(fl, ref_fl)
    ref_lp = ref_lp[:, : lp.shape[1]]
    assert np.abs(lp - ref_lp)[_valid(lp, fl)].max() < 2e-4


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_sequence_parallel_runs_the_adapter_as_encode_does(world4, shape):
    """An MMS-adapter model: the time-sharded encoder runs the blocks of
    models.wav2vec2.encode, adapters included, so its log-probs are the
    port's unsharded ones (2e-4). (ssak_tpu's encode_sp leaves the
    adapter out.)"""
    lp, fl = _assemble(world4["ranks"], f"sp{shape}/adapter")
    ref_lp, ref_fl = _assemble(world4["ranks"], f"sp{shape}/adapter_dense")
    np.testing.assert_array_equal(fl, ref_fl)
    assert np.abs(lp - ref_lp[:, : lp.shape[1]])[_valid(lp, fl)].max() < 2e-4


# --- MoE -------------------------------------------------------------------------------------------


def test_expert_sharded_moe_equals_one_rank(world4):
    ref, ref_aux = world4["moe"]["layer"][1.25]
    for r in world4["ranks"]:
        m = r["moe_ep"]
        assert m["local_experts"] == 1
        np.testing.assert_allclose(m["y4"], m["y1"], atol=1e-6)
        assert abs(m["aux4"] - m["aux1"]) < 1e-6
        np.testing.assert_allclose(m["y4"], ref, atol=1e-5)
        assert abs(m["aux4"] - ref_aux) < 1e-5


@pytest.mark.parametrize("cf", MOE_CAPACITY_FACTORS)
@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_data_parallel_moe_routes_the_global_batch(world4, shape, cf):
    """Each data rank's rows of moe_mlp(data_group=) against ssak_tpu's
    moe_mlp over the whole batch: the global capacity and fill order keep
    and drop the same tokens, and the aux loss is the global one."""
    ref, ref_aux = world4["moe"]["layer"][cf]
    for r in world4["ranks"]:
        m = r[f"moe_dp{shape}/{cf}"]
        np.testing.assert_allclose(m["y"], ref[m["rows"]], atol=1e-5)
        assert abs(m["aux"] - ref_aux) < 1e-6 * max(1.0, abs(ref_aux))


def test_moe_ctc_learns_on_data_and_expert_ranks(world4):
    for r in world4["ranks"]:
        t = r["moe_train"]
        assert t["local_experts"] == 2
        assert np.isfinite(t["losses"]).all()
        assert t["losses"][-1] < t["losses"][0] * 0.8, t["losses"]


def test_moe_shard_train_step_matches_ssak_tpu(world4):
    """shard_train_step(make_ctc_train_step(moe_aux_weight=0.01)) on (data
    2, expert 2) against ssak_tpu's on the same mesh of its CPU devices:
    losses 1e-5 (relative) over 3 steps and every parameter (the rank's
    experts against theirs) within lr after them; grad norms 1e-4
    (relative) against ssak_tpu's program on (data 2, expert 1), the same
    global function. On a mesh whose second axis has 2 devices XLA
    partitions ssak_tpu's gradient of the grouped positional convolution
    wrongly: pos_conv's kernel gets twice its gradient (a dense (data 2,
    model 2) mesh too), which raises the norm; the clip and Adam scale the
    updates the same, so losses and parameters agree."""
    losses, _, ref = world4["moe"]["step"][(2, 2)]
    _, norms, _ = world4["moe"]["step"][(2, 1)]
    n = len(losses)
    for r in world4["ranks"]:
        t = r["moe_train"]
        np.testing.assert_allclose(t["losses"][:n], losses, rtol=1e-5)
        np.testing.assert_allclose(t["grad_norms"][:n], norms, rtol=1e-4)
        e, k = t["expert_rank"], t["local_experts"]
        worst = 0.0
        for got_blk, want_blk in zip(t["tree"]["encoder"]["blocks"], ref["encoder"]["blocks"]):
            for leaf in ("w1", "b1", "w2", "b2"):
                want = want_blk["moe"][leaf][e * k : (e + 1) * k]
                worst = max(worst, float(np.abs(got_blk["moe"][leaf] - want).max()))
        rest = [(a, b) for a, b in zip(jax.tree.leaves(_without_experts(t["tree"])),
                                       jax.tree.leaves(_without_experts(ref)))]
        assert len(rest) > 20
        worst = max([worst] + [float(np.abs(a - b).max()) for a, b in rest])
        assert worst <= MOE_OPT["learning_rate"], worst


def _without_experts(tree):
    out = dict(tree)
    enc = dict(tree["encoder"])
    enc["blocks"] = [{k: ({"gate": v["gate"]} if k == "moe" else v) for k, v in b.items()} for b in enc["blocks"]]
    out["encoder"] = enc
    return out


# --- the world of 2 ---------------------------------------------------------------------------


DP_OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
WHISPER_INFER_TOKENS = 12


@pytest.fixture(scope="module")
def world2(tmp_path_factory, tmp_audio_dir):
    from ssak_tpu_torch.data.tarred import create_tarred_dataset

    tmp = tmp_path_factory.mktemp("world2")
    rng = np.random.RandomState(5)
    files = []
    for i, n in enumerate((5000, 16000, 9000)):
        from ssak_tpu_torch.audio.io import save_audio

        path = str(tmp / f"u{i}.wav")
        save_audio(path, (rng.randn(n) * 0.1).astype(np.float32), 16000)
        files.append(path)
    cfg = _w2v_cfg(num_layers=2)
    params = _tree(cfg, 8)
    B, T, U = 4, 1600, 4
    batch = {"audio": rng.randn(B, T).astype(np.float32) * 0.1,
             "audio_lengths": np.asarray([T, 1400, T, 1000], np.int32),
             "labels": rng.randint(1, cfg.vocab_size, (B, U)).astype(np.int32),
             "label_lengths": np.asarray([U, 3, U, 2], np.int32)}
    tone = os.path.join(tmp_audio_dir, "tone16k.wav")
    rows = [{"id": f"u{i}", "audio": tone, "start": 0.0, "end": 0.5, "duration": 0.5, "text": ""} for i in range(8)]
    tarred = str(tmp / "tarred")
    create_tarred_dataset(rows, tarred, buckets=(1.0,), shard_size=2)  # 4 shards
    inp = {"files": files, "dp": {"cfg": dataclasses.asdict(cfg), "tree": params, "batch": batch, "opt": DP_OPT},
           "tarred": tarred, "whisper": _whisper_item()[1], "whisper_max_tokens": WHISPER_INFER_TOKENS}
    dp_ref = _sharded_steps(cfg, params, batch, _mesh(("data", "model"), (2, 1)), WAV2VEC2_RULES, DP_OPT, 3)
    return {"ranks": spawn("pair", 2, inp, tmp / "ranks"), "inp": inp, "rows": rows, "dp_ref": dp_ref}


def test_ctc_infer_tensor_parallel_equals_one_rank(world2):
    from ssak_tpu_torch.infer.ctc_infer import ctc_infer

    one = list(ctc_infer(None, world2["inp"]["files"], seeded_test_config="wav2vec2", device="cpu", output_ids=True))
    assert world2["ranks"][0]["texts"] == one and len(one) == 3
    assert world2["ranks"][1]["texts"] == []  # rank 0 yields the transcripts


def test_whisper_infer_tensor_parallel_rank0_yields(world2):
    """whisper_infer(tensor_parallel=2) on the seeded tiny Whisper: rank 0
    yields one (id, text) a file in order, the other rank nothing. With
    --load_in_8bit every unit stays whole and only the embedding is cut,
    so the logits are the unsharded model's bit for bit
    (test_whisper_quantized_tp_keeps_units_whole) and the transcripts are
    one rank's. In bf16 the row-parallel sums round in another order, and
    the seeded model's near-uniform logits make its tokens ill-posed: its
    transcripts are held only to their ids."""
    from ssak_tpu_torch.infer.whisper_infer import whisper_infer

    files = world2["inp"]["files"]
    ids = [os.path.splitext(os.path.basename(f))[0] for f in files]
    one = list(whisper_infer(None, files, seeded_test_config="whisper", quantize_bits=8, device="cpu",
                             output_ids=True, max_tokens=WHISPER_INFER_TOKENS))
    assert world2["ranks"][0]["whisper_texts"][8] == one and [i for i, _ in one] == ids
    bf16 = world2["ranks"][0]["whisper_texts"][0]
    assert [i for i, _ in bf16] == ids
    assert all(t and all(0 <= int(x) < 128 for x in t.split()) for _, t in bf16)
    assert all(r["whisper_texts"] == {0: [], 8: []} for r in world2["ranks"][1:])


@pytest.mark.parametrize("bits", [8, 4])
def test_whisper_quantized_tp_keeps_units_whole(world2, bits):
    """The tiny Whisper quantized (int8 or int4 weights, int8 K/V caches)
    and sharded at tp 2: ssak_tpu's rules match only float kernels, so
    every attention and MLP holding a quantized layer stays whole (no
    dense is marked, every tp_size is 1) and K2 / K3 would run whole on
    each rank; only the float token embedding is cut (65 of 130 rows).
    The teacher-forced and every greedy step's logits are the unsharded
    quantized model's bit for bit (the lookup's sum over ranks is exact and
    each logit is the same dot product), and so are the tokens."""
    for r in world2["ranks"]:
        q = r["whisper_quantized"][f"int{bits}"]
        assert q["modes"] == {} and set(q["tp_size"].values()) == {1} and q["vocab_tp"] == "vocab"
        assert list(q["shards"]) == ["decoder.token_embedding"] and q["shards"]["decoder.token_embedding"].shape[0] == 65
        np.testing.assert_array_equal(q["tp2"]["decode_train"], q["dense"]["decode_train"])
        np.testing.assert_array_equal(q["tp2"]["tokens"], q["dense"]["tokens"])
        assert len(q["tp2"]["step_logits"]) == len(q["dense"]["step_logits"]) > 0
        for a, b in zip(q["tp2"]["step_logits"], q["dense"]["step_logits"]):
            np.testing.assert_array_equal(a, b)


def test_whisper_infer_tensor_parallel_needs_a_process_group(monkeypatch):
    """tensor_parallel without a process group (no torchrun environment)
    raises ValueError at the call, naming torchrun; so does shard_model."""
    from ssak_tpu_torch.infer.general import load_model, shard_model
    from ssak_tpu_torch.infer.whisper_infer import whisper_infer

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        whisper_infer(None, [np.zeros(1600, np.float32)], seeded_test_config="whisper", tensor_parallel=2,
                      device="cpu")
    with pytest.raises(ValueError, match="process group"):
        shard_model(load_model(None, seeded_test_config="whisper", device="cpu"), model_axis=2)


def test_shard_train_step_on_two_ranks_equals_one_rank(world2):
    """Two data ranks, each on half the batch, gradients averaged: the
    losses, grad norms and parameters of one rank on the whole batch."""
    from ssak_tpu_torch.models import wav2vec2 as TW
    from ssak_tpu_torch.models.convert import wav2vec2_from_tree, wav2vec2_to_tree
    from ssak_tpu_torch.train.steps import init_train_state, make_ctc_train_step, make_optimizer

    d = world2["inp"]["dp"]
    cfg = TW.Wav2Vec2Config(**d["cfg"])
    model = wav2vec2_from_tree(d["tree"])
    opt = make_optimizer(**DP_OPT)
    state = init_train_state(model, opt)
    step = make_ctc_train_step(cfg, opt)
    losses, norms = [], []
    for _ in range(3):
        state, m = step(state, {k: torch.tensor(v) for k, v in d["batch"].items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    for r in world2["ranks"]:
        np.testing.assert_allclose(r["dp"]["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(r["dp"]["grad_norms"], norms, rtol=1e-4)
        got = jax.tree.leaves(r["dp"]["tree"])
        want = jax.tree.leaves(wav2vec2_to_tree(model))
        assert max(float(np.abs(a - b).max()) for a, b in zip(got, want)) <= 1e-3


def test_shard_train_step_on_two_ranks_matches_ssak_tpu(world2):
    """The two data ranks' 3 steps against ssak_tpu's shard_train_step on a
    (data 2, model 1) mesh of its CPU devices: losses 1e-5, grad norms
    1e-4 (relative), every parameter within lr."""
    losses, norms, ref = world2["dp_ref"]
    for r in world2["ranks"]:
        np.testing.assert_allclose(r["dp"]["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(r["dp"]["grad_norms"], norms, rtol=1e-4)
        got = jax.tree.leaves(r["dp"]["tree"])
        assert max(float(np.abs(a - b).max()) for a, b in zip(got, jax.tree.leaves(ref))) <= DP_OPT["learning_rate"]


def test_two_process_tarred_interleave_and_allreduce(world2):
    r0, r1 = (r["tarred"] for r in world2["ranks"])
    assert not (set(r0["ids"]) & set(r1["ids"]))
    assert sorted(r0["ids"] + r1["ids"]) == sorted(r["id"] for r in world2["rows"])
    assert r0["global_sum"] == r1["global_sum"]
    assert abs(r0["global_sum"] - (r0["local_stat"] + r1["local_stat"])) < 1e-6 * max(1.0, r0["global_sum"])


def test_replicate_broadcasts_rank_0s_weights(world2):
    want = jax.tree.leaves(world2["inp"]["dp"]["tree"])
    for r in world2["ranks"]:
        for a, b in zip(jax.tree.leaves(r["replicated"]), want):
            np.testing.assert_array_equal(a, b)


def test_ctc_infer_cli_under_torchrun(tmp_path):
    """python -m torch.distributed.run --nproc_per_node 2 -m
    ssak_tpu_torch.infer.ctc_infer ... --tensor_parallel 2 --dist_backend
    gloo --device cpu: rank 0 writes the one-rank CLI's lines."""
    from ssak_tpu_torch.audio.io import save_audio

    d = tmp_path / "data"
    d.mkdir()
    rng = np.random.RandomState(9)
    with open(d / "wav.scp", "w") as f:
        for i, n in enumerate((6000, 12000)):
            save_audio(str(d / f"u{i}.wav"), (rng.randn(n) * 0.1).astype(np.float32), 16000)
            f.write(f"utt{i} {d / f'u{i}.wav'}\n")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    args = [str(d), "none", "--seeded_test_config", "wav2vec2", "--device", "cpu"]
    one = subprocess.run([sys.executable, "-m", "ssak_tpu_torch.infer.ctc_infer", *args, "--output",
                          str(tmp_path / "one.txt")], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert one.returncode == 0, one.stderr
    two = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                          "-m", "ssak_tpu_torch.infer.ctc_infer", *args, "--tensor_parallel", "2", "--dist_backend",
                          "gloo", "--output", str(tmp_path / "two.txt")],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert two.returncode == 0, two.stderr[-3000:]
    lines = (tmp_path / "two.txt").read_text().splitlines()
    assert lines == (tmp_path / "one.txt").read_text().splitlines() and len(lines) == 2


def test_whisper_infer_cli_under_torchrun(tmp_path):
    """python -m torch.distributed.run --nproc_per_node 2 -m
    ssak_tpu_torch.infer.whisper_infer ... --tensor_parallel 2
    --dist_backend gloo --load_in_8bit --device cpu: rank 0 alone writes
    --output, one line a file with one rank's transcript (int8: the sharded
    logits are the unsharded ones bit for bit,
    test_whisper_quantized_tp_keeps_units_whole)."""
    from ssak_tpu_torch.audio.io import save_audio
    from ssak_tpu_torch.infer.whisper_infer import whisper_infer

    d = tmp_path / "data"
    d.mkdir()
    rng = np.random.RandomState(9)
    with open(d / "wav.scp", "w") as f:
        for i, n in enumerate((6000, 12000)):
            save_audio(str(d / f"u{i}.wav"), (rng.randn(n) * 0.1).astype(np.float32), 16000)
            f.write(f"utt{i} {d / f'u{i}.wav'}\n")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    two = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                          "-m", "ssak_tpu_torch.infer.whisper_infer", str(d), "none", "--seeded_test_config", "whisper",
                          "--load_in_8bit", "--device", "cpu", "--tensor_parallel", "2", "--dist_backend", "gloo",
                          "--output", str(tmp_path / "two.txt")],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert two.returncode == 0, two.stderr[-3000:]
    one = whisper_infer(None, str(d), seeded_test_config="whisper", quantize_bits=8, device="cpu", output_ids=True)
    lines = (tmp_path / "two.txt").read_text().splitlines()
    assert lines == [f"{i} {t}" for i, t in one] and [line.split(" ", 1)[0] for line in lines] == ["utt0", "utt1"]
