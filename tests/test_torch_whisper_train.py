"""The port's Whisper fine-tuning (ssak_tpu_torch.models.whisper encode /
decode_train / cross_entropy_loss, train.steps.make_whisper_train_step and
init_train_state(quantized=)) against ssak_tpu on the CPU, on the tiny_test config
and on large-v3 widths at 2 + 2 layers, inputs from numpy seeds.

Parameters, JAX-drawn adapters included, cross to the port through
whisper_from_tree. Tolerances: f32 loss 1e-5 relative, grad norm 1e-4,
updated leaves at most lr apart (Adam divides each entry by its own
gradient scale, so an entry whose gradient is a near-zero difference may
move either way); bf16 loss 1e-2 and gradient cosine >= 0.99; frozen
leaves bit for bit after every partitioned step."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssak_tpu.models import lora as JLoRA
from ssak_tpu.models import quant as JQ
from ssak_tpu.models import whisper as JW
from ssak_tpu.train import steps as JS
from ssak_tpu_torch.models import lora as TLoRA
from ssak_tpu_torch.models import quant as TQ
from ssak_tpu_torch.models import whisper as W
from ssak_tpu_torch.models.convert import whisper_from_tree, whisper_to_tree
from ssak_tpu_torch.train import steps as TS

LR = 1e-3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _cfgs(preset="tiny_test", dtype="float32", **kw):
    return JW.make_config(preset, dtype=dtype, **kw), W.make_config(preset, dtype=dtype, **kw)


def _large_cfgs(dtype="float32", **kw):
    """large-v3 widths (d 1280, 20 heads, 128 mels, 51,866 ids) at 2 + 2
    layers and a 2 s audio context."""
    return _cfgs("large-v3", dtype, n_audio_layer=2, n_text_layer=2, n_audio_ctx=100, n_text_ctx=32, **kw)


def _batch(cfg, B=2, U=12, seed=0):
    rng = np.random.RandomState(seed)
    mel = (rng.randn(B, cfg.n_mels, 2 * cfg.n_audio_ctx) * 0.5).astype(np.float32)
    tin = rng.randint(10, min(cfg.n_vocab, 5000), (B, U))
    tout = rng.randint(10, min(cfg.n_vocab, 5000), (B, U))
    mask = np.ones((B, U), np.float32)
    mask[1, U - 4 :] = 0
    mask[:, 0] = 0
    arrays = dict(mel=mel, tokens_in=tin, tokens_out=tout, token_mask=mask)
    jb = {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else v.dtype) for k, v in arrays.items()}
    return jb, {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}


def _jax_tree(cfg, seed=0, rank=0, lora_b=0.0):
    """ssak_tpu's init_params, with adapters (add_lora) whose B is set to
    lora_b * N(0, 1) when lora_b (a fresh B = 0 gives A no gradient)."""
    tree = _np_tree(JW.init_params(jax.random.PRNGKey(seed), cfg))
    if rank:
        tree = _np_tree(JLoRA.add_lora(tree, rank=rank, key=jax.random.PRNGKey(seed + 1)))
        if lora_b:
            rng = np.random.RandomState(seed + 2)
            tree = jax.tree_util.tree_map_with_path(
                lambda p, x: (lora_b * rng.randn(*x.shape)).astype(np.float32) if "lora_B" in str(p[-1]) else x, tree)
    return tree


# --- forward --------------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("preset", ["tiny_test", "large"])
def test_encode_and_decode_train_match_jax(remat, preset):
    cfg, tcfg = _large_cfgs(remat=remat) if preset == "large" else _cfgs(remat=remat)
    tree = _jax_tree(cfg, rank=4, lora_b=0.05)
    jb, tb = _batch(cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jaf = JW.encode(jp, jb["mel"], cfg)
    jlog = JW.decode_train(jp, jb["tokens_in"], jaf, cfg)
    model = whisper_from_tree(tree)
    with torch.no_grad():
        af = W.encode(model, tb["mel"], tcfg)
        logits = W.decode_train(model, tb["tokens_in"], af, tcfg)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (2, 12, cfg.n_vocab)
    for got, ref in ((af, jaf), (logits, jlog)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def _port_loss_and_grads(model, tcfg, tb, names=None):
    for p in model.parameters():
        p.grad = None
    params = dict(model.named_parameters())
    for k, p in params.items():
        p.requires_grad_(names is None or k in names)
    af = W.encode(model, tb["mel"], tcfg)
    loss = W.cross_entropy_loss(W.decode_train(model, tb["tokens_in"], af, tcfg), tb["tokens_out"], tb["token_mask"])
    loss.backward()
    grads = {k: p.grad.clone() for k, p in params.items() if p.grad is not None}
    for p in model.parameters():
        p.grad = None
        p.requires_grad_(False)
    return loss.detach(), af.detach(), grads


def test_remat_is_bit_identical_in_the_port():
    """cfg.remat recomputes each block in the backward pass: the encoder
    output, the loss and every gradient are the same bits with it off."""
    cfg, tcfg = _cfgs()
    tree = _jax_tree(cfg, rank=2, lora_b=0.05)
    _, tb = _batch(cfg)
    off = _port_loss_and_grads(whisper_from_tree(tree), tcfg, tb)
    on = _port_loss_and_grads(whisper_from_tree(tree), dataclasses.replace(tcfg, remat=True), tb)
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])
    assert off[2].keys() == on[2].keys() and len(off[2]) > 50
    assert all(torch.equal(off[2][k], on[2][k]) for k in off[2])


def test_cross_entropy_loss_matches_jax():
    rng = np.random.RandomState(3)
    logits = (rng.randn(3, 7, 50) * 3).astype(np.float32)
    targets = rng.randint(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.rand(3, 7) > 0.3).astype(np.float32)
    ref = float(JW.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask)))
    got = W.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(targets), torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), ref, rtol=1e-6)
    # an all-zero mask divides by 1, as ssak_tpu's max(1, sum)
    zero = np.zeros_like(mask)
    assert W.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(targets), torch.from_numpy(zero)).item() == 0.0


# --- train steps ------------------------------------------------------------------


def _jax_grads(tree, cfg, jb, quantized):
    """ssak_tpu's gradients of the step's loss over its trainable partition."""
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    trainable, frozen = JQ.partition_trainable(jp) if quantized else (jp, None)

    def loss_fn(t):
        p = JQ.merge_partition(t, frozen) if quantized else t
        enc = JW.encode(p, jb["mel"], cfg)
        return JW.cross_entropy_loss(JW.decode_train(p, jb["tokens_in"], enc, cfg), jb["tokens_out"], jb["token_mask"])

    return jax.jit(jax.grad(loss_fn))(trainable)


def _cosine(a, b):
    a = np.concatenate([np.asarray(x, np.float64).ravel() for x in a])
    b = np.concatenate([np.asarray(x, np.float64).ravel() for x in b])
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


STEP_MODES = {
    # mode: (compute dtype, LoRA rank, quantize bits, grad_accum)
    "full_f32": ("float32", 0, 0, 1),
    "lora_f32": ("float32", 4, 0, 1),
    "lora_bf16": ("bfloat16", 4, 0, 1),
    "qlora_int8": ("float32", 4, 8, 1),
    "qlora_int4": ("float32", 4, 4, 1),
    "grad_accum2": ("float32", 0, 0, 2),
    # the full step over a LoRA tree with lora_grad_mask: every leaf in the optimizer, only adapters' gradients
    "lora_grad_mask_f32": ("float32", 4, 0, 1),
}


# every mode on tiny_test; at large-v3 widths the LoRA-bf16 and QLoRA-int8 steps (chip_smoke.py's phase-4 pair)
STEP_CASES = [(m, "tiny_test") for m in STEP_MODES] + [("lora_bf16", "large"), ("qlora_int8", "large")]


@pytest.mark.parametrize("mode,preset", STEP_CASES)
def test_whisper_train_steps_match_jax(mode, preset):
    """Three steps of make_whisper_train_step in both packages from one
    tree: full (f32), LoRA over an f32 or a bf16 base, QLoRA over an int8 or
    int4 base (the partitioned step), a full step under gradient
    accumulation over 2, and the full step over a LoRA tree with
    grad_mask=lora_grad_mask (the base then still decays under AdamW in
    both packages, so only the leaves' limit applies to it). lora_bf16
    casts the float base to bf16 in both packages before adding the
    adapters, as train_whisper does."""
    dtype, rank, bits, accum = STEP_MODES[mode]
    cfg, tcfg = _large_cfgs(dtype) if preset == "large" else _cfgs(dtype=dtype)
    tree = _jax_tree(cfg, rank=rank, lora_b=0.02)
    base = _jax_tree(cfg)
    if bits:
        tree = _np_tree(JQ.quantize_params(tree, bits=bits))
    masked = mode == "lora_grad_mask_f32"
    partitioned = bool(rank or bits) and not masked
    jb, tb = _batch(cfg)
    jopt = JS.make_optimizer(learning_rate=LR, warmup_steps=1, total_steps=10)
    topt = TS.make_optimizer(learning_rate=LR, warmup_steps=1, total_steps=10)
    if accum > 1:
        jopt, topt = JS.with_grad_accumulation(jopt, accum), TS.with_grad_accumulation(topt, accum)
    if dtype == "bfloat16":
        jparams = jax.tree_util.tree_map(lambda x: jnp.asarray(x).astype(jnp.bfloat16), base)
        jparams = JLoRA.load_lora(jparams, JLoRA.extract_lora(tree))
        model = TLoRA.load_lora(whisper_from_tree(base).to(torch.bfloat16), JLoRA.extract_lora(tree))
    else:
        jparams = jax.tree_util.tree_map(jnp.asarray, tree)
        model = whisper_from_tree(tree)
    js = JS.init_train_state(jparams, jopt, quantized=partitioned)
    jstep = JS.make_whisper_train_step(cfg, jopt, quantized=partitioned,
                                       grad_mask=JLoRA.lora_grad_mask if masked else None)
    ts = TS.init_train_state(model, topt, quantized=partitioned)
    tstep = TS.make_whisper_train_step(tcfg, topt, quantized=partitioned,
                                       grad_mask=TLoRA.lora_grad_mask if masked else None)
    trainable0, frozen0 = TQ.partition_trainable(model)
    frozen0 = {k: v.clone() for k, v in frozen0.items()}
    assert len(ts["opt_state"]["1"]["0"]["mu"] if accum == 1 else ts["opt_state"]["inner_opt_state"]["1"]["0"]["mu"]) \
        == (len(dict(model.named_parameters())) if masked else len(trainable0))
    if partitioned:
        assert sorted(trainable0) == sorted(k for k in trainable0 if TLoRA.is_lora_name(k)) and trainable0
    if dtype == "bfloat16":
        # bf16 rounds at other places in each package: the gradients (f32 adapters) by their cosine
        names = set(trainable0)
        jg = _jax_grads(jparams, cfg, jb, True)
        _, _, tg = _port_loss_and_grads(model, tcfg, tb, names)
        jgt = {k: np.asarray(v) for k, v in JLoRA.extract_lora(jg).items() if not k.endswith("lora_scale")}
        assert sorted(jgt) == sorted("/" + k.replace(".", "/") for k in tg)
        cos = _cosine([jgt["/" + k.replace(".", "/")] for k in sorted(tg)], [tg[k] for k in sorted(tg)])
        assert cos >= 0.99, cos
        TS.init_train_state(model, topt, quantized=True)  # requires_grad back as the step expects
    n_steps = 3 if accum == 1 else 4  # under accumulation the first update has the warmup's lr 0
    for _ in range(n_steps):
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, tb)
        if dtype == "float32":
            np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
            np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
        else:
            np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-2)
        # the frozen partition is the same bits after every step
        _, frozen = TQ.partition_trainable(ts["model"])
        assert frozen.keys() == frozen0.keys()
        assert masked or all(torch.equal(frozen[k], frozen0[k]) for k in frozen)
    assert ts["step"] == int(js["step"]) == n_steps
    got = whisper_to_tree(ts["model"])
    if dtype == "float32":
        ref, out = _leaves(js["params"]), _leaves(got)
        assert len(ref) == len(out)
        moved = max(float(np.abs(a.astype(np.float32) - b.astype(np.float32)).max()) for a, b in zip(_leaves(tree), ref)
                    if a.dtype.kind == "f")
        worst = max(float(np.abs(a.astype(np.float32) - b.astype(np.float32)).max()) for a, b in zip(ref, out))
        assert moved > 0 and worst <= LR, (moved, worst)
    # the frozen leaves of ssak_tpu's tree equal the port's, bit for bit
    for path, leaf in jax.tree_util.tree_flatten_with_path(js["params"])[0]:
        name = str(path[-1].key) if hasattr(path[-1], "key") else ""
        node = got
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        if masked and name == "lora_scale":
            # ssak_tpu's scale is a float leaf in the optimizer, decayed by AdamW in the full step; the port's is a
            # fixed buffer (ROADMAP.md §3)
            assert 4.0 * (1 - LR * 0.01) ** n_steps < float(leaf) < 4.0 == float(node)
            continue
        if partitioned and not name.startswith("lora_") or name == "lora_scale":
            a, b = np.asarray(leaf), np.asarray(node)
            if a.dtype == jnp.bfloat16:
                a = a.astype(np.float32)
            np.testing.assert_array_equal(b, a)


def test_f16_full_finetune_follows_jax():
    """A full fine-tune of F16 leaves keeps them F16 with F16 Adam moments
    in both packages (no f32 masters). optax's eps = 1e-8 rounds to 0 in
    f16 and second moments below 6e-8 underflow, so the first update turns
    most entries to inf or NaN in ssak_tpu; the port does the same: the
    same loss and grad norm (f16 gradients summed in other orders: 2e-3),
    and the same non-finite entries but for 1 in 1,000."""
    cfg, tcfg = _cfgs()
    tree = jax.tree_util.tree_map(lambda a: a.astype(np.float16), _jax_tree(cfg))
    jb, tb = _batch(cfg)
    jopt = JS.make_optimizer(learning_rate=LR, warmup_steps=1, total_steps=10)
    topt = TS.make_optimizer(learning_rate=LR, warmup_steps=1, total_steps=10)
    js, jm = JS.make_whisper_train_step(cfg, jopt)(JS.init_train_state(jax.tree_util.tree_map(jnp.asarray, tree), jopt), jb)
    ts, tm = TS.make_whisper_train_step(tcfg, topt)(TS.init_train_state(whisper_from_tree(tree), topt), tb)
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=2e-3)
    assert all(m.dtype == torch.float16 for m in ts["opt_state"]["1"]["0"]["mu"].values())
    ref, got = _leaves(js["params"]), _leaves(whisper_to_tree(ts["model"]))
    assert all(a.dtype == b.dtype == np.float16 for a, b in zip(ref, got))
    jbad = np.concatenate([~np.isfinite(a).ravel() for a in ref])
    tbad = np.concatenate([~np.isfinite(b).ravel() for b in got])
    assert jbad.mean() > 0.9 and (jbad != tbad).mean() < 1e-3, (jbad.mean(), (jbad != tbad).mean())
