"""parallel/ in one process, against ssak_tpu on the CPU: the sharding
rules leaf by leaf, the MoE layer (index routing against ssak_tpu's
one-hot einsums, forward and gradients), the MoE wav2vec2 (log-probs,
three train steps with the load-balancing loss), trees of MoE and
layer-stacked models both ways, and the collectives at world size 1.
Multi-rank runs are in tests/test_torch_parallel_dist.py."""

import dataclasses
import functools
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from ssak_tpu.models import conformer as JC
from ssak_tpu.models import wav2vec2 as JW
from ssak_tpu.models import whisper as JWh
from ssak_tpu.parallel import moe as JM
from ssak_tpu.parallel import sharding as JS
from ssak_tpu.parallel.mesh import _tree_map_with_path as jax_tree_map_with_path
from ssak_tpu_torch.models import layers as L
from ssak_tpu_torch.models import wav2vec2 as TW
from ssak_tpu_torch.models.convert import (conformer_from_tree, conformer_to_tree, wav2vec2_from_tree,
                                           wav2vec2_to_tree, whisper_from_tree, whisper_to_tree)
from ssak_tpu_torch.parallel import collectives, sharding
from ssak_tpu_torch.parallel import moe as TM
from ssak_tpu_torch.parallel.mesh import shardings_like
from ssak_tpu_torch.parallel.pipeline import stack_wav2vec2_params, unstack_blocks


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _w2v_tree(jcfg, seed):
    """A seeded wav2vec2 tree of the JAX config, drawn by the port (quicker
    than JAX's eager initializers) and read by both packages."""
    return wav2vec2_to_tree(TW.init_params(TW.Wav2Vec2Config(**dataclasses.asdict(jcfg)), seed=seed))


@functools.lru_cache(maxsize=None)
def _model(name):
    """(JAX tree, port module, port rules, JAX rules) of a test model."""
    if name.startswith("w2v"):
        kw = {"w2v_post": {}, "w2v_stable": dict(do_stable_layer_norm=True, conv_bias=True),
              "w2v_moe": dict(num_experts=4)}[name]
        tree = _w2v_tree(JW.make_config("tiny_test", **kw), 0)
        rules = (sharding.WAV2VEC2_MOE_RULES, JS.WAV2VEC2_MOE_RULES) if "moe" in name else (sharding.WAV2VEC2_RULES,
                                                                                           JS.WAV2VEC2_RULES)
        return (tree, wav2vec2_from_tree(tree), *rules)
    if name == "conformer":
        from ssak_tpu_torch.models import conformer as TC

        cfg = JC.make_config("tiny_test", pos_type="relpos", num_heads=4)
        tree = conformer_to_tree(TC.init_params(TC.ConformerConfig(**dataclasses.asdict(cfg)), seed=2))
        return tree, conformer_from_tree(tree), sharding.CONFORMER_RULES, JS.CONFORMER_RULES
    from ssak_tpu_torch.models import whisper as TWh

    cfg = JWh.make_config("tiny_test")
    tcfg = TWh.WhisperConfig(**dataclasses.asdict(cfg))
    tree = whisper_to_tree(TWh.init_params(torch.Generator().manual_seed(3), tcfg))
    return tree, whisper_from_tree(tree), sharding.WHISPER_RULES, JS.WHISPER_RULES


MODELS = ["w2v_post", "w2v_stable", "w2v_moe", "conformer", "whisper"]
MESHES = [{"model": 2}, {"model": 4}, {"model": 3}, {"data": 2, "model": 2, "expert": 2}, {"data": 8},
          {"model": 2, "expert": 4}]


def test_rule_tables_are_ssak_tpus():
    for name in ("WHISPER_RULES", "WAV2VEC2_RULES", "CONFORMER_RULES", "WAV2VEC2_MOE_RULES"):
        ours, theirs = getattr(sharding, name), getattr(JS, name)
        assert [(p, tuple(s)) for p, s in ours] == [(p, tuple(s)) for p, s in theirs], name
    assert TM.MOE_RULES == JM.MOE_RULES


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(f"{k}{v}" for k, v in m.items()))
@pytest.mark.parametrize("name", MODELS)
def test_every_leaf_spec_equals_ssak_tpus(name, mesh):
    """For every parameter: the port's path and ssak_tpu-layout shape are
    the JAX tree's, and its spec is ssak_tpu's partition_spec_for on that
    leaf (non-dividing dims and missing axes fall back to replication)."""
    tree, module, rules, jrules = _model(name)
    jmesh = types.SimpleNamespace(shape=mesh)
    want = {}
    jax_tree_map_with_path(lambda path, leaf: want.__setitem__(path, (tuple(JS.partition_spec_for(path, leaf, jrules,
                                                                                                    jmesh)),
                                                                       np.shape(leaf))), tree)
    got = shardings_like(module, mesh, rules)
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:6]
    modules = dict(module.named_modules())
    for pname, p in module.named_parameters():
        owner, _, leaf = pname.rpartition(".")
        path = sharding.tree_path(pname)
        assert sharding.jax_shape(modules[owner], leaf, p) == want[path][1], path
        assert tuple(got[path]) == want[path][0], path
    if name != "whisper" and mesh.get("model") == 2:
        assert any(any(s) for s in got.values())


def test_moe_partition_spec_equals_ssak_tpus():
    p = {"gate": {"kernel": np.zeros((8, 4))}, "w1": np.zeros((4, 8, 16)), "b2": np.zeros((4, 8))}
    for path in ("/moe/w1", "/moe/b2", "/moe/gate/kernel", "/x/w1"):
        leaf = p["gate"]["kernel"] if path.endswith("kernel") else p[path.rsplit("/", 1)[1]]
        assert tuple(TM.moe_partition_spec(path, leaf)) == tuple(JM.moe_partition_spec(path, leaf))


# --- the MoE layer -----------------------------------------------------------------------------


def _jmoe(seed, E, D=16, F=32):
    p = JM.moe_init(jax.random.PRNGKey(seed), D, F, E)
    rng = np.random.RandomState(seed)
    p["b1"] = jnp.asarray(rng.randn(E, F).astype(np.float32) * 0.1)
    p["b2"] = jnp.asarray(rng.randn(E, D).astype(np.float32) * 0.1)
    return p


def _tmoe(p):
    return TM.MoE(L.Linear(torch.tensor(np.asarray(p["gate"]["kernel"]).T.copy())),
                  *(torch.tensor(np.asarray(p[k])) for k in ("w1", "b1", "w2", "b2")))


def _bf16_step(a):
    """One bf16 step at each entry's magnitude."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), 1e-30))) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [2.0, 1.25, 0.05])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("E", [1, 4])
def test_moe_mlp_matches_ssak_tpu(E, top_k, capacity_factor, dtype):
    """The same tokens kept and dropped, f32 to 1e-5 with aux to 1e-6, bf16
    within one bf16 step (the activation rounds op by op as jax.nn.gelu's)."""
    p = _jmoe(E * 10 + top_k, E)
    x = np.random.RandomState(0).randn(2, 24, 16).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    ref, ref_aux = jax.jit(lambda p, x: JM.moe_mlp(x, p, top_k=top_k, capacity_factor=capacity_factor, dtype=jdt))(
        p, jnp.asarray(x))
    got, aux = TM.moe_mlp(torch.tensor(x), _tmoe(p), top_k=top_k, capacity_factor=capacity_factor, dtype=tdt)
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    assert abs(float(aux) - float(ref_aux)) < 1e-6
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-5)
    else:
        assert (np.abs(got - ref) <= _bf16_step(ref)).all()
    np.testing.assert_array_equal(got == 0, ref == 0)  # dropped tokens: zero rows in both


def one_hot_moe_mlp(x, p, *, top_k, capacity_factor, dtype):
    """ssak_tpu's one-hot (S, E, C) dispatch and combine written out as its
    einsums, on the port's routing and experts: the witness that index
    routing computes the same function (its tensors grow as S²)."""
    B, T, D = x.shape
    S, E = B * T, p.num_experts
    top_k = min(top_k, E)
    C = TM.capacity(S, E, top_k, capacity_factor)
    xs = x.reshape(S, D)
    probs = torch.softmax(torch.matmul(xs.to(torch.float32), p.gate.weight.to(torch.float32).t()), dim=-1)
    topv, topi, pos, keep = TM.route(probs, top_k, C)
    combine = torch.zeros(S, E, C, dtype=torch.float32)
    for k in range(top_k):
        disp = torch.einsum("se,sc->sec", F.one_hot(topi[:, k], E).float(),
                            F.one_hot(pos[:, k].clamp(max=C - 1), C).float())
        combine = combine + disp * keep[:, k, None, None] * topv[:, k, None, None]
    dispatch = (combine > 0).to(dtype)
    xe = torch.einsum("sec,sd->ecd", dispatch.float(), xs.to(dtype).float()).to(dtype)
    h = TM.gelu_tanh(TM._bmm_f32(xe, p.w1, dtype).to(dtype) + p.b1.to(dtype)[:, None])
    ye = TM._bmm_f32(h, p.w2, dtype).to(dtype) + p.b2.to(dtype)[:, None]
    y = torch.einsum("sec,ecd->sd", combine.to(dtype).float(), ye.float()).to(dtype)
    aux = (probs.mean(0) * dispatch.sum(-1).float().mean(0)).sum() * E
    return y.reshape(B, T, D), aux


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cfg", [(4, 2, 1.25), (4, 1, 0.05), (3, 2, 0.5)])
def test_index_routing_equals_one_hot_witness(cfg, dtype):
    E, k, cf = cfg
    p = _tmoe(_jmoe(E, E))
    x = torch.tensor(np.random.RandomState(E).randn(3, 20, 16).astype(np.float32))
    y, aux = TM.moe_mlp(x, p, top_k=k, capacity_factor=cf, dtype=dtype)
    yw, auxw = one_hot_moe_mlp(x, p, top_k=k, capacity_factor=cf, dtype=dtype)
    y, yw = y.float().numpy(), yw.float().numpy()
    if dtype == torch.float32:  # the witness sums a token's k terms in another order
        np.testing.assert_allclose(y, yw, atol=1e-6)
    else:
        assert (np.abs(y - yw) <= _bf16_step(yw)).all() and (y == yw).mean() > 0.99
    assert float(aux) == pytest.approx(float(auxw), abs=1e-7)
    S = 60
    assert TM.capacity(S, E, k, cf) == int(np.ceil(cf * S * k / E / 8.0)) * 8
    topi, keep = p.last_route
    assert topi.shape == keep.shape == (S, min(k, E)) and keep.any()


def test_moe_gradients_match_jax_grad():
    """Gradients of gate, w1, b1, w2, b2 and x of (y² mean + 0.01 aux)."""
    p = _jmoe(6, 4, D=8, F=16)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (2, 8, 8)))

    def loss(p, x):
        y, aux = JM.moe_mlp(x, p, top_k=2, dtype=jnp.float32)
        return (y**2).mean() + 0.01 * aux

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, jnp.asarray(x))
    tp = _tmoe(p)
    tp.requires_grad_(True)
    tx = torch.tensor(x, requires_grad=True)
    y, aux = TM.moe_mlp(tx, tp, top_k=2, dtype=torch.float32)
    ((y**2).mean() + 0.01 * aux).backward()
    np.testing.assert_allclose(tp.gate.weight.grad.numpy().T, np.asarray(gp["gate"]["kernel"]), atol=1e-6)
    for k in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(getattr(tp, k).grad.numpy(), np.asarray(gp[k]), atol=1e-6, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), atol=1e-6)


# --- the MoE wav2vec2 --------------------------------------------------------------------------


def _moe_cfgs(dtype="float32"):
    kw = dict(num_experts=4, moe_top_k=2, dtype=dtype)
    return JW.make_config("tiny_test", **kw), TW.make_config("tiny_test", **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_wav2vec2_log_probs_match_jax(dtype):
    jcfg, tcfg = _moe_cfgs(dtype)
    tree = _w2v_tree(jcfg, 0)
    rng = np.random.RandomState(0)
    audio = (rng.randn(2, 6400) * 0.1).astype(np.float32)
    lens = np.array([6400, 4000], np.int32)
    taux = []

    def forward(p, a, n):
        aux = []
        return JW.ctc_log_probs(p, a, jcfg, n, aux_out=aux)[0], aux

    ref, jaux = jax.jit(forward)(tree, jnp.asarray(audio), jnp.asarray(lens))
    got, _ = TW.ctc_log_probs(wav2vec2_from_tree(tree), torch.tensor(audio), tcfg, torch.tensor(lens), aux_out=taux)
    got, ref = got.numpy(), np.asarray(ref)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=5e-5)
    else:
        # bf16 activations round at other places in the two packages (one
        # step here and there, test_torch_wav2vec2.py); a token whose two
        # best gates are that close may take another expert, so a few
        # frames move further than the dense model's 0.1
        assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.999
        assert (np.abs(got - ref) < 0.05).mean() > 0.98 and np.abs(got - ref).max() < 0.5
    assert len(taux) == len(jaux) == jcfg.num_layers
    np.testing.assert_allclose([float(a) for a in taux], [float(a) for a in jaux],
                               atol=1e-5 if dtype == "float32" else 2e-2)


def test_moe_wav2vec2_train_steps_match_ssak_tpu():
    """Three f32 steps of make_ctc_train_step with moe_aux_weight=0.01:
    loss 1e-5 and grad norm 1e-4 (relative), every parameter within lr."""
    from ssak_tpu.train import steps as JSt
    from ssak_tpu_torch.train import steps as TSt

    jcfg, tcfg = _moe_cfgs()
    lr = 1e-3
    tree = _w2v_tree(jcfg, 3)
    rng = np.random.RandomState(3)
    B = 3
    arrays = {"audio": (rng.randn(B, 6400) * 0.1).astype(np.float32),
              "audio_lengths": np.array([6400, 5000, 6400], np.int32),
              "labels": rng.randint(1, jcfg.vocab_size, (B, 6)).astype(np.int32),
              "label_lengths": np.array([6, 4, 5], np.int32)}
    jopt = JSt.make_optimizer(learning_rate=lr, warmup_steps=1, total_steps=10)
    topt = TSt.make_optimizer(learning_rate=lr, warmup_steps=1, total_steps=10)
    js = JSt.init_train_state(jax.tree_util.tree_map(jnp.asarray, tree), jopt)
    jstep = JSt.make_ctc_train_step(jcfg, jopt, moe_aux_weight=0.01)
    ts = TSt.init_train_state(wav2vec2_from_tree(tree), topt)
    tstep = TSt.make_ctc_train_step(tcfg, topt, moe_aux_weight=0.01)
    for _ in range(3):
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in arrays.items()})
        ts, tm = tstep(ts, {k: torch.tensor(v) for k, v in arrays.items()})
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
    ref = jax.tree_util.tree_leaves(js["params"])
    got = jax.tree_util.tree_leaves(wav2vec2_to_tree(ts["model"]))
    assert max(float(np.abs(np.asarray(a) - b).max()) for a, b in zip(ref, got)) <= lr


def test_encode_sp_refuses_moe_blocks():
    """An MoE layer routes over all of a batch's frames, so its blocks are
    not time-sharded (ssak_tpu's encode_sp has no MoE either): a
    ValueError before any collective."""
    from ssak_tpu_torch.parallel.sequence import encode_sp

    _, tcfg = _moe_cfgs()
    with pytest.raises(ValueError, match="MoE"):
        encode_sp(TW.init_params(tcfg, seed=0), torch.zeros(1, 3200), tcfg, mesh=None)


# --- trees both ways ---------------------------------------------------------------------------


def test_convert_moe_and_stacked_trees_both_ways():
    """An MoE tree, and ssak_tpu's layer-stacked layout of it
    (stack_wav2vec2_params, read by the port's own stack/unstack), go
    across and come back leaf for leaf."""
    from ssak_tpu.parallel.pipeline import stack_wav2vec2_params as jstack

    jcfg, _ = _moe_cfgs()
    tree = _w2v_tree(jcfg, 5)
    back = wav2vec2_to_tree(wav2vec2_from_tree(tree))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    blk = wav2vec2_from_tree(tree).encoder.blocks[0]
    assert blk.mlp is None and blk.moe.num_experts == 4 and tuple(blk.moe.w1.shape) == (4, 64, 128)
    stacked = _np(jstack(tree))
    ours = stack_wav2vec2_params(tree)
    for a, b in zip(jax.tree_util.tree_leaves(stacked), jax.tree_util.tree_leaves(ours)):
        np.testing.assert_array_equal(a, b)
    assert len(unstack_blocks(ours["encoder"]["blocks"])) == jcfg.num_layers
    from_stacked = wav2vec2_to_tree(wav2vec2_from_tree(stacked))
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(from_stacked)):
        np.testing.assert_array_equal(a, b)


# --- collectives and the optimizer's norm at world size 1 ---------------------------------------------


def test_collectives_are_identities_without_a_group():
    x = torch.randn(3, 4, requires_grad=True)
    for y in (collectives.all_reduce(x, None), collectives.copy_to_region(x, None), collectives.all_gather(x, 1, None),
              collectives.ppermute(x, [(0, 0)], None)):
        assert y is x
    assert not collectives.ppermute(x, [], None).any()


def test_clip_reads_a_given_norm_fn():
    """clip_by_global_norm clips by norm_fn(grads) where the caller gives
    one, through chain, inject_learning_rate and multi_steps (there on the
    mean gradient), and by the gradients' own norm otherwise."""
    from ssak_tpu_torch.train import optim

    g = {"a": torch.tensor([3.0, 4.0])}
    seen = []

    def norm_fn(grads):
        seen.append(grads["a"].clone())
        return torch.tensor(10.0)

    clip = optim.clip_by_global_norm(1.0)
    np.testing.assert_allclose(clip.update(g, None, None)[0]["a"].numpy(), [0.6, 0.8])
    np.testing.assert_allclose(clip.update(g, None, None, norm_fn)[0]["a"].numpy(), [0.3, 0.4])
    sgd = optim.chain(clip, optim.scale_by_learning_rate(1.0))
    np.testing.assert_allclose(sgd.update(g, sgd.init(g), g, norm_fn)[0]["a"].numpy(), [-0.3, -0.4])
    inj = optim.inject_learning_rate(lambda lr: optim.chain(optim.clip_by_global_norm(1.0),
                                                            optim.scale_by_learning_rate(lr)), 2.0)
    np.testing.assert_allclose(inj.update(g, inj.init(g), g, norm_fn)[0]["a"].numpy(), [-0.6, -0.8])
    acc = optim.multi_steps(sgd, 2)
    state = acc.init(g)
    u, state = acc.update(g, state, g, norm_fn)
    assert not u["a"].any() and len(seen) == 3
    u, state = acc.update({"a": torch.tensor([1.0, 2.0])}, state, g, norm_fn)
    np.testing.assert_allclose(seen[-1].numpy(), [2.0, 3.0])  # the clip saw the mean gradient
    np.testing.assert_allclose(u["a"].numpy(), [-0.2, -0.3])
