"""The port's wav2vec2 (ssak_tpu_torch.models.wav2vec2) and the layers it
adds, against ssak_tpu on the CPU: the same numpy-made parameter tree and
inputs through both packages. jax.random bits are not reproduced, so time
masks are passed explicitly to both; the port's own mask is tested for its
count and span rule."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssak_tpu.models import layers as JL
from ssak_tpu.models import wav2vec2 as JW
from ssak_tpu_torch.models import layers as L
from ssak_tpu_torch.models import wav2vec2 as TW
from ssak_tpu_torch.models.convert import load_wav2vec2_tree_, wav2vec2_from_tree, wav2vec2_to_tree

VARIANTS = {
    "base": dict(),
    "stable": dict(do_stable_layer_norm=True, conv_bias=True),
    "stable_remat_adapters": dict(do_stable_layer_norm=True, conv_bias=True, remat=True, adapter_attn_dim=8),
    "base_remat_adapters": dict(remat=True, adapter_attn_dim=8),
}


def _tree(cfg, seed=0):
    return jax.tree_util.tree_map(np.asarray, JW.init_params(jax.random.PRNGKey(seed), cfg))


def _inputs(cfg, seed=0):
    rng = np.random.RandomState(seed)
    audio = (rng.randn(3, 6400) * 0.1).astype(np.float32)
    lens = np.array([6400, 4000, 1], np.int32)  # the last is a batch-pad dummy (-1 frames)
    mask = rng.rand(3, JW.feature_extract_output_length(cfg, 6400)) < 0.25
    return audio, lens, mask


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_ctc_log_probs_f32_matches_jax(variant):
    kw = VARIANTS[variant]
    cfg = JW.make_config("tiny_test", dtype="float32", **kw)
    tcfg = TW.make_config("tiny_test", dtype="float32", **kw)
    tree = _tree(cfg)
    audio, lens, mask = _inputs(cfg)
    ref, ref_fl = JW.ctc_log_probs(tree, jnp.asarray(audio), cfg, jnp.asarray(lens), time_mask=jnp.asarray(mask))
    got, fl = TW.ctc_log_probs(wav2vec2_from_tree(tree), torch.from_numpy(audio), tcfg, torch.from_numpy(lens),
                               time_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(fl.numpy(), np.asarray(ref_fl))
    assert list(fl.numpy()) == [19, 12, -1]
    # f32 throughout; convolutions and products sum in other orders
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=5e-5)


@pytest.mark.parametrize("variant", ["base", "stable_remat_adapters"])
def test_ctc_log_probs_bf16_close_to_jax(variant):
    kw = VARIANTS[variant]
    cfg = JW.make_config("tiny_test", **kw)
    tcfg = TW.make_config("tiny_test", **kw)
    tree = _tree(cfg, seed=1)
    audio, lens, mask = _inputs(cfg, seed=1)
    ref, _ = JW.ctc_log_probs(tree, jnp.asarray(audio), cfg, jnp.asarray(lens), time_mask=jnp.asarray(mask))
    got, _ = TW.ctc_log_probs(wav2vec2_from_tree(tree), torch.from_numpy(audio), tcfg, torch.from_numpy(lens),
                              time_mask=torch.from_numpy(mask))
    ref, got = np.asarray(ref)[:2], got.detach().numpy()[:2]
    # bf16 activations: the two packages round at other places (the port's
    # bf16 GEMM rounds before the bias, JAX after; gelu in bf16), one bf16
    # step (~0.4 %) here and there; hold the log-probs to 0.1 and to a
    # correlation above 0.999
    assert np.abs(got - ref).max() < 0.1
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.999


def test_remat_gives_the_same_gradient():
    cfg = TW.make_config("tiny_test", dtype="float32", do_stable_layer_norm=True)
    audio, lens, _ = _inputs(cfg)
    grads = []
    for remat in (False, True):
        m = TW.init_params(TW.make_config("tiny_test", dtype="float32", do_stable_layer_norm=True, remat=remat), seed=3)
        m.requires_grad_(True)
        lp, _ = TW.ctc_log_probs(m, torch.from_numpy(audio), m_cfg := TW.make_config("tiny_test", dtype="float32",
                                 do_stable_layer_norm=True, remat=remat), torch.from_numpy(lens))
        lp[:2].sum().backward()
        grads.append({n: p.grad.clone() for n, p in m.named_parameters()})
        assert m_cfg.remat == remat
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=0, atol=1e-6)


def test_frozen_feature_encoder_gets_no_gradient():
    cfg = TW.make_config("tiny_test", dtype="float32")
    m = TW.init_params(cfg, seed=0)
    m.requires_grad_(True)
    audio, lens, _ = _inputs(cfg)
    lp, _ = TW.ctc_log_probs(m, torch.from_numpy(audio), cfg, torch.from_numpy(lens), freeze_feature_encoder=True)
    lp.sum().backward()
    for n, p in m.named_parameters():
        assert (p.grad is None) == n.startswith("feature_extractor."), n


def test_tree_round_trip_and_in_place_load():
    cfg = JW.make_config("tiny_test", do_stable_layer_norm=True, conv_bias=True, adapter_attn_dim=8)
    tree = _tree(cfg)
    back = wav2vec2_to_tree(wav2vec2_from_tree(tree))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    m = TW.init_params(TW.make_config("tiny_test", do_stable_layer_norm=True, conv_bias=True, adapter_attn_dim=8), seed=5)
    load_wav2vec2_tree_(m, tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(wav2vec2_to_tree(m))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        load_wav2vec2_tree_(TW.init_params(TW.make_config("tiny_test"), seed=5), tree)


@pytest.mark.parametrize("preset", ["tiny_test", "base"])
def test_seeded_init_has_jax_shapes(preset):
    cfg = JW.make_config(preset)
    shapes = jax.eval_shape(lambda: JW.init_params(jax.random.PRNGKey(0), cfg))
    tcfg = TW.make_config(preset)
    m = TW.init_params(tcfg, seed=0)
    ours = wav2vec2_to_tree(m)
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(shapes)
    for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(shapes)):
        assert a.shape == b.shape
    again = wav2vec2_to_tree(TW.init_params(tcfg, seed=0))
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(again)))
    assert all(not p.requires_grad for p in m.parameters()), "parameters are created frozen"


def test_feature_extract_output_length_matches_jax():
    cfg = JW.make_config("base")
    tcfg = TW.make_config("base")
    for n in (1, 400, 16000, 240000):
        assert TW.feature_extract_output_length(tcfg, n) == JW.feature_extract_output_length(cfg, n)
    assert TW.feature_extract_output_length(tcfg, 240000) == 749
    assert TW.feature_extract_output_length(tcfg, 1) == -1
    t = TW.feature_extract_output_length(tcfg, torch.tensor([240000, 1, 64000]))
    assert t.tolist() == [749, -1, 199]


def test_group_norm_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 50, 12).astype(np.float32) * 3 + 1
    scale, bias = rng.randn(12).astype(np.float32), rng.randn(12).astype(np.float32)
    for groups in (12, 4):
        ref = JL.group_norm(jnp.asarray(x), {"scale": scale, "bias": bias}, num_groups=groups)
        got = L.group_norm(torch.from_numpy(x), L.LayerNorm(torch.from_numpy(scale), torch.from_numpy(bias)), num_groups=groups)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    # torch's own GroupNorm agrees (channels first)
    tg = torch.nn.functional.group_norm(torch.from_numpy(x).transpose(1, 2), 4, torch.from_numpy(scale), torch.from_numpy(bias))
    got = L.group_norm(torch.from_numpy(x), L.LayerNorm(torch.from_numpy(scale), torch.from_numpy(bias)), num_groups=4)
    np.testing.assert_allclose(got.numpy(), tg.transpose(1, 2).numpy(), atol=1e-5)


def test_mask_time_indices_count_and_spans():
    from ssak_tpu_torch.augment.specaugment import mask_time_indices

    gen = torch.Generator().manual_seed(0)
    B, T, length = 64, 749, 10
    m = mask_time_indices(gen, (B, T), mask_prob=0.05, mask_length=length)
    assert m.shape == (B, T) and m.dtype == torch.bool
    n_starts = int(0.05 * T / length)  # 3 spans of 10 frames per row, possibly overlapping
    for row in m:
        idx = torch.nonzero(row).flatten().tolist()
        runs = [r for r in np.split(np.array(idx), np.where(np.diff(idx) != 1)[0] + 1) if len(r)]
        assert 1 <= len(runs) <= n_starts
        assert all(len(r) >= length and len(r) % 1 == 0 for r in runs)
        assert length <= len(idx) <= n_starts * length and idx[-1] < T
    assert mask_time_indices(torch.Generator().manual_seed(0), (B, T)).equal(m)  # same seed, same mask
    assert mask_time_indices(gen, (2, 30), mask_prob=0.0).sum(1).tolist() == [10, 10]  # at least one span


class _OneRankMesh:
    """What shard_params reads of a DeviceMesh: one named dim of `size`,
    this rank at index 0, no process group (nothing is sent)."""

    def __init__(self, name, size):
        self.mesh_dim_names, self._size = (name,), size

    def size(self, i):
        return self._size

    def __getitem__(self, name):
        return type("Dim", (), {"get_group": staticmethod(lambda: None)})()

    def get_local_rank(self, name):
        return 0


def test_moe_and_unported_raise():
    """The Mixture-of-Experts FFN is ported (slice 8g): a seeded model and
    an ssak_tpu tree both build, each block's `moe` in place of its `mlp`.
    What stays unported still raises: a tensor-parallel cut of a leaf that
    only Whisper's decode shards (its token embedding, slice 8h)."""
    from ssak_tpu_torch.models import whisper as TWh
    from ssak_tpu_torch.parallel.mesh import shard_params
    from ssak_tpu_torch.parallel.sharding import WHISPER_RULES

    m = TW.init_params(TW.make_config("tiny_test", num_experts=2))
    assert all(b.mlp is None and b.moe.num_experts == 2 for b in m.encoder.blocks)
    cfg = JW.make_config("tiny_test", num_experts=2)
    blk = wav2vec2_from_tree(_tree(cfg)).encoder.blocks[0]
    assert blk.mlp is None and tuple(blk.moe.w1.shape) == (2, cfg.hidden_size, cfg.intermediate_size)
    wcfg = TWh.make_config("tiny_test")
    whisper = TWh.init_params(torch.Generator().manual_seed(0), wcfg)
    with pytest.raises(NotImplementedError, match="8h"):
        shard_params(whisper, _OneRankMesh("model", 2), WHISPER_RULES, num_heads=wcfg.n_audio_head)
