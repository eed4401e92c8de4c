"""The port's Conformer-CTC (ssak_tpu_torch.models.conformer, its log-mel
frontend, layers.mlp's activation, the tree conversion and the conformer
family of the train and eval steps) against ssak_tpu's, on the same numpy
inputs and parameter trees.

Two configurations: `tiny_test` (RoPE attention, conv1d subsampling, the
conv module's LayerNorm, the Whisper frontend) and test_nemo_parity's
`_f32_cfg` (rel-pos attention, striding2d subsampling, the folded
BatchNorm affine, xscale, the NeMo frontend, the blank last), each in f32
and bf16. Every leaf of the tree is perturbed from its initial value, so
biases, pos_bias_u/v and the affine all count. Tolerances: f32 to 1e-4
absolute on log-probs and 1e-5 relative on activations (the same
arithmetic, sums in other orders); bf16 by correlation >= 0.999 (both round
activations to bf16 at the same points, but a value one rounding apart
propagates).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssak_tpu.models import conformer as JC
from ssak_tpu.models import layers as JL
from ssak_tpu.ops import logmel as JLM
from ssak_tpu.train import steps as JS
from ssak_tpu_torch.models import conformer as TC
from ssak_tpu_torch.models import layers as TL
from ssak_tpu_torch.models.convert import conformer_from_tree, conformer_to_tree, load_conformer_tree_, load_ctc_tree_
from ssak_tpu_torch.ops import logmel as TLM
from ssak_tpu_torch.train import steps as TS
from test_nemo_parity import _f32_cfg

KINDS = ("tiny", "nemo")
DTYPES = ("float32", "bfloat16")


def _cfgs(kind, dtype="float32"):
    jcfg = JC.make_config("tiny_test", dtype=dtype) if kind == "tiny" else _f32_cfg(dtype=dtype)
    return jcfg, TC.ConformerConfig(**dataclasses.asdict(jcfg))


def _tree(kind, seed=0):
    """ssak_tpu's init_params with every leaf moved by N(0, 0.02) (the
    running variance-like affine scale kept positive)."""
    jcfg, _ = _cfgs(kind)
    tree = jax.tree_util.tree_map(np.asarray, JC.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.RandomState(seed + 1)
    return jax.tree_util.tree_map(lambda a: (a + 0.02 * rng.randn(*a.shape)).astype(np.float32), tree)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(got, want, dtype, atol=1e-5, corr=0.999):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, atol=atol * scale, rtol=0)
    else:
        assert np.isfinite(got).all()
        c = np.corrcoef(got.ravel(), want.ravel())[0, 1]
        assert c >= corr, c


def _t(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(TC.ConformerConfig(dtype=dtype).compute_dtype)


def _j(a, dtype="float32"):
    return jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


# --- pieces -------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_rope_matches_jax(dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 37, 4, 16).astype(np.float32)
    pos = np.arange(37, dtype=np.float32)
    want = np.asarray(JC._rope(_j(x, dtype), jnp.asarray(pos)), np.float32)
    got = TC._rope(_t(x, dtype), torch.from_numpy(pos)).float().numpy()
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max())  # rotations of the same operands


@pytest.mark.parametrize("T,d", [(1, 64), (7, 64), (50, 64), (50, 512)])
def test_relpos_table_matches_jax(T, d):
    # sin and cos of the same f32 angles, up to one ulp of exp in the frequencies
    np.testing.assert_allclose(TC._relpos_table(T, d).numpy(), np.asarray(JC._relpos_table(T, d)), atol=1e-5)


@pytest.mark.parametrize("T", [1, 2, 9, 30])
def test_rel_shift_matches_jax(T):
    x = np.random.RandomState(T).randn(2, 3, T, 2 * T - 1).astype(np.float32)
    np.testing.assert_array_equal(TC._rel_shift(torch.from_numpy(x)).numpy(), np.asarray(JC._rel_shift(jnp.asarray(x))))


def _block_input(kind, B=3, T=23, seed=0):
    _, tcfg = _cfgs(kind)
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, tcfg.d_model).astype(np.float32)
    mask = np.arange(T)[None, :] < np.array([T, 17, 5])[:, None]
    return x, mask


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_attention_matches_jax(kind, dtype):
    """RoPE (tiny) or rel-pos (nemo) attention of block 1, ragged pad masks."""
    jcfg, tcfg = _cfgs(kind, dtype)
    tree = _tree(kind)
    x, mask = _block_input(kind)
    jfn, tfn = (JC._attention_rope, TC._attention_rope) if kind == "tiny" else (JC._attention_relpos, TC._attention_relpos)
    want = jfn(_j(x, dtype), _jtree(tree)["blocks"][1]["attn"], jcfg, jnp.asarray(mask))
    model = conformer_from_tree(tree)
    with torch.no_grad():
        got = tfn(_t(x, dtype), model.blocks[1].attn, tcfg, torch.from_numpy(mask))
    _close(got.float(), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_conv_module_matches_jax(kind, dtype):
    """GLU, pad frames zeroed before the depthwise conv, then the LayerNorm
    (tiny) or the folded affine (nemo)."""
    jcfg, tcfg = _cfgs(kind, dtype)
    tree = _tree(kind, seed=3)
    x, mask = _block_input(kind, seed=3)
    want = JC._conv_module(_j(x, dtype), _jtree(tree)["blocks"][0]["conv"], jcfg, jnp.asarray(mask))
    with torch.no_grad():
        got = TC._conv_module(_t(x, dtype), conformer_from_tree(tree).blocks[0].conv, tcfg, torch.from_numpy(mask))
    _close(got.float(), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_subsample_matches_jax(kind, dtype):
    """conv1d (tiny) or striding2d with its channel-major flatten (nemo)."""
    jcfg, tcfg = _cfgs(kind, dtype)
    tree = _tree(kind, seed=4)
    mel = np.random.RandomState(4).randn(2, tcfg.n_mels, 61).astype(np.float32)
    want = JC.subsample(_jtree(tree), jnp.asarray(mel), jcfg)
    with torch.no_grad():
        got = TC.subsample(conformer_from_tree(tree), torch.from_numpy(mel), tcfg)
    _close(got.float(), want, dtype)


def test_mlp_with_swish_matches_jax():
    rng = np.random.RandomState(5)
    tree = {"fc1": JL.linear_init(jax.random.PRNGKey(1), 16, 32), "fc2": JL.linear_init(jax.random.PRNGKey(2), 32, 16)}
    x = rng.randn(3, 7, 16).astype(np.float32)
    want = JL.mlp(jnp.asarray(x), tree, dtype=jnp.float32, activation=JC._swish)
    p = TL.MLP(TL.Linear(torch.from_numpy(np.asarray(tree["fc1"]["kernel"]).T.copy()), torch.zeros(32)),
               TL.Linear(torch.from_numpy(np.asarray(tree["fc2"]["kernel"]).T.copy()), torch.zeros(16)))
    got = TL.mlp(torch.from_numpy(x), p, dtype=torch.float32, activation=TC._swish)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    gelu = TL.mlp(torch.from_numpy(x), p, dtype=torch.float32)  # the default stays GELU
    np.testing.assert_allclose(gelu.numpy(), np.asarray(JL.mlp(jnp.asarray(x), tree, dtype=jnp.float32)), atol=1e-5)


def test_dft_matrices_match_jax():
    for args in ((400,), (512, 400), (512,)):
        for a, b in zip(TLM.dft_matrices(*args), JLM.dft_matrices(*args)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [16000, 16123, 40000])
def test_nemo_log_mel_matches_jax(n):
    """Ragged sample lengths (a full row, a shorter one, a 1-sample dummy):
    frame lengths exact, features to 2e-4 (normalised to unit variance; the
    DFT matmuls sum in other orders)."""
    rng = np.random.RandomState(n)
    audio = (0.1 * rng.randn(3, n)).astype(np.float32)
    lens = np.array([n, n - 5001, 1], np.int32)
    want, wfl = JLM.nemo_log_mel_spectrogram(jnp.asarray(audio), n_mels=80, sample_lengths=jnp.asarray(lens))
    got, gfl = TLM.nemo_log_mel_spectrogram(torch.from_numpy(audio), n_mels=80, sample_lengths=torch.from_numpy(lens))
    np.testing.assert_array_equal(gfl.numpy(), np.asarray(wfl))
    assert got.shape == want.shape == (3, 80, n // 160 + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_frame_counts_match_jax():
    for kind in KINDS:
        jcfg, tcfg = _cfgs(kind)
        for n in (0, 1, 159, 160, 16000, 240000, 2240400):
            assert TC.mel_frame_count(tcfg, n) == JC.mel_frame_count(jcfg, n)
        for f in range(0, 40):
            assert TC.subsampled_length(tcfg, f) == JC.subsampled_length(jcfg, f)
        f = np.arange(40, dtype=np.int32)
        np.testing.assert_array_equal(TC.subsampled_length(tcfg, torch.from_numpy(f)).numpy(),
                                      np.asarray(JC.subsampled_length(jcfg, jnp.asarray(f))))


# --- the whole model ----------------------------------------------------------------


def _audio(B=3, n=16000, seed=0):
    rng = np.random.RandomState(seed)
    audio = (0.1 * rng.randn(B, n)).astype(np.float32)
    lens = np.array([n, n - 4000, 6000][:B], np.int32)
    audio[np.arange(n)[None, :] >= lens[:, None]] = 0
    return audio, lens


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_encode_matches_jax(kind, dtype):
    """encode from mel with ragged frame lengths and a time mask."""
    jcfg, tcfg = _cfgs(kind, dtype)
    tree = _tree(kind, seed=6)
    rng = np.random.RandomState(6)
    F = 101
    mel = rng.randn(3, tcfg.n_mels, F).astype(np.float32)
    fl = np.array([F, 80, 33], np.int32)
    tm = rng.rand(3, 26) < 0.2
    want, wl = JC.encode(_jtree(tree), jnp.asarray(mel), jcfg, jnp.asarray(fl), time_mask=jnp.asarray(tm))
    with torch.no_grad():
        got, gl = TC.encode(conformer_from_tree(tree), torch.from_numpy(mel), tcfg, torch.from_numpy(fl),
                            time_mask=torch.from_numpy(tm))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    _close(got.float(), want, dtype, atol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_ctc_log_probs_matches_jax(kind, dtype):
    """Waveform to log-probs, ragged lengths: f32 to 1e-4 absolute, bf16
    correlation >= 0.999; the frame lengths exact."""
    jcfg, tcfg = _cfgs(kind, dtype)
    tree = _tree(kind, seed=7)
    audio, lens = _audio(seed=7)
    want, wl = JC.ctc_log_probs(_jtree(tree), jnp.asarray(audio), jcfg, jnp.asarray(lens))
    with torch.no_grad():
        got, gl = TC.ctc_log_probs(conformer_from_tree(tree), torch.from_numpy(audio), tcfg, torch.from_numpy(lens))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    assert got.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    else:
        _close(got, want, dtype)


@pytest.mark.parametrize("kind", KINDS)
def test_tree_round_trip_and_in_place_load(kind):
    tree = _tree(kind, seed=8)
    back = conformer_to_tree(conformer_from_tree(tree))
    a, b = jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(back)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    _, tcfg = _cfgs(kind)
    m = TC.init_params(tcfg, seed=9)
    load_ctc_tree_(m, tree)
    assert all(np.array_equal(x, y) for x, y in zip(a, jax.tree_util.tree_leaves(conformer_to_tree(m))))
    other = _cfgs("nemo" if kind == "tiny" else "tiny")[1]
    with pytest.raises(ValueError):
        load_conformer_tree_(TC.init_params(other), tree)


@pytest.mark.parametrize("kind", KINDS)
def test_init_params_has_the_jax_tree_layout(kind):
    """The port's seeded model gives ssak_tpu's tree: same keys and shapes
    (the draws are the port's own generator's), zero biases and pos biases."""
    jcfg, tcfg = _cfgs(kind)
    want = JC.init_params(jax.random.PRNGKey(0), jcfg)
    got = conformer_to_tree(TC.init_params(tcfg, seed=0))
    assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(got)
    assert all(np.shape(x) == np.shape(y) for x, y in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)))
    assert not got["lm_head"]["bias"].any()
    if kind == "nemo":
        assert not got["blocks"][0]["attn"]["pos_bias_u"].any()


# --- train and eval steps (family="conformer") --------------------------------------------

LR, WD = 1e-3, 0.01


def _batch(cfg, seed=0, B=4, n=8000):
    """Ragged audio, labels in [0, V) without the blank, and one batch-pad
    dummy row (1 sample, label length 0), audio as int16 wire words."""
    rng = np.random.RandomState(seed)
    audio = np.clip(rng.randn(B, n) * 0.1, -1, 1).astype(np.float32)
    lens = np.array([n, 6000, 4000, 1], np.int32)[:B]
    audio[np.arange(n)[None, :] >= lens[:, None]] = 0
    labels = rng.randint(0, cfg.vocab_size, (B, 16)).astype(np.int32)
    labels[labels == cfg.blank_id] = (cfg.blank_id + 1) % cfg.vocab_size
    lab = np.array([5, 7, 3, 0], np.int32)[:B]
    labels[np.arange(16)[None, :] >= lab[:, None]] = 0
    wire = np.rint(audio * 32768).clip(-32768, 32767).astype(np.int16)
    arrays = {"audio": wire, "audio_lengths": lens, "labels": labels, "label_lengths": lab}
    return ({k: jnp.asarray(v) for k, v in arrays.items()}, {k: torch.from_numpy(v.copy()) for k, v in arrays.items()})


@pytest.mark.parametrize("kind", KINDS)
def test_train_steps_match_jax(kind):
    """Two f32 steps of make_ctc_train_step(family="conformer"), held as
    test_torch_train.py::test_train_steps_match_jax holds wav2vec2's: loss and
    grad norm to 1e-5 relative, every parameter within 0.3 lr (Adam divides a
    near-zero gradient entry by its own magnitude), the bulk within 1e-6.
    ssak_tpu's step runs eagerly (jax.disable_jit): jitted, XLA's CPU
    gradient of the one-channel Conv2d of striding2d is 1.3e-3 (relative)
    off its own eager one (the port is 3e-6 off the eager one), which flips
    the sign of Adam's first update on its smallest entries (2 lr apart)."""
    jcfg, tcfg = _cfgs(kind)
    tree = _tree(kind, seed=10)
    jb, tb = _batch(tcfg, seed=10)
    jopt = JS.make_optimizer(learning_rate=LR, warmup_steps=1, total_steps=10, weight_decay=WD)
    topt = TS.make_optimizer(learning_rate=LR, warmup_steps=1, total_steps=10, weight_decay=WD)
    js = JS.init_train_state(_jtree(tree), jopt)
    jstep = JS.make_ctc_train_step(jcfg, jopt, family="conformer")
    ts = TS.init_train_state(conformer_from_tree(tree), topt)
    tstep = TS.make_ctc_train_step(tcfg, topt, family="conformer")
    for _ in range(2):
        with jax.disable_jit():
            js, jm = jstep(js, jb)
        ts, tm = tstep(ts, tb)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
    assert ts["step"] == int(js["step"]) == 2
    ref = jax.tree_util.tree_leaves(js["params"])
    got = jax.tree_util.tree_leaves(conformer_to_tree(ts["model"]))
    diffs = np.concatenate([np.abs(np.asarray(a) - b).ravel() for a, b in zip(ref, got)])
    assert diffs.max() < 3e-4 and np.median(diffs) < 1e-6
    moved = max(float(np.abs(a - b).max()) for a, b in zip(got, jax.tree_util.tree_leaves(tree)))
    assert moved > 0


def test_train_step_time_mask_runs_over_subsampled_frames():
    """mask_time_prob > 0 masks the Conformer's subsampled frames (the draw is
    the port's generator's, so no parity with ssak_tpu's): a finite loss and
    a different one than without the mask."""
    _, tcfg = _cfgs("nemo")
    tree = _tree("nemo", seed=11)
    _, tb = _batch(tcfg, seed=11)
    losses = []
    for p in (0.0, 0.5):
        opt = TS.make_optimizer(learning_rate=LR, warmup_steps=1, total_steps=10)
        state = TS.init_train_state(conformer_from_tree(tree), opt)
        _, m = TS.make_ctc_train_step(tcfg, opt, mask_time_prob=p, mask_time_length=2, family="conformer")(state, tb)
        losses.append(m["loss"].item())
    assert all(np.isfinite(losses)) and losses[0] != losses[1]
    with pytest.raises(ValueError):
        TS.make_ctc_train_step(tcfg, opt, family="whisper")


@pytest.mark.parametrize("kind", KINDS)
def test_eval_step_matches_jax(kind):
    jcfg, tcfg = _cfgs(kind)
    tree = _tree(kind, seed=12)
    jb, tb = _batch(tcfg, seed=12)
    ref = JS.make_ctc_eval_step(jcfg, family="conformer")(_jtree(tree), jb)
    got = TS.make_ctc_eval_step(tcfg, family="conformer")(conformer_from_tree(tree), tb)
    np.testing.assert_allclose(got["loss"].item(), float(ref["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(ref["tokens"]))
    np.testing.assert_array_equal(got["token_lengths"].numpy(), np.asarray(ref["token_lengths"]))
