"""L1's backward in the port (ssak_tpu_torch.ops.flash_attention: the dK/dV
and dQ kernels' plain version, FlashSelfAttention's backward) against the
VJP of JAX's library Pallas flash attention, run by ssak_tpu's
`layers.flash_self_attention` in TPU interpret mode on the CPU; the
forward's row statistics against the library's residuals; one wav2vec2 train
step with the route forced on both sides; and CTCTrainer at a long bucket
going through FlashSelfAttention forward and backward.

On the CPU the wrappers take their plain versions (the library's arithmetic
over the whole (T, T) tile at once); the library sums per 128-key block in
another order, and its forward output (from which di is taken) normalises
per block. The gradients are bf16: held to 1e-2 absolute on every row, pad
rows included (they are O(1) here, and one bf16 step at 1 is 2**-8; the
largest difference measured is 3.9e-3)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as FA

from ssak_tpu.models import layers as JL
from ssak_tpu.models import wav2vec2 as JW
from ssak_tpu.train import steps as JS
from ssak_tpu_torch.models import layers as L
from ssak_tpu_torch.models import wav2vec2 as TW
from ssak_tpu_torch.models.convert import wav2vec2_from_tree, wav2vec2_to_tree
from ssak_tpu_torch.ops import flash_attention as L1
from ssak_tpu_torch.train import steps as TS

ATOL = 1e-2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(B, T, H, Dh, seed, n=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, T, H, Dh).astype(np.float32) for _ in range(n)]


def _bf16(*arrays):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]


def _lens(lengths):
    return None if lengths is None else torch.tensor(lengths, dtype=torch.int32)


CASES = [
    (2, 300, 2, 64, [300, 170]),   # padded to 384; a partly padded row
    (1, 256, 2, 64, None),         # T % 128 == 0, no lengths: no mask at all
    (2, 200, 2, 64, [0, 200]),     # a batch-pad row of length 0: all pad, finite
    (1, 130, 2, 128, [100]),       # Dh = 128
]


@pytest.mark.parametrize("B,T,H,Dh,lengths", CASES)
def test_backward_matches_jax_library_vjp_in_interpret_mode(B, T, H, Dh, lengths):
    """dq, dk, dv of autograd through the port's flash_self_attention (plain
    forward and backward on the CPU) against jax.vjp of ssak_tpu's, with dO
    on every row, the pad rows of [len, T) included."""
    q, k, v, do = _arrays(B, T, H, Dh, seed=T + Dh)
    jargs = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    jlens = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, b, c: JL.flash_self_attention(a, b, c, lengths=jlens), *jargs)
        ref = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do).astype(jnp.bfloat16))]
    tq, tk, tv = (t.requires_grad_(True) for t in _bf16(q, k, v))
    n0 = dict(L1.LAUNCHES)
    out = L1.flash_self_attention(tq, tk, tv, _lens(lengths))
    out.backward(_bf16(do)[0])
    assert L1.LAUNCHES == n0  # the CPU takes the plain versions: no launch
    for name, t, r in zip("qkv", (tq, tk, tv), ref):
        got = t.grad
        assert got.dtype == torch.bfloat16 and got.shape == (B, T, H, Dh), name
        got = got.float().numpy()
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, r, atol=ATOL, rtol=0, err_msg=f"d{name}")


def test_plain_backward_matches_autograd_of_unfused_attention():
    """With dO zero on the pad rows, every gradient of the segment-masked
    attention equals that of the unfused key-masked attention (valid queries
    see valid keys in both; pad queries add nothing). The unfused attention
    runs in f32 on the same bf16 values, the plain backward rounds p and ds
    to bf16 as the library does: 1e-2 absolute."""
    B, T, H, Dh = 2, 200, 2, 64
    lens = torch.tensor([200, 120])
    q, k, v, do = _bf16(*_arrays(B, T, H, Dh, seed=11))
    valid = (torch.arange(T)[None, :] < lens[:, None])
    do = do * valid[:, :, None, None]
    o, m, l = L1.flash_self_attention_reference(q, k, v, lens, return_stats=True)
    got = L1.flash_self_attention_backward_reference(q, k, v, o, m, l, do, lens)
    fq, fk, fv = (t.float().requires_grad_(True) for t in (q, k, v))
    out = L.attention(fq, fk, fv, mask=valid[:, None, None, :], dtype=torch.float32)
    out.backward(do.float())
    for name, g, t in zip("qkv", got, (fq, fk, fv)):
        torch.testing.assert_close(g.float(), t.grad, atol=ATOL, rtol=0, msg=f"d{name}")
    # the kernels' two plain versions give the same as the combined one
    di = L1.attention_di(o, do)
    dk, dv = L1.flash_attention_bwd_dkv(q, k, v, do, m, l, di, lens)
    dq = L1.flash_attention_bwd_dq(q, k, v, do, m, l, di, lens)
    for a, b in zip((dq, dk, dv), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,T,H,Dh,lengths", CASES[:3])
def test_row_stats_match_library_residuals(B, T, H, Dh, lengths):
    """m and l of the plain forward against the residuals the library's
    forward saves for its VJP (`_flash_attention_impl(save_residuals=True)`,
    lane 0), over the rows below T: m is a max of the same f32 products
    (1e-5), l the same sum of exponentials in another order (1e-5 relative)."""
    q, k, v = _arrays(B, T, H, Dh, seed=T + 3, n=3)
    Tp = L1.padded_len(T)
    jq, jk, jv = (jnp.pad(jnp.asarray(a).astype(jnp.bfloat16), ((0, 0), (0, Tp - T), (0, 0), (0, 0)))
                  .transpose(0, 2, 1, 3) for a in (q, k, v))
    seg = None
    if lengths is not None or Tp != T:
        lens = np.full(B, T) if lengths is None else np.asarray(lengths)
        valid = jnp.asarray((np.arange(Tp)[None, :] < lens[:, None]).astype(np.int32))
        seg = FA.SegmentIds(q=valid, kv=valid)
    bs = FA.BlockSizes.get_default(B, H, Tp, Tp, Dh)
    with pltpu.force_tpu_interpret_mode():
        _, jl, jm = FA._flash_attention_impl(jq, jk, jv, None, seg, True, False, Dh**-0.5, bs.block_b, bs.block_q,
                                             bs.block_k_major, bs.block_k, False)
    jl, jm = (np.asarray(a, np.float32).reshape(B, H, Tp, -1)[..., 0][:, :, :T] for a in (jl, jm))
    _, m, l = L1.flash_self_attention_reference(*_bf16(q, k, v), _lens(lengths), return_stats=True)
    assert m.shape == l.shape == (B, H, T) and m.dtype == l.dtype == torch.float32
    np.testing.assert_allclose(m.numpy(), jm, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(l.numpy(), jl, atol=0, rtol=1e-5)


# --- a wav2vec2 train step through the route, against ssak_tpu's ---------------------------


def _tiny(dtype="bfloat16", **kw):
    """tiny_test widened to Dh = 64 (hidden 128, 2 heads), one of L1's head dims."""
    over = dict(hidden_size=128, num_heads=2, intermediate_size=256, dtype=dtype, **kw)
    return JW.make_config("tiny_test", **over), TW.make_config("tiny_test", **over)


def _tree(cfg, seed=0):
    return jax.tree_util.tree_map(np.asarray, JW.init_params(jax.random.PRNGKey(seed), cfg))


def _batch(seed=0, n=6400):
    """Ragged audio (19 frames at the longest), ragged labels and a
    batch-pad dummy row (1 sample: a row of length < 0, all pad), int16 wire."""
    rng = np.random.RandomState(seed)
    audio = np.clip(rng.randn(4, n) * 0.1, -1, 1).astype(np.float32)
    lens = np.array([n, 5000, 4000, 1], np.int32)
    audio[np.arange(n)[None, :] >= lens[:, None]] = 0
    labels = rng.randint(4, 30, (4, 16)).astype(np.int32)
    lab = np.array([5, 7, 3, 0], np.int32)
    labels[np.arange(16)[None, :] >= lab[:, None]] = 0
    wire = np.rint(audio * 32768).clip(-32768, 32767).astype(np.int16)
    arrays = {"audio": wire, "audio_lengths": lens, "labels": labels, "label_lengths": lab}
    return ({k: jnp.asarray(v) for k, v in arrays.items()}, {k: torch.from_numpy(v.copy()) for k, v in arrays.items()})


class FlashSpy:
    """Counts the port's L1 forwards (keeping each one's m and l) and
    backwards while installed; the route itself is forced (_can_flash)."""

    def __init__(self, monkeypatch):
        self.stats, self.backwards = [], 0
        fwd, bwd = L1._flash_forward, L1.flash_attention_bwd_dq

        def forward(q, k, v, lengths, scale, stats=False):
            out = fwd(q, k, v, lengths, scale, stats)
            if stats:
                self.stats.append((tuple(q.shape), out[1].clone(), out[2].clone()))
            return out

        def backward(*a, **kw):
            self.backwards += 1
            return bwd(*a, **kw)

        monkeypatch.setattr(L, "_can_flash", lambda q, dtype: True)
        monkeypatch.setattr(L1, "_flash_forward", forward)
        monkeypatch.setattr(L1, "flash_attention_bwd_dq", backward)  # one call per backward


LR = 1e-3


def _port_step(tcfg, tree, tb):
    opt = TS.make_optimizer(learning_rate=LR, warmup_steps=0, total_steps=10, schedule="constant")
    state, step = TS.init_train_state(wav2vec2_from_tree(tree), opt), TS.make_ctc_train_step(tcfg, opt)
    state, metrics = step(state, tb)
    return {k: v.item() for k, v in metrics.items()}, wav2vec2_to_tree(state["model"])


def _leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


def test_wav2vec2_train_step_through_flash_matches_jax(monkeypatch):
    """One bf16 train step with L1 forced on both sides: ssak_tpu's through
    the library kernel and its VJP in interpret mode (its CTC loss kept on
    the plain scan it runs off the TPU), the port's through
    FlashSelfAttention's plain forward and backward, from one parameter
    tree. bf16 products round at the same places but sum in other orders:
    the loss to 1e-2 relative, the grad norm to 2e-2. Adam's first step
    moves each parameter by about lr times the sign of its gradient, so an
    entry whose gradient is near zero may move either way: every parameter
    within 2 lr, the median within lr / 100. Measured: loss 8.4e-5, grad
    norm 5.1e-4, parameters at most 2.0 lr apart, median 0."""
    from ssak_tpu.ops.ctc import ctc_loss as j_plain_ctc_loss

    cfg, tcfg = _tiny()
    tree = _tree(cfg, seed=3)
    jb, tb = _batch(seed=3)
    jopt = JS.make_optimizer(learning_rate=LR, warmup_steps=0, total_steps=10, schedule="constant")
    js = JS.init_train_state(jax.tree_util.tree_map(jnp.asarray, tree), jopt)
    jstep = JS.make_ctc_train_step(cfg, jopt)
    with monkeypatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        mp.setattr(JL, "FLASH_MIN_SEQ", 16)
        mp.setattr(JS, "ctc_loss", j_plain_ctc_loss)
        calls = []
        real = JL.flash_self_attention
        mp.setattr(JL, "flash_self_attention", lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))
        with pltpu.force_tpu_interpret_mode():
            js, jm = jstep(js, jb)
            jm = {k: float(v) for k, v in jm.items()}
    assert len(calls) == cfg.num_layers  # traced once per block: ssak_tpu took the route
    spy = FlashSpy(monkeypatch)
    tm, tparams = _port_step(tcfg, tree, tb)
    assert len(spy.stats) == spy.backwards == tcfg.num_layers
    assert abs(tm["loss"] - jm["loss"]) <= 1e-2 * abs(jm["loss"])
    assert abs(tm["grad_norm"] - jm["grad_norm"]) <= 2e-2 * jm["grad_norm"]
    diffs = np.concatenate([np.abs(a - b).ravel() for a, b in zip(_leaves(js["params"]), _leaves(tparams))])
    assert diffs.max() <= 2 * LR and np.median(diffs) <= LR / 100


def test_remat_train_step_equals_plain_and_recomputes_the_same_stats(monkeypatch):
    """With remat, each block's forward (L1 included) runs again inside the
    backward: twice the forward calls, the same m and l the first forward
    saved (bit-exact on the CPU), and the same step."""
    _, tcfg = _tiny()
    _, rcfg = _tiny(remat=True)
    tree = _tree(_tiny()[0], seed=4)
    _, tb = _batch(seed=4)
    spy = FlashSpy(monkeypatch)
    plain = _port_step(tcfg, tree, tb)
    n = tcfg.num_layers
    assert len(spy.stats) == spy.backwards == n
    spy.stats.clear()
    spy.backwards = 0
    remat = _port_step(rcfg, tree, tb)
    assert len(spy.stats) == 2 * n and spy.backwards == n
    for i in range(n):  # forwards 0..n-1, then the backward recomputes blocks n-1..0
        first, again = spy.stats[i], spy.stats[2 * n - 1 - i]
        assert first[0] == again[0] and torch.equal(first[1], again[1]) and torch.equal(first[2], again[2])
    assert plain[0] == remat[0]
    assert all(np.array_equal(a, b) for a, b in zip(_leaves(plain[1]), _leaves(remat[1])))


# --- CTCTrainer at a long bucket -----------------------------------------------------------


def _kaldi_dir(root, seconds, seed=0):
    from ssak_tpu_torch.audio import save_audio

    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    scp, text, dur = [], [], []
    for i, secs in enumerate(seconds):
        t = np.arange(int(secs * 16000)) / 16000
        audio = (0.2 * np.sin(2 * np.pi * (200 + 50 * i) * t) + 0.02 * rng.randn(t.size)).astype(np.float32)
        path = os.path.join(root, f"u{i}.wav")
        save_audio(path, audio, 16000)
        scp.append(f"u{i} {path}")
        text.append(f"u{i} " + " ".join("".join(rng.choice(list("abcdefgh"), 4)) for _ in range(int(2 * secs))))
        dur.append(f"u{i} {secs:.6f}")
    for name, lines in (("wav.scp", scp), ("text", text), ("utt2dur", dur)):
        with open(os.path.join(root, name), "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    return root


def test_ctc_trainer_long_bucket_goes_through_flash(tmp_path, monkeypatch):
    """CTCTrainer with buckets=(4.0,) (64,000 samples, 199 frames) and the
    route forced: every block's attention goes through FlashSelfAttention,
    forward and backward, at the bucket's frames; the logged steps match the
    unforced trainer's (the unfused attention) from the same weights: both
    give valid frames the same attention, and the loss reads only those
    (bf16 compute: 1e-2 relative on the loss, 2e-2 on the grad norm)."""
    from ssak_tpu_torch.data.dataset import kaldi_folder_to_manifest
    from ssak_tpu_torch.models.tokenizer import CTCTokenizer
    from ssak_tpu_torch.train.loop import CTCTrainer

    _, rows = kaldi_folder_to_manifest(_kaldi_dir(str(tmp_path / "data"), [2.5, 3.0, 3.5, 4.0, 1.5]))
    tok = CTCTokenizer.from_corpus([r["text"] for r in rows])
    _, tcfg = _tiny(vocab_size=max(32, len(tok)))
    kw = dict(learning_rate=1e-3, warmup_steps=0, total_steps=2, batch_size=4, eval_steps=0, mask_time_prob=0.0,
              buckets=(4.0,), seed=1, device="cpu")

    def train(out):
        tr = CTCTrainer(tcfg, TW.init_params(tcfg, seed=5), tok, str(tmp_path / out), **kw)
        return [h for h in tr.train(rows, max_steps=2, log_interval=1, final_save=False) if "loss" in h]

    unforced = train("unfused")
    spy = FlashSpy(monkeypatch)
    forced = train("flash")
    frames = TW.feature_extract_output_length(tcfg, 64000)
    assert frames == 199
    assert [s[0] for s in spy.stats] == [(4, frames, 2, 64)] * (2 * tcfg.num_layers)
    assert spy.backwards == 2 * tcfg.num_layers
    assert [h["step"] for h in forced] == [h["step"] for h in unforced] == [1, 2]
    for a, b in zip(forced, unforced):
        assert abs(a["loss"] - b["loss"]) <= 1e-2 * b["loss"]
        assert abs(a["grad_norm"] - b["grad_norm"]) <= 2e-2 * b["grad_norm"]


def test_140s_bucket_shapes_fit_the_kernels():
    """At CTCTrainer(buckets=(140.0,)): 2,240,000 samples a row, 6,999 frames
    through xlsr's conv stack, a label width of 2,048 at ~14 chars/s (S =
    4,097 CTC states), which K1's one block takes in shared memory."""
    from types import SimpleNamespace

    from ssak_tpu_torch.data.dataset import padded_batch
    from ssak_tpu_torch.models.tokenizer import CTCTokenizer
    from ssak_tpu_torch.ops import ctc_fused as K1
    from ssak_tpu_torch.train.loop import CTCTrainer

    x, lens = padded_batch([np.ones(100 * 16000, np.float32), np.ones(1, np.float32)], int(round(140.0 * 16000)))
    assert x.shape == (2, 2_240_000) and lens.tolist() == [1_600_000, 1]
    cfg = TW.make_config("xlsr")
    assert TW.feature_extract_output_length(cfg, 2_240_000) == 6999
    rng = np.random.RandomState(140)
    text = " ".join("".join(rng.choice(list("abcdefgh"), 6)) for _ in range(280))  # 1,959 chars in 140 s
    rows = [{"text": text}, {"text": text[:700]}]
    # the trainer's own label encoding, on a stand-in holding only what it reads
    trainer = SimpleNamespace(tokenizer=CTCTokenizer.from_corpus([text]), normalize_text=lambda t: t)
    labels, label_lens = CTCTrainer._encode_labels(trainer, rows)
    assert label_lens.tolist() == [1959, 700] and labels.shape == (2, 2048)
    assert K1.smem_bytes(2 * labels.shape[1] + 1, 32) == (4 * 4097 + 2 * 32) * 4 <= K1.SMEM_LIMIT
