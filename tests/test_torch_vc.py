"""The port's voice converter (ssak_tpu_torch.augment.vc and python -m
ssak_tpu_torch.tools.convert_voice) against ssak_tpu's on the CPU, at small
widths (hidden 16, 2 blocks, 1 s clips), from ssak_tpu's seeded parameters
moved across (vc_from_tree).

Tolerances: the STFT and mel products sum in another order than XLA's
(1e-5 of the largest value; the log-mel 1e-4 absolute, where log(mel +
1e-5) magnifies the quietest bins).

The converter is held on its own delta, vc_forward(x) - x - voice, so the
identity residual (log-mel values near -11) does not set the scale. With
no block the two agree to 1.4e-6 of the delta's largest value (6 voices,
one clip and a batch of two each), so the bound is 5e-6. Each block's
layer norm divides by sqrt(var + 1e-5) over 16 channels, up to 316x, and
frames whose channels nearly agree take that gain: stage by stage, on one
voice, the two agree to 2.7e-7 up to the first norm, 2.5e-5 after it and
6.6e-4 after the second (ssak_tpu's delta is 7.3e-4 off an f64 witness,
the port's 2e-4).
So one block takes 5e-5 (readings to 1.2e-5), two blocks 1e-3 (readings
6.9e-5 to 7.3e-4). The exact GELU in place of the tanh form gives
1.7e-4 / 1.4e-2 / 3.2e-2 at least at 0 / 1 / 2 blocks: each bound fails it.

Griffin-Lim runs 32 iterations through atan2 from zero phase, and the two
drift apart, so its waveforms are compared by correlation (>= 0.999).
Three training steps: losses to 1e-5 relative, weights to 1e-4. Kaldi-dir
conversion: ssak_tpu's files (ids, speakers, texts, durations) exactly,
its waveforms by correlation."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssak_tpu.augment import vc as JV
from ssak_tpu_torch.audio import load_audio, save_audio
from ssak_tpu_torch.augment import vc as TV

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN, BLOCKS = 16, 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _voice(seed, seconds=1.0):
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    f0 = rng.uniform(110, 220)
    x = sum(0.2 / k * np.sin(2 * np.pi * k * f0 * t * (1 + 0.02 * np.sin(2 * np.pi * 2 * t))) for k in range(1, 6))
    return (x * (0.6 + 0.4 * np.sin(2 * np.pi * 1.5 * t)) + 0.005 * rng.randn(t.size)).astype(np.float32)


def _corr(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.dot(a - a.mean(), b - b.mean()) / (np.std(a) * np.std(b) * a.size))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def params():
    """ssak_tpu's seeded converter and the port's copy on the CPU."""
    p = JV.init_vc_params(jax.random.PRNGKey(0), n_mels=80, hidden=HIDDEN, blocks=BLOCKS)
    # move the zero-initialised leaves too, so every leaf's path is checked
    p = jax.tree_util.tree_map(lambda a: a + 0.01 * jnp.arange(a.size, dtype=a.dtype).reshape(a.shape) / a.size, p)
    return p, TV.vc_from_tree(jax.tree_util.tree_map(np.asarray, p), device="cpu")


def test_stft_istft_match_jax():
    x = _voice(0)
    jre, jim = JV.stft(jnp.asarray(x))
    tre, tim = TV.stft(torch.from_numpy(x))
    assert tre.shape == jre.shape == (101, 201)
    assert _rel(tre, jre) <= 1e-5 and _rel(tim, jim) <= 1e-5
    want = JV.istft(jre, jim, x.size)
    got = TV.istft(torch.from_numpy(np.array(jre)), torch.from_numpy(np.array(jim)), x.size)
    assert got.shape == (x.size,) and _rel(got, want) <= 1e-5 and _rel(got, x) <= 1e-4  # a perfect reconstruction
    # a batch of two: each row as alone
    xb = np.stack([x, _voice(1)])
    bre, bim = TV.stft(torch.from_numpy(xb))
    assert torch.equal(bre[0], tre) and _rel(TV.istft(bre, bim, x.size)[1], _voice(1)) <= 1e-4


def test_logmel_and_griffin_lim_match_jax():
    x = _voice(2)
    want = np.asarray(JV.audio_to_logmel(jnp.asarray(x), 80))
    got = TV.audio_to_logmel(torch.from_numpy(x), 80).numpy()
    assert got.shape == want.shape == (101, 80)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    jre, jim = JV.stft(jnp.asarray(x))
    mag = np.sqrt(np.asarray(jre) ** 2 + np.asarray(jim) ** 2)
    for iters in (1, 32):
        w = np.asarray(JV.griffin_lim(jnp.asarray(mag), x.size, iters=iters))
        g = TV.griffin_lim(torch.from_numpy(mag), x.size, iters=iters).numpy()
        assert g.shape == w.shape and _corr(g, w) >= 0.999, iters
    w = np.asarray(JV.logmel_to_audio(jnp.asarray(want), x.size, iters=8))
    g = TV.logmel_to_audio(torch.from_numpy(want), x.size, iters=8).numpy()
    assert _corr(g, w) >= 0.999


def _delta_err(jp, model, seeds):
    """The largest gap of the port's vc_forward delta from ssak_tpu's,
    over each voice's clip and a batch of two, relative to the delta's
    largest value."""
    voice = np.asarray(jp["voice"], np.float64)
    errs = []
    for seed in seeds:
        mel = np.asarray(JV.audio_to_logmel(jnp.asarray(_voice(seed)), 80))
        for x in (mel, np.stack([mel, mel[::-1].copy()])):
            want = np.asarray(JV.vc_forward(jp, jnp.asarray(x)), np.float64) - x - voice
            with torch.no_grad():
                got = TV.vc_forward(model, torch.from_numpy(x)).numpy()
            assert got.shape == x.shape and got.dtype == np.float32
            errs.append(np.abs(got - x - voice - want).max() / np.abs(want).max())
    return max(errs)


def test_vc_forward_matches_jax(params):
    jp, model = params
    assert _delta_err(jp, model, (3, 4, 5, 6)) <= 1e-3


@pytest.mark.parametrize("blocks,bound", [(0, 5e-6), (1, 5e-5)])
def test_vc_forward_before_the_layer_norm_gain_matches_jax(blocks, bound):
    """With fewer layer norms the delta agrees more closely (module
    docstring): no block, then one."""
    p = JV.init_vc_params(jax.random.PRNGKey(0), n_mels=80, hidden=HIDDEN, blocks=blocks)
    p = jax.tree_util.tree_map(lambda a: a + 0.01 * jnp.arange(a.size, dtype=a.dtype).reshape(a.shape) / a.size, p)
    model = TV.vc_from_tree(jax.tree_util.tree_map(np.asarray, p), device="cpu")
    assert len(model.blocks) == blocks
    assert _delta_err(p, model, (3, 4, 5, 6, 7, 8)) <= bound


def test_train_voice_converter_matches_jax():
    """3 steps from ssak_tpu's init (moved across), one numpy generator for
    the crops and warps: the same losses and weights."""
    audios = [_voice(s, secs) for s, secs in ((4, 1.4), (5, 0.7), (6, 1.0))]
    kw = dict(steps=3, hidden=HIDDEN, blocks=BLOCKS, segment_s=1.0, batch=2, seed=1, log_every=0)
    jp, jl = JV.train_voice_converter(audios, **kw)
    init = JV.init_vc_params(jax.random.PRNGKey(1), n_mels=80, hidden=HIDDEN, blocks=BLOCKS)
    model, tl = TV.train_voice_converter(audios, device="cpu", params=TV.vc_from_tree(
        jax.tree_util.tree_map(np.asarray, init), device="cpu"), **kw)
    assert len(tl) == 3 and all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jp))
    got = jax.tree_util.tree_leaves(TV.vc_to_tree(model))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    with pytest.raises(ValueError):
        TV.train_voice_converter([np.zeros(100, np.float32)], steps=1, device="cpu")


def test_vc_npz_files_read_both_ways(params, tmp_path):
    jp, model = params
    TV.save_vc(model, str(tmp_path / "t.npz"))
    back = JV.load_vc(str(tmp_path / "t.npz"))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jp)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jp)))
    JV.save_vc(jp, str(tmp_path / "j.npz"))
    with np.load(tmp_path / "j.npz") as jz, np.load(tmp_path / "t.npz") as tz:
        assert sorted(jz.files) == sorted(tz.files)
    got = TV.load_vc(str(tmp_path / "j.npz"), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(got.state_dict().values(), model.state_dict().values()))


def _kaldi_dir(root):
    """Two recordings of 1.2 s under a segments file of three utterances."""
    os.makedirs(root, exist_ok=True)
    for i in range(2):
        save_audio(os.path.join(root, f"r{i}.wav"), _voice(10 + i, 1.2), 16000)
    files = {"wav.scp": [f"r{i} {root}/r{i}.wav" for i in range(2)],
             "segments": ["a r0 0.0 0.7", "b r0 0.7 1.2", "c r1 0.1 1.1"],
             "text": ["a bonjour", "b à tous", "c merci"]}
    for name, lines in files.items():
        with open(os.path.join(root, name), "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    return str(root)


def test_convert_kaldi_dir_matches_jax(params, tmp_path):
    jp, _ = params
    src = _kaldi_dir(str(tmp_path / "in"))
    models = []
    for k in range(2):
        p = jax.tree_util.tree_map(lambda a, k=k: a * (1.0 + 0.1 * k), jp)
        JV.save_vc(p, str(tmp_path / f"m{k}.npz"))
        models.append(str(tmp_path / f"m{k}.npz"))
    JV.convert_kaldi_dir(src, models, str(tmp_path / "jax"), seed=2, gl_iters=4)
    TV.convert_kaldi_dir(src, models, str(tmp_path / "port"), seed=2, gl_iters=4, device="cpu")
    for name in ("text", "utt2spk", "utt2dur", "spk2utt", "wav.scp"):
        got = (tmp_path / "port" / name).read_text().replace(str(tmp_path / "port"), "OUT")
        want = (tmp_path / "jax" / name).read_text().replace(str(tmp_path / "jax"), "OUT")
        assert got == want, name
    ids = [ln.split()[0] for ln in (tmp_path / "port" / "text").read_text().splitlines()]
    assert len(ids) == 3 and {i[:4] for i in ids} <= {"vc0_", "vc1_"}
    for uid in ids:
        g = load_audio(str(tmp_path / "port" / "wavs" / f"{uid}.wav"))
        w = load_audio(str(tmp_path / "jax" / "wavs" / f"{uid}.wav"))
        assert g.shape == w.shape and _corr(g, w) >= 0.999, uid
    from ssak_tpu_torch.data.kaldi import check_kaldi_dir

    report = check_kaldi_dir(str(tmp_path / "port"), fix=False, compute_utt2dur=False)
    assert report["n_utts"] == 3 and not report["removed_utts"]


def test_convert_voice_cli_on_cpu_and_refused_without_a_card(tmp_path):
    """python -m ssak_tpu_torch.tools.convert_voice train, then convert,
    with --device cpu; without it, on a host without a card, each refuses."""
    spk = tmp_path / "spk"
    spk.mkdir()
    for i in range(2):
        save_audio(str(spk / f"s{i}.wav"), _voice(20 + i, 1.0), 16000)
    src = _kaldi_dir(str(tmp_path / "in"))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    base = [sys.executable, "-m", "ssak_tpu_torch.tools.convert_voice"]
    train = base + ["train", str(spk), "-o", str(tmp_path / "v.npz"), "--steps", "1", "--hidden", "8", "--blocks", "1"]
    out = subprocess.run(train + ["--device", "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0 and "final L1" in out.stdout, out.stderr[-3000:]
    from ssak_tpu_torch.tools import convert_voice

    convert_voice.main(["convert", src, str(tmp_path / "v.npz"), "-ok", str(tmp_path / "out"), "--gl_iters", "2",
                        "--device", "cpu"])
    assert len((tmp_path / "out" / "wav.scp").read_text().splitlines()) == 3
    if not torch.cuda.is_available():
        refused = subprocess.run(base + ["convert", src, str(tmp_path / "v.npz"), "-ok", str(tmp_path / "out2")],
                                 cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
        assert refused.returncode != 0 and "no CUDA device" in refused.stderr
        assert not (tmp_path / "out2").exists()
