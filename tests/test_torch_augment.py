"""The port's waveform augmentation (ssak_tpu_torch.augment.SpeechAugment)
and `--data_augment` training against ssak_tpu's on the CPU.

SpeechAugment is host numpy and scipy with ssak_tpu's generators, drawn in
ssak_tpu's order: every transform, `__call__` and `augment_batch` give
ssak_tpu's waveforms bit for bit for the same seed, background noise and
reverberation included (a noise directory with a file at another rate, an
RIR directory read directly and through a Kaldi RIR list). CTCTrainer's
batches with an augmenter are ssak_tpu's bit for bit (wire words, lengths,
labels). The train CLI runs with --data_augment on the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssak_tpu.augment.speech import SpeechAugment as JAugment
from ssak_tpu_torch.audio import save_audio
from ssak_tpu_torch.augment import SpeechAugment, spec_augment

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRANSFORMS = ("gaussian_noise", "clipping", "band_stop", "gain", "pitch_shift", "background_noise", "reverberation")


@pytest.fixture(scope="module")
def sounds(tmp_path_factory):
    """(noise dir, rir dir): two noises (16 kHz, and 8 kHz which load_audio
    resamples), three RIRs, a Kaldi RIR list naming two of them (one by a
    relative path, one absolute) and a missing file."""
    root = tmp_path_factory.mktemp("sounds")
    rng = np.random.RandomState(0)
    noise, rir = root / "noise", root / "rir"
    (noise / "sub").mkdir(parents=True)
    (rir / "small").mkdir(parents=True)
    save_audio(str(noise / "babble.wav"), (0.1 * rng.randn(9000)).astype(np.float32), 16000)
    save_audio(str(noise / "sub" / "hum.wav"), (0.2 * np.sin(np.arange(3000) / 5.0)).astype(np.float32), 8000)
    (noise / "notes.txt").write_text("not audio")
    for i, n in enumerate((800, 1600, 400)):
        h = rng.randn(n) * np.exp(-np.arange(n) / (n / 6.0))
        save_audio(str(rir / "small" / f"r{i}.wav"), (0.5 * h / np.abs(h).max()).astype(np.float32), 16000)
    (rir / "rir_list").write_text(f"--rir-id r0 --room-id a small/r0.wav\n\n--rir-id r2 --room-id b {rir}/small/r2.wav\n"
                                  "--rir-id r9 --room-id c small/missing.wav\n")
    return str(noise), str(rir)


def _speech(seed, n=12000):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * rng.uniform(100, 400) * t) * (1 + np.sin(2 * np.pi * 3 * t))
            + 0.01 * rng.randn(n)).astype(np.float32)


def _pair(sounds, seed, lists=None, **kw):
    noise, rir = sounds
    return (SpeechAugment(noise_dir=noise, rir_dir=rir, rir_lists=lists, seed=seed, **kw),
            JAugment(noise_dir=noise, rir_dir=rir, rir_lists=lists, seed=seed, **kw))


@pytest.mark.parametrize("lists", [None, ["rir_list"], ["missing_list"]])
def test_files_found_match_jax(sounds, lists):
    t, j = _pair(sounds, 0, lists)
    assert t.noise_files == j.noise_files and len(t.noise_files) == 2
    assert t.rir_files == j.rir_files and len(t.rir_files) == {None: 3, "rir_list": 2}.get(lists and lists[0], 0)
    assert [f.__name__ for f in t.transforms] == [f.__name__ for f in j.transforms]


@pytest.mark.parametrize("name", TRANSFORMS)
def test_each_transform_bit_for_bit(sounds, name):
    for seed in (0, 1, 2):
        t, j = _pair(sounds, seed, ["rir_list"])
        for k in range(3):  # the generators stay in step across calls
            x = _speech(seed * 10 + k)
            got, want = getattr(t, name)(x), getattr(j, name)(x)
            assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want), (name, seed, k)


def test_time_stretch_bit_for_bit(sounds):
    t, j = _pair(sounds, 4)
    x = _speech(4)
    for factor in (None, 0.95, 1.05, None):
        (ga, gf), (wa, wf) = t.time_stretch(x, factor=factor), j.time_stretch(x, factor=factor)
        assert gf == wf and np.array_equal(ga, wa)


@pytest.mark.parametrize("apply_prob", [0.0, 0.5, 1.0])
def test_call_and_augment_batch_bit_for_bit(sounds, apply_prob):
    t, j = _pair(sounds, 7, None, apply_prob=apply_prob)
    for k in range(6):
        x = _speech(100 + k, 8000 + 997 * k)
        assert np.array_equal(t(x), j(x))
        assert np.array_equal(t(x, freeze_speed=1.0), j(x, freeze_speed=1.0))
    batch = [_speech(200 + k, 6000 + 1500 * k) for k in range(4)]
    for _ in range(3):
        got, want = t.augment_batch(batch), j.augment_batch(batch)
        assert len(got) == 4 and all(np.array_equal(a, b) for a, b in zip(got, want))
    # no noise and no RIRs: the five always-available transforms only
    t0, j0 = SpeechAugment(seed=3, apply_prob=1.0), JAugment(seed=3, apply_prob=1.0)
    assert len(t0.transforms) == 5
    for k in range(5):
        assert np.array_equal(t0(_speech(k)), j0(_speech(k)))


def _jax_draws(key, B, T, F, n_t, w_t, n_f, w_f):
    """ssak_tpu's spec_augment draws, read with its own key splits."""
    def axis(k, n, w, L):
        ks, kw = jax.random.split(k)
        return (np.asarray(jax.random.randint(ks, (B, n), 0, jnp.maximum(1, L - w))),
                np.asarray(jax.random.randint(kw, (B, n), 0, w + 1)))

    kt, kf = jax.random.split(key)
    return axis(kt, n_t, w_t, T) + axis(kf, n_f, w_f, F)


@pytest.mark.parametrize("shape,n_t,w_t,n_f,w_f", [((3, 60, 30), 2, 5, 2, 3), ((4, 50, 80), 2, 40, 2, 20),
                                                   ((2, 8, 6), 3, 12, 1, 9), ((2, 20, 10), 1, 0, 2, 1)])
def test_spec_augment_masks(shape, n_t, w_t, n_f, w_f):
    """The masking on ssak_tpu's own draws (jax.random, its key splits) is
    ssak_tpu's spec_augment bit for bit, widths of 0 and masks wider than
    their axis included; the port's spec_augment is its draw_masks (time,
    then frequency) fed to apply_masks, reproducible from the seed."""
    from ssak_tpu.augment.specaugment import spec_augment as j_spec_augment
    from ssak_tpu_torch.augment.specaugment import apply_masks, draw_masks

    B, T, F = shape
    x = (np.random.RandomState(B * T).randn(*shape) + 5.0).astype(np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(j_spec_augment(key, jnp.asarray(x), n_t, w_t, n_f, w_f, mask_value=-1.5))
        draws = [torch.from_numpy(np.array(a)) for a in _jax_draws(key, B, T, F, n_t, w_t, n_f, w_f)]
        got = apply_masks(torch.from_numpy(x), *draws, mask_value=-1.5).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), seed
        y = spec_augment(torch.Generator().manual_seed(seed), torch.from_numpy(x), n_t, w_t, n_f, w_f, -1.5)
        gen = torch.Generator().manual_seed(seed)
        ts, tw = draw_masks(gen, B, n_t, w_t, T)
        fs, fw = draw_masks(gen, B, n_f, w_f, F)
        assert torch.equal(y, apply_masks(torch.from_numpy(x), ts, tw, fs, fw, -1.5))


@pytest.mark.parametrize("w,L", [(5, 60), (40, 50), (12, 8), (0, 10), (3, 4)])
def test_spec_augment_draw_ranges_match_jax(w, L):
    """Over 4000 rows the port's starts take every value of ssak_tpu's
    range [0, max(1, L - w)) and no other, its widths every value of
    [0, w], as jax.random's draws do."""
    from ssak_tpu_torch.augment.specaugment import draw_masks

    starts, widths = draw_masks(torch.Generator().manual_seed(w * L), 2000, 2, w, L)
    jstarts, jwidths, _, _ = _jax_draws(jax.random.PRNGKey(w * L), 2000, L, 1, 2, w, 1, 0)
    want_s, want_w = set(range(max(1, L - w))), set(range(w + 1))
    assert set(np.unique(jstarts)) == want_s and set(np.unique(jwidths)) == want_w
    assert set(starts.unique().tolist()) == want_s and set(widths.unique().tolist()) == want_w
    assert starts.dtype == widths.dtype == torch.int64


# --- CTCTrainer and the CLI --------------------------------------------------------------------

TEXTS = ["bonjour tout le monde", "il fait beau", "le chat dort", "une souris verte", "merci bien", "à demain"]


def _kaldi_dir(root, n=6, seed=0):
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    scp, text = [], []
    for i in range(n):
        secs = 0.5 + 0.15 * i
        t = np.arange(int(secs * 16000)) / 16000
        audio = (0.2 * np.sin(2 * np.pi * (200 + 50 * i) * t) + 0.02 * rng.randn(t.size)).astype(np.float32)
        save_audio(os.path.join(root, f"u{i}.wav"), audio, 16000)
        scp.append(f"u{i} {root}/u{i}.wav")
        text.append(f"u{i} {TEXTS[i % len(TEXTS)]}")
    for name, lines in (("wav.scp", scp), ("text", text)):
        with open(os.path.join(root, name), "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    return str(root)


def test_trainer_batches_with_an_augmenter_match_jax(sounds, tmp_path):
    """Both trainers' _batches over one Kaldi dir, each with its package's
    SpeechAugment of one seed (apply_prob 1: every row transformed, one
    speed a batch): the same wire audio, lengths, labels and audio
    seconds, batch after batch, a shuffled epoch included."""
    from ssak_tpu.data.dataset import kaldi_folder_to_manifest as j_manifest
    from ssak_tpu.models import wav2vec2 as JW
    from ssak_tpu.models.tokenizer import CTCTokenizer as JTok
    from ssak_tpu.train.loop import CTCTrainer as JTrainer
    from ssak_tpu_torch.data.dataset import kaldi_folder_to_manifest
    from ssak_tpu_torch.models import wav2vec2 as TW
    from ssak_tpu_torch.models.tokenizer import CTCTokenizer
    from ssak_tpu_torch.train.loop import CTCTrainer

    d = _kaldi_dir(str(tmp_path / "data"))
    jcfg, tcfg = JW.make_config("tiny_test", dtype="float32"), TW.make_config("tiny_test", dtype="float32")
    kw = dict(batch_size=4, buckets=(1.0, 2.0), seed=3)
    taug, jaug = _pair(sounds, 11, ["rir_list"], apply_prob=1.0)
    jt = JTrainer(jcfg, JW.init_params(jax.random.PRNGKey(0), jcfg), JTok.from_corpus(TEXTS), str(tmp_path / "j"),
                  augmenter=jaug, **kw)
    tt = CTCTrainer(tcfg, TW.init_params(tcfg), CTCTokenizer.from_corpus(TEXTS), str(tmp_path / "t"), device="cpu",
                    augmenter=taug, **kw)
    _, jrows = j_manifest(d)
    _, trows = kaldi_folder_to_manifest(d)
    n = 0
    for shuffle in (None, 4):
        for (tb, treal, ts), (jb, jreal, js) in zip(tt._batches(trows, shuffle), jt._batches(jrows, shuffle),
                                                    strict=True):
            assert [r["id"] for r in treal] == [r["id"] for r in jreal] and ts == js
            for k in ("audio", "audio_lengths", "labels", "label_lengths"):
                want = np.asarray(jb[k])
                got = tb[k].numpy()
                assert got.dtype == want.dtype and np.array_equal(got, want), k
            n += 1
    assert n >= 4


def test_train_cli_with_data_augment_on_cpu(sounds, tmp_path):
    """python -m ssak_tpu_torch.train.cli --data_augment with noise and RIR
    directories, 2 steps and an evaluation on the seeded tiny wav2vec2."""
    noise, rir = sounds
    d = _kaldi_dir(str(tmp_path / "data"), n=4)
    cmd = [sys.executable, "-m", "ssak_tpu_torch.train.cli", d, d, "--output_dir", str(tmp_path / "runs"),
           "--batch_size", "4", "--max_steps", "2", "--eval_steps", "2", "--warmup_steps", "1", "--data_augment",
           "--data_augment_noise", noise, "--data_augment_rir", rir, "--device", "cpu"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    run_dir = json.loads(out.stdout.strip().splitlines()[-1])["run_dir"]
    with open(os.path.join(run_dir, "trainer_state.json")) as f:
        state = json.load(f)
    losses = [h["loss"] for h in state["log_history"] if "loss" in h]
    assert state["global_step"] == 2 and losses and all(np.isfinite(losses))
    assert any("eval_wer" in h for h in state["log_history"])
