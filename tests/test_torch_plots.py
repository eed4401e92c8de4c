"""The port's plotting modules (eval/plots, utils/viewer, utils/debug) and
`sak-wer --plot` against ssak_tpu's on this host, which has matplotlib.

Both packages draw the same figures with the same matplotlib calls, so the
PNG files are equal byte for byte, except the spectrogram: each package
draws its own log-mel (f32 sums in another order), so there the images
agree to one colour step in 1% of the pixels at most. Where matplotlib is
absent, every plotting call raises ImportError naming it. play_audio shells
out to the first player found, with ssak_tpu's command lines."""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

import ssak_tpu.eval.cli as JCLI
import ssak_tpu.eval.plots as JP
import ssak_tpu.utils.debug as JDBG
import ssak_tpu.utils.viewer as JV
import ssak_tpu_torch.eval.cli as TCLI
import ssak_tpu_torch.eval.plots as TP
import ssak_tpu_torch.utils.debug as TDBG
import ssak_tpu_torch.utils.viewer as TV
from ssak_tpu_torch.audio import save_audio
from test_torch_eval import HYPS, REFS

SR = 16000


def _audio(seconds=1.5, seed=0):
    t = np.arange(int(seconds * SR)) / SR
    rng = np.random.RandomState(seed)
    return (0.4 * np.sin(2 * np.pi * 220 * t) * (t < 1.0) + 0.05 * rng.randn(len(t))).astype(np.float32)


def _wer_results():
    from ssak_tpu.eval.wer import compute_wer

    return [compute_wer(REFS, HYPS), compute_wer(REFS, HYPS, normalization="fr", bootstrap_ci=True)]


def _trainer_state(run_dir, seed):
    rng = np.random.RandomState(seed)
    hist = [{"step": s, "loss": float(3 - 0.1 * s + 0.01 * rng.randn())} for s in range(1, 11)]
    hist += [{"step": s, "eval_wer": float(0.9 - 0.05 * s)} for s in (5, 10)]
    os.makedirs(run_dir)
    with open(os.path.join(run_dir, "trainer_state.json"), "w") as f:
        json.dump({"log_history": hist}, f)
    return run_dir


def _draw(kind, tmp_path, tag):
    """Draw `kind` with the package `tag` ('t' or 'j') into tmp_path."""
    P, V, D = (TP, TV, TDBG) if tag == "t" else (JP, JV, JDBG)
    out = str(tmp_path / f"{kind}_{tag}.png")
    if kind == "wer":
        res = _wer_results()
        assert P.plot_wer(res, names=["a", "b"], output=out) == out
        P.plot_wer(res[1], output=str(tmp_path / f"wer1_{tag}.png"))
    elif kind == "convergence":
        runs = [_trainer_state(str(tmp_path / tag / f"run{i}"), i) for i in range(2)]  # one legend: the dirs' names
        assert P.get_log_history(runs[0]) == P.get_log_history(os.path.join(runs[0], "trainer_state.json"))
        assert P.plot_convergence_curve(runs, output=out) == out
    elif kind == "waveform":
        segs = [{"start": 0.2, "end": 0.6, "label": "oui"}, {"start": 0.9, "end": 1.2}]
        assert V.plot_waveform(_audio(), segments=segs, output=out, title="t") == out
    elif kind == "spectrogram":
        assert V.plot_spectrogram(_audio(), output=out) == out
    elif kind == "logits":
        lp = np.log(np.random.RandomState(4).dirichlet(np.ones(12), size=(1, 60))).astype(np.float32)
        vocab = ["<pad>", "|"] + list("abcdefghij")
        assert D.plot_logits(lp, vocab=vocab, output=out) == out
        D.plot_logits(lp[0], output=str(tmp_path / f"logits2_{tag}.png"))
    return out


@pytest.mark.parametrize("kind", ["wer", "convergence", "waveform", "logits"])
def test_plots_equal_jax_s(tmp_path, kind):
    got, want = _draw(kind, tmp_path, "t"), _draw(kind, tmp_path, "j")
    assert os.path.getsize(got) > 1000
    assert open(got, "rb").read() == open(want, "rb").read()


def test_spectrogram_plot_matches_jax(tmp_path):
    import matplotlib.image as mpimg

    got, want = _draw("spectrogram", tmp_path, "t"), _draw("spectrogram", tmp_path, "j")
    a, b = mpimg.imread(got), mpimg.imread(want)
    assert os.path.getsize(got) > 1000 and a.shape == b.shape
    differ = np.abs(a - b).max(axis=-1) > 0
    assert differ.mean() <= 0.01 and np.abs(a - b).max() <= 1 / 255 + 1e-6, (differ.mean(), np.abs(a - b).max())


def test_sak_wer_plot_matches_jax(tmp_path):
    rf, hf = tmp_path / "ref.txt", tmp_path / "hyp.txt"
    rf.write_text("".join(f"{k} {v}\n" for k, v in REFS.items()), encoding="utf-8")
    hf.write_text("".join(f"{k} {v}\n" for k, v in HYPS.items()), encoding="utf-8")
    printed = []
    for tag, main, extra in (("t", TCLI.main, ["--device", "cpu"]), ("j", JCLI.main, [])):
        buf = io.StringIO()
        with redirect_stdout(buf):
            main([str(rf), str(hf), "--normalization", "fr", "--plot", str(tmp_path / f"w_{tag}.png")] + extra)
        printed.append(buf.getvalue())
    assert printed[0] == printed[1] and json.loads(printed[0])["wer"] > 0
    assert (tmp_path / "w_t.png").read_bytes() == (tmp_path / "w_j.png").read_bytes()


@pytest.mark.parametrize("kind", ["wer", "convergence", "waveform", "spectrogram", "logits"])
def test_plots_without_matplotlib_raise_by_name(tmp_path, monkeypatch, kind):
    for name in ("matplotlib", "matplotlib.pyplot"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError, match="matplotlib"):
        _draw(kind, tmp_path, "t")
    assert not (tmp_path / f"{kind}_t.png").exists()


def test_play_audio_shells_out_as_jax_does(tmp_path, monkeypatch):
    """The first player found gets ssak_tpu's command line (ffplay with
    -nodisp -autoexit); blocking runs it, else it is started; without a
    player the wav's path comes back all the same."""
    import shutil
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    wav = tmp_path / "in.wav"
    save_audio(str(wav), _audio(1.0, 2), SR)
    for players in ((), ("ffplay",), ("paplay", "ffplay")):
        calls = {}
        for tag, V in (("t", TV), ("j", JV)):
            log = calls[tag] = []
            monkeypatch.setattr(shutil, "which", lambda p, have=players: f"/bin/{p}" if p in have else None)
            monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: log.append(("run", cmd)))
            monkeypatch.setattr(subprocess, "Popen", lambda cmd, **kw: log.append(("popen", cmd)))
            paths = [V.play_audio(_audio(0.5, 3), SR), V.play_audio(_audio(0.5, 3), SR, blocking=False),
                     V.play_audiofile(str(wav), start=0.2, end=0.7, sample_rate=SR)]
            log.append((paths, open(paths[0], "rb").read()))
        assert calls["t"] == calls["j"]
        assert calls["t"][-1][0][0] == os.path.join(str(tmp_path), "ssak_play.wav")
        assert len(calls["t"]) == (4 if players else 1)
