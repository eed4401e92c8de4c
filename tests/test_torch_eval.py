"""The port's WER engine and `sak-wer` against ssak_tpu's: compute_wer with
every option (normalization by language and its "+" / "++" modes,
character level, details with alignments, bootstrap intervals, replacements,
a word blacklist; files, dicts and lists) gives equal results, floats
within 1e-12 and the bootstrap interval identical under a seed (the same
numpy RandomState calls); format_alignment strings, compute_wer_differences
and keyword_scores are identical; the CLI prints ssak_tpu's JSON."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from ssak_tpu.eval import wer as JWER
from ssak_tpu_torch.eval import wer as WER

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REFS = {
    "u1": "Le 9/02/2008 à 20h30 autour des oeuvres de Paul",
    "u2": "plus de 80 % , c'est l'arc-en-ciel",
    "u3": "",
    "u4": "bonjour à tous et à toutes",
    "u5": "I have 2 cats & 3 dogs",
    "u6": "élève très sérieux",
    "u7": "a b c d e f g",
}
HYPS = {
    "u1": "le neuf février deux mille huit à vingt heures autour des œuvres de paul",
    "u2": "plus de quatre vingts pour cent c est l arc en ciel",
    "u3": "euh",
    "u4": "bonjour tous et a toute",
    "u5": "i have two cats and three dog",
    "u6": "eleve tres serieux",
    "u7": "a x c e f g h",
    "u9": "an extra id",
}


def _same(got, ref, path="result"):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(ref), (path, sorted(got), sorted(ref))
        for k in ref:
            _same(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _same(g, r, f"{path}[{i}]")
    elif isinstance(ref, float):
        assert abs(got - ref) <= 1e-12, (path, got, ref)
    else:
        assert got == ref, (path, got, ref)


OPTIONS = [
    {},
    {"normalization": "fr"},
    {"normalization": "fr+"},
    {"normalization": "fr++"},
    {"normalization": "en"},
    {"normalization": "+"},
    {"character_level": True},
    {"character_level": True, "normalization": "fr++"},
    {"details": True},
    {"details": True, "normalization": "fr+", "character_level": True},
    {"bootstrap_ci": True},
    {"bootstrap_ci": True, "n_bootstrap": 200, "seed": 7, "normalization": "fr"},
    {"replacements_ref": {"80": "quatre vingts"}, "replacements_pred": [("dog", "dogs")]},
    {"words_blacklist": ["euh", "a"]},
]


@pytest.mark.parametrize("opts", OPTIONS, ids=[",".join(f"{k}={v}" for k, v in o.items()) or "default" for o in OPTIONS])
def test_compute_wer_matches_jax(opts):
    _same(WER.compute_wer(REFS, HYPS, **opts), JWER.compute_wer(REFS, HYPS, **opts))
    refs, hyps = list(REFS.values()), [HYPS[k] for k in REFS]
    _same(WER.compute_wer(refs, hyps, **opts), JWER.compute_wer(refs, hyps, **opts))


def test_files_ids_and_errors_match_jax(tmp_path):
    rf, hf = tmp_path / "ref.txt", tmp_path / "hyp.txt"
    rf.write_text("".join(f"{k} {v}\n" for k, v in REFS.items()), encoding="utf-8")
    hf.write_text("".join(f"{k} {v}\n" for k, v in HYPS.items()), encoding="utf-8")
    for opts in ({}, {"normalization": "fr", "details": True}, {"use_ids": False, "bootstrap_ci": True}):
        if opts.get("use_ids") is False:
            with pytest.raises(ValueError):
                JWER.compute_wer(str(rf), str(hf), **opts)
            with pytest.raises(ValueError):
                WER.compute_wer(str(rf), str(hf), **opts)
            continue
        _same(WER.compute_wer(str(rf), str(hf), **opts), JWER.compute_wer(str(rf), str(hf), **opts))
    with pytest.raises(ValueError, match="no common"):
        WER.compute_wer({"a": "x"}, {"b": "x"})


def test_bootstrap_interval_is_identical_under_a_seed():
    rng = np.random.RandomState(3)
    errs = rng.randint(0, 6, size=50).astype(np.float64)
    lens = rng.randint(1, 20, size=50).astype(np.float64)
    for seed in (0, 1234, 99):
        got = WER.bootstrap_confidence_interval(errs, lens, n=300, seed=seed)
        ref = JWER.bootstrap_confidence_interval(errs, lens, n=300, seed=seed)
        assert got == ref
    assert WER.compute_wer(REFS, HYPS, bootstrap_ci=True)["ci"] == JWER.compute_wer(REFS, HYPS, bootstrap_ci=True)["ci"]


def test_format_alignment_strings_are_identical():
    cases = [("a b c d".split(), "a x c".split()), ("".split(), "x y".split()), ("longword b".split(), "lw b c".split()),
             (list("élève"), list("eleve")), ("a b c".split(), "".split())]
    for ref, hyp in cases:
        _d, ops = WER.align_tokens(ref, hyp)
        _jd, jops = JWER.align_tokens(ref, hyp)
        assert ops == jops
        assert WER.format_alignment(ref, hyp, ops) == JWER.format_alignment(ref, hyp, jops)


def test_differences_and_keywords_match_jax():
    hyps2 = {k: v.replace("a", "à") for k, v in HYPS.items()}
    for norm in (None, "fr"):
        _same(WER.compute_wer_differences(REFS, HYPS, hyps2, normalization=norm),
              JWER.compute_wer_differences(REFS, HYPS, hyps2, normalization=norm))
        _same(WER.keyword_scores(REFS, HYPS, ["de", "cats", "paul", "absent"], normalization=norm),
              JWER.keyword_scores(REFS, HYPS, ["de", "cats", "paul", "absent"], normalization=norm))
        for text in REFS.values():
            assert WER._normalize_for_wer(text, norm) == JWER._normalize_for_wer(text, norm)


@pytest.mark.parametrize("flags", [[], ["--normalization", "fr+", "--char"], ["--details", "--bootstrap_ci"]],
                         ids=["default", "norm_char", "details_ci"])
def test_sak_wer_cli_prints_jax_json(tmp_path, flags):
    rf, hf = tmp_path / "ref.txt", tmp_path / "hyp.txt"
    rf.write_text("".join(f"{k} {v}\n" for k, v in REFS.items()), encoding="utf-8")
    hf.write_text("".join(f"{k} {v}\n" for k, v in HYPS.items()), encoding="utf-8")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    args = [str(rf), str(hf)] + flags
    got = subprocess.run([sys.executable, "-m", "ssak_tpu_torch.eval.cli"] + args + ["--device", "cpu"], cwd=REPO,
                         capture_output=True, text=True, timeout=300, env=env)
    ref = subprocess.run([sys.executable, "-m", "ssak_tpu.eval.cli"] + args, cwd=REPO, capture_output=True, text=True,
                         timeout=300, env=env)
    assert got.returncode == 0 and ref.returncode == 0, (got.stderr[-2000:], ref.stderr[-2000:])
    assert got.stdout == ref.stdout
    json.loads(got.stdout.strip().splitlines()[-1])


def test_sak_wer_plot_is_refused(tmp_path, monkeypatch):
    """Where matplotlib is absent, --plot is refused by an ImportError that
    names it, and no plot file is left behind."""
    from ssak_tpu_torch.eval import cli

    rf, hf = tmp_path / "ref.txt", tmp_path / "hyp.txt"
    rf.write_text("".join(f"{k} {v}\n" for k, v in REFS.items()), encoding="utf-8")
    hf.write_text("".join(f"{k} {v}\n" for k, v in HYPS.items()), encoding="utf-8")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        cli.main([str(rf), str(hf), "--plot", str(tmp_path / "x.png"), "--device", "cpu"])
    assert not (tmp_path / "x.png").exists()
