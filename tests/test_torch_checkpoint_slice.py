"""Model directories end to end, the port against ssak_tpu on the CPU.

Whisper: a tiny HF Whisper saved by `transformers` (d=64, 2+2 layers, a
30 s window, vocabulary 51,866, sot 50,258 and eot 50,257 as large-v3's)
with the tokenizer of tests/test_torch_whisper_tokenizer.py. Each package
loads the directory with its own load_model and transcribes with
whisper_transcribe_batch in f32: greedy; language="fr"; task="translate";
the --accurate chain (beam 5 at T = 0 on the real model and tokenizer;
the two packages draw samples from different generators, so at T > 0 both
get the same scripted samples); long-form on a 40 s file. The ids handed
to the tokenizer and the texts are identical. With quantize_bits=8 (int8
weights and K/V caches) the logits along the port's greedy path are held
to 2e-3 of their largest value, the int8 rule of tests/test_torch_whisper.py.
The same directory written in F16 keeps its f16 leaves in both packages'
load_model, unquantized and at quantize_bits=8 and 4: teacher-forced
logits, each package from its own encoder, within 1e-4 of the largest
(f32 compute, unquantized), 2e-3 (f32 compute, quantized: the int8 rule)
and 1e-2 (the default bf16 compute: the packages round to bf16 at other
places; readings 4.4e-3 to 6.6e-3 on f16 leaves and 4.9e-3 to 5.6e-3 on
f32 ones, so the f16 leaves add nothing; 1e-2 is about 2.5 bf16 steps of
2^-8 at the largest logit). A
large-v2-shaped directory (51,865 ids), whose tokenizer's special ids are
ssak_tpu's defaults, runs against the unmodified reference: the same
config ids, and identical ids and texts on greedy, fr and long-form.

wav2vec2: an HF wav2vec2-CTC directory and a synthetic Kaldi directory;
`python -m ssak_tpu_torch.infer.cli ... --device cpu` and ssak_tpu's
`sak-infer` print the same lines (one torch thread, as the other CLI tests).
Also: chip_smoke.py's HF-layout writers (large-v3-shaped tokenizer files,
F16 safetensors, a .bin wav2vec2) read back through both packages."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ssak_tpu.infer.whisper_infer as JWI
import ssak_tpu_torch.infer.whisper_infer as WI
from ssak_tpu.infer import general as JG
from ssak_tpu.models import whisper as JW
from ssak_tpu.models.tokenizer import WhisperTokenizer as JTok
from ssak_tpu_torch.infer import general as G
from ssak_tpu_torch.models import whisper as W
from ssak_tpu_torch.models.tokenizer import WhisperTokenizer
from test_torch_hf_loader import assert_same_tree, hf_wav2vec2_dir, hf_whisper_dir
from test_torch_whisper_tokenizer import build_whisper_tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECIAL_IDS = ("no_timestamps", "sot_prev", "no_speech", "timestamp_begin")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small ops: one intra-op thread keeps torch from spinning beside
    other test workers. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tones(seconds, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    audio = sum(0.1 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t) for _ in range(3)) + 0.02 * rng.randn(t.size)
    return audio.astype(np.float32)


@pytest.fixture(scope="module")
def whisper_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("hf_whisper_tok"))
    hf_whisper_dir(d, vocab_size=51866, n_audio_ctx=1500, n_text_ctx=64, sot=50258, eot=50257)
    return build_whisper_tokenizer(d)


class _Ids:
    """Records the ids each tokenizer.decode call receives."""

    def __init__(self, model):
        self.calls, self.orig = [], model.tokenizer.decode
        model.tokenizer.decode = self

    def __call__(self, ids, *a, **kw):
        self.calls.append([int(i) for i in ids])
        return self.orig(ids, *a, **kw)


def _load(whisper_dir, bits=0):
    """Both packages' load_model in f32. The port takes the tokenizer's
    special ids into its config, where ssak_tpu keeps large-v2's defaults
    (ROADMAP.md §3): ssak_tpu's model gets the same ids, so that both run
    the same decode rules."""
    jm = JG.load_model(whisper_dir, quantize_bits=bits)
    pm = G.load_model(whisper_dir, quantize_bits=bits, device="cpu")
    jm.cfg = dataclasses.replace(jm.cfg, **{k: getattr(pm.cfg, k) for k in SPECIAL_IDS})
    jm.cfg, pm.cfg = dataclasses.replace(jm.cfg, dtype="float32"), dataclasses.replace(pm.cfg, dtype="float32")
    assert isinstance(pm.tokenizer, WhisperTokenizer) and isinstance(jm.tokenizer, JTok)
    return jm, pm, _Ids(jm), _Ids(pm)


def test_loaded_directory_matches_jax(whisper_dir):
    from ssak_tpu_torch.models.convert import whisper_from_tree
    from ssak_tpu_torch.models.hf_loader import load_whisper

    jm = JG.load_model(whisper_dir)
    tree, _ = load_whisper(whisper_dir)
    assert_same_tree(tree, jm.params)
    pm = G.load_model(whisper_dir, device="cpu")
    ref = whisper_from_tree(tree).state_dict()
    assert all(torch.equal(v, ref[k]) for k, v in pm.module.state_dict().items()) and len(ref) == len(pm.module.state_dict())
    assert G.get_model_type(whisper_dir) == JG.get_model_type(whisper_dir) == "whisper"
    assert (pm.tokenizer.sot, pm.tokenizer.eot, pm.cfg.sot, pm.cfg.eot) == (50258, 50257, 50258, 50257)
    # the tokenizer's ids (large-v3's) drive the port's decode rules; ssak_tpu keeps large-v2's defaults
    assert [getattr(pm.cfg, k) for k in SPECIAL_IDS] == [getattr(pm.tokenizer, k) for k in SPECIAL_IDS] == \
           [50364, 50362, 50363, 50365]
    assert [getattr(jm.cfg, k) for k in SPECIAL_IDS] == [50363, 50361, 50362, 50364]


@pytest.mark.parametrize("kw", [{}, {"language": "fr"}, {"language": "fr", "task": "translate"}],
                         ids=["greedy", "fr", "fr_translate"])
def test_greedy_transcripts_match_jax(whisper_dir, kw):
    jm, pm, jids, pids = _load(whisper_dir)
    batch = [_tones(5.0, 1), _tones(12.0, 2), _tones(29.0, 3)]
    ref = JWI.whisper_transcribe_batch(jm, batch, max_tokens=12, **kw)
    got = WI.whisper_transcribe_batch(pm, batch, max_tokens=12, **kw)
    assert pids.calls == jids.calls and len(pids.calls) == 3
    assert got == ref and all(isinstance(t, str) for t in got)
    assert any(not t.replace(" ", "").isdigit() for t in got if t)  # text, not ids


def test_infer_generator_matches_transcribe_batch(whisper_dir):
    """infer.general.infer over batches gives whisper_transcribe_batch's
    texts, batch by batch, with the options passed through."""
    _jm, pm, _j, _p = _load(whisper_dir)
    batches = [[_tones(3.0, 11), _tones(6.0, 12)], [_tones(4.0, 13)]]
    want = [t for b in batches for t in WI.whisper_transcribe_batch(pm, b, language="fr", max_tokens=6)]
    assert list(G.infer(pm, batches, language="fr", max_tokens=6)) == want


def _scripted_samples(calls):
    """The same sampled candidates for both packages at T > 0: per row,
    ids that depend on the row and the temperature; the first temperature
    repeats one token (its text fails the compression check)."""

    def run(rows, temperature):
        calls.append((rows, temperature))
        n = 10
        tokens = np.full((rows, n), 50257, np.int32)
        for r in range(rows):
            if temperature < 0.3:
                tokens[r, :8] = 4000 + r
            else:
                tokens[r, :8] = 300 + 37 * r + np.arange(8) * (11 + int(temperature * 10))
        lengths = np.full((rows,), 9, np.int32)
        return tokens, lengths, np.full((rows,), -1.5, np.float32)

    return run


def test_accurate_chain_matches_jax(whisper_dir, monkeypatch):
    jm, pm, jids, pids = _load(whisper_dir)
    jcalls, pcalls = [], []
    jrun, prun = _scripted_samples(jcalls), _scripted_samples(pcalls)
    monkeypatch.setattr(JWI, "_jitted_sample",
                        lambda cfg, prompt, max_tokens, temperature, best_of=1: lambda p, mel, k: jrun(mel.shape[0], temperature))
    monkeypatch.setattr(W, "sample_decode", lambda m, mel, c, pr, seed, temperature, max_tokens, best_of:
                        tuple(map(torch.from_numpy, prun(mel.shape[0], temperature))))
    batch = [_tones(4.0, 4), _tones(9.0, 5), _tones(16.0, 6)]
    kw = dict(beam_size=5, temperature_fallback=True, best_of=5, max_tokens=10, language="fr")
    ref = JWI.whisper_transcribe_batch(jm, batch, **kw)
    got = WI.whisper_transcribe_batch(pm, batch, **kw)
    assert pids.calls == jids.calls and len(pids.calls) >= 3
    assert pcalls == jcalls
    assert got == ref


def test_longform_matches_jax(whisper_dir):
    jm, pm, jids, pids = _load(whisper_dir)
    batch = [_tones(40.0, 7), _tones(3.0, 8)]
    ref = JWI.whisper_transcribe_batch(jm, batch, max_tokens=12)
    got = WI.whisper_transcribe_batch(pm, batch, max_tokens=12)
    assert got == ref and pids.calls == jids.calls
    kw = dict(language="fr", temperatures=(0.0,), no_speech_threshold=None)
    ref = JWI.transcribe_longform_batch(jm, [batch[0]], **kw)[0]
    got = WI.transcribe_longform_batch(pm, [batch[0]], **kw)[0]
    assert got["text"] == ref["text"] and len(got["segments"]) == len(ref["segments"]) >= 1
    assert all(0.0 <= sg["start"] <= sg["end"] for sg in got["segments"])
    for g, r in zip(got["segments"], ref["segments"]):
        assert (g["tokens"], g["text"], g["seek"]) == (r["tokens"], r["text"], r["seek"])
        assert g["start"] == pytest.approx(r["start"]) and g["end"] == pytest.approx(r["end"])


def test_int8_directory_logits_follow_the_int8_rule(whisper_dir):
    """quantize_bits=8 on the loaded directory: the port's greedy tokens,
    then both models teacher-forced along them; logits within 2e-3 of the
    largest (int8 weights and int8 K/V caches)."""
    jm, pm, _j, _p = _load(whisper_dir, bits=8)
    assert pm.cfg.kv_int8 and jm.cfg.kv_int8
    audio = np.zeros(30 * 16000, np.float32)
    audio[: 7 * 16000] = _tones(7.0, 9)
    mel = WI.log_mel_spectrogram(torch.from_numpy(audio)[None], n_mels=80)
    mel_np = mel.numpy()
    prompt = pm.tokenizer.sot_sequence("fr")
    toks, lens = W.greedy_decode(pm.module, mel, pm.cfg, prompt, max_tokens=8)
    path = prompt + [int(t) for t in toks[0, : int(lens[0])]]
    jp = jm.params
    af = JW.encode(jp, jnp.asarray(mel_np), jm.cfg)
    jkv, jc = JW.precompute_cross_kv(jp, af, jm.cfg), JW.init_cache(jm.cfg, 1)
    with torch.no_grad():
        tkv = W.precompute_cross_kv(pm.module, torch.from_numpy(np.array(af)), pm.cfg)
        tc = W.init_cache(pm.cfg, 1)
        for pos, tok in enumerate(path[:-1]):
            ref, jc = JW._decode_step(jp, jnp.full((1, 1), tok, jnp.int32), pos, jc, jkv, jm.cfg)
            got, tc = W._decode_step(pm.module, torch.full((1, 1), tok, dtype=torch.int64), pos, tc, tkv, pm.cfg)
            ref = np.asarray(ref, np.float32)
            assert float(np.abs(got.float().numpy() - ref).max()) <= 2e-3 * float(np.abs(ref).max()), pos


@pytest.fixture(scope="module")
def whisper_dir_f16(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("hf_whisper_f16"))
    hf_whisper_dir(d, vocab_size=51866, n_audio_ctx=1500, n_text_ctx=64, sot=50258, eot=50257, dtype="f16")
    return build_whisper_tokenizer(d)


F16_CASES = {"f32": (0, "float32", 1e-4), "int8_f32": (8, "float32", 2e-3), "int4_f32": (4, "float32", 2e-3),
             "bf16": (0, "bfloat16", 1e-2), "int8_bf16": (8, "bfloat16", 1e-2), "int4_bf16": (4, "bfloat16", 1e-2)}


@pytest.mark.parametrize("case", list(F16_CASES))
def test_f16_directory_keeps_f16_leaves_and_logits_match_jax(whisper_dir_f16, case):
    """An F16 checkpoint as load_model leaves it (no widening to f32): the
    port's greedy tokens, then both packages teacher-forced along them,
    each from its own encoder output and cross K/V."""
    bits, dtype, tol = F16_CASES[case]
    jm = JG.load_model(whisper_dir_f16, quantize_bits=bits)
    pm = G.load_model(whisper_dir_f16, quantize_bits=bits, device="cpu")
    assert jm.cfg.dtype == pm.cfg.dtype == "bfloat16" and jm.cfg.kv_int8 == pm.cfg.kv_int8 == bool(bits)
    assert {p.dtype for p in pm.module.parameters()} == {torch.float16}
    jdt = {np.asarray(a).dtype.name for a in jax.tree_util.tree_leaves(jm.params)}
    assert jdt == ({"float16", "float32", "int8"} if bits else {"float16"})  # float32: the int8 / int4 scales
    jcfg, pcfg = dataclasses.replace(jm.cfg, dtype=dtype), dataclasses.replace(pm.cfg, dtype=dtype)
    audio = np.zeros(30 * 16000, np.float32)
    audio[: 7 * 16000] = _tones(7.0, 9)
    mel = WI.log_mel_spectrogram(torch.from_numpy(audio)[None], n_mels=80)
    prompt = pm.tokenizer.sot_sequence("fr")
    with torch.no_grad():
        toks, lens = W.greedy_decode(pm.module, mel, pcfg, prompt, max_tokens=8)
        path = prompt + [int(t) for t in toks[0, : int(lens[0])]]
        jp = jm.params
        af = JW.encode(jp, jnp.asarray(mel.numpy()), jcfg)
        jkv, jc = JW.precompute_cross_kv(jp, af, jcfg), JW.init_cache(jcfg, 1)
        tkv = W.precompute_cross_kv(pm.module, W.encode(pm.module, mel, pcfg), pcfg)
        tc = W.init_cache(pcfg, 1)
        for pos, tok in enumerate(path[:-1]):
            ref, jc = JW._decode_step(jp, jnp.full((1, 1), tok, jnp.int32), pos, jc, jkv, jcfg)
            got, tc = W._decode_step(pm.module, torch.full((1, 1), tok, dtype=torch.int64), pos, tc, tkv, pcfg)
            ref = np.asarray(ref, np.float32)
            assert float(np.abs(got.float().numpy() - ref).max()) <= tol * float(np.abs(ref).max()), pos


@pytest.fixture(scope="module")
def whisper_dir_v2(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("hf_whisper_v2"))
    hf_whisper_dir(d, vocab_size=51865, n_audio_ctx=1500, n_text_ctx=64, sot=50258, eot=50257)
    return build_whisper_tokenizer(d, large_v2=True)


def test_large_v2_ids_match_the_unmodified_reference(whisper_dir_v2):
    """Where the tokenizer's special ids equal ssak_tpu's defaults
    (large-v2's), the port's config takes the same ids and both packages,
    ssak_tpu's config changed only to f32 compute, give identical decoded
    ids and texts on greedy, fr and long-form (timestamps)."""
    jm = JG.load_model(whisper_dir_v2)
    pm = G.load_model(whisper_dir_v2, device="cpu")
    assert [getattr(pm.cfg, k) for k in SPECIAL_IDS] == [getattr(jm.cfg, k) for k in SPECIAL_IDS] == \
           [getattr(jm.tokenizer, k) for k in SPECIAL_IDS] == [50363, 50361, 50362, 50364]
    assert pm.cfg.n_vocab == jm.cfg.n_vocab == 51865
    jm.cfg, pm.cfg = dataclasses.replace(jm.cfg, dtype="float32"), dataclasses.replace(pm.cfg, dtype="float32")
    jids, pids = _Ids(jm), _Ids(pm)
    batch = [_tones(5.0, 1), _tones(40.0, 7)]
    for kw in ({}, {"language": "fr"}):
        ref = JWI.whisper_transcribe_batch(jm, batch, max_tokens=12, **kw)
        got = WI.whisper_transcribe_batch(pm, batch, max_tokens=12, **kw)
        assert got == ref and all(isinstance(t, str) for t in got)
    assert pids.calls == jids.calls and len(pids.calls) >= 4


def _kaldi(root, n=5, seed=0):
    from ssak_tpu_torch.audio import save_audio

    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    lines = []
    for i in range(n):
        path = os.path.join(root, f"u{i}.wav")
        save_audio(path, _tones(0.5 + 0.7 * i, seed + i) + 0.05 * rng.randn(int((0.5 + 0.7 * i) * 16000)).astype(np.float32), 16000)
        lines.append(f"u{i} {path}")
    with open(os.path.join(root, "wav.scp"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return root


def test_sak_infer_on_a_wav2vec2_directory_prints_jax_lines(tmp_path, monkeypatch):
    """Both CLIs as subprocesses on the directory, in the model's default
    bf16 compute: the same ids in the same order, and transcripts within 5%
    CER of each other (bf16 rounds at other places in the two packages, and
    a greedy argmax can flip on a near tie). Then both packages' ctc_infer
    on the same directory with the loaded config switched to f32: the same
    lines exactly."""
    from ssak_tpu.infer.ctc_infer import ctc_infer as j_ctc_infer
    from ssak_tpu_torch.eval.wer import compute_wer
    from ssak_tpu_torch.infer.ctc_infer import ctc_infer

    model = hf_wav2vec2_dir(str(tmp_path / "w2v"), stable=True, seed=4)
    data = _kaldi(str(tmp_path / "data"))
    env = {**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    got = subprocess.run([sys.executable, "-m", "ssak_tpu_torch.infer.cli", data, model, "--device", "cpu"], cwd=REPO,
                         capture_output=True, text=True, timeout=300, env=env)
    ref = subprocess.run([sys.executable, "-m", "ssak_tpu.infer.cli", data, model], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env=env)
    assert got.returncode == 0 and ref.returncode == 0, (got.stderr[-2000:], ref.stderr[-2000:])
    lines, ref_lines = got.stdout.strip().splitlines(), ref.stdout.strip().splitlines()
    ids = [f"u{i}" for i in range(5)]
    assert [ln.split()[0] for ln in lines] == [ln.split()[0] for ln in ref_lines] == ids
    cer = compute_wer([ln.partition(" ")[2] for ln in ref_lines], [ln.partition(" ")[2] for ln in lines],
                      character_level=True)["wer"]
    assert cer <= 0.05, (cer, lines, ref_lines)

    def f32(load):
        def call(*a, **kw):
            m = load(*a, **kw)
            m.cfg = dataclasses.replace(m.cfg, dtype="float32")
            return m

        return call

    monkeypatch.setattr(JG, "load_model", f32(JG.load_model))
    monkeypatch.setattr(G, "load_model", f32(G.load_model))
    exact = list(ctc_infer(model, data, output_ids=True, device="cpu"))
    assert exact == list(j_ctc_infer(model, data, output_ids=True)) and [i for i, _ in exact] == ids


def test_sak_infer_dispatch():
    from ssak_tpu_torch.infer.cli import model_family

    assert model_family(["d", "m", "--seeded_test_config", "whisper"]) == "whisper"
    assert model_family(["d", "m", "--seeded_test_config=wav2vec2"]) == "ctc"
    assert model_family(["d"]) == "ctc"


# --- chip_smoke.py's HF-layout writers, read back by both packages ----------------------


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def test_chip_smoke_whisper_directory_reads_back(tmp_path):
    """chip_smoke.write_whisper_dir at tiny widths: F16 safetensors under HF
    names and a byte-level vocab.json + merges.txt + added_tokens.json of
    large-v3's 51,866 ids. Both packages load the same tree, bit for bit,
    equal to the f16-rounded source; both tokenizers decode every id alike,
    and no id below 51,866 lies outside the vocabulary."""
    cs = _chip_smoke()
    cfg = W.make_config("tiny_test", n_vocab=51866, sot=50258, eot=50257)
    tree = cs.seeded_tree(cfg, seed=1)
    d = str(tmp_path / "wdir")
    cs.write_whisper_dir(d, tree, cfg)
    from ssak_tpu_torch.models.hf_loader import load_whisper

    mine, mcfg = load_whisper(d)
    ref = JG.load_model(d)
    assert_same_tree(mine, ref.params)
    assert_same_tree(mine, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float16), tree))
    assert dataclasses.asdict(mcfg) == dataclasses.asdict(dataclasses.replace(cfg, timestamp_begin=50364, no_timestamps=50363,
                                                                              sot_prev=50361, no_speech=50362))
    tok, jtok = WhisperTokenizer(d), ref.tokenizer
    assert (tok.sot, tok.eot, tok.no_timestamps, tok.timestamp_begin, tok.sot_prev, tok.no_speech) == \
           (50258, 50257, 50364, 50365, 50362, 50363)
    assert all(i in tok.tk.vocab_r or i in tok._special.values() for i in range(51866))
    for i in range(0, 51866, 7):
        assert tok.decode([i, i + 1], skip_special=False) == jtok.decode([i, i + 1], skip_special=False), i
    text = "bonjour à tous, ça va ? 42 € ½"
    assert tok.encode(text) == jtok.encode(text) and tok.decode(tok.encode(text)) == text


def test_chip_smoke_wav2vec2_bin_directory_reads_back(tmp_path):
    """chip_smoke.write_wav2vec2_dir: a pytorch_model.bin of HF names (the
    positional conv as weight_g / weight_v) with config.json and vocab.json;
    both packages load the same tree, and it gives the source model's
    log-probs (the weight norm recomposed to within f32 rounding)."""
    cs = _chip_smoke()
    from ssak_tpu_torch.infer.general import seeded_ctc_tokenizer
    from ssak_tpu_torch.models import wav2vec2 as W2V
    from ssak_tpu_torch.models.hf_loader import load_wav2vec2

    cfg = W2V.make_config("tiny_test", do_stable_layer_norm=True, conv_bias=True, vocab_size=48)
    src = W2V.init_params(cfg, seed=2)
    d = str(tmp_path / "xdir")
    cs.write_wav2vec2_dir(d, src, cfg, seeded_ctc_tokenizer(48))
    mine, mcfg = load_wav2vec2(d)
    assert_same_tree(mine, JG.load_model(d).params)
    assert mcfg == cfg
    m = G.load_model(d, device="cpu")
    assert m.tokenizer.vocab == seeded_ctc_tokenizer(48).vocab
    x = torch.from_numpy((np.random.RandomState(0).randn(2, 4000) * 0.1).astype(np.float32))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with torch.no_grad():
        a, _ = W2V.ctc_log_probs(src, x, cfg32)
        b, _ = W2V.ctc_log_probs(m.module, x, cfg32)
    assert float((a - b).abs().max()) <= 1e-4
