"""NeMo Conformer-CTC archives in the port against ssak_tpu: the port's own
YAML reader against PyYAML, the .nemo tar and its extracted directory
(trees bit for bit against ssak_tpu.models.hf_loader.load_nemo_conformer),
load_model / compute_log_probas / decode_log_probas, `sak-infer`, the device
beam at NeMo's blank (the last id), CTCTrainer(family="conformer"), the
train CLI's --base_model, checkpoints and `sak-finalize` exports both ways,
and chip_smoke.py's archive writer.

The archives are tiny (d 32, 2 layers), drawn from a seed in NeMo's key
layout, with a character vocabulary (space-delimited words, as NeMo char
models) or a BPE-style one ('▁' marks word starts). Tolerances: trees and
configs exact; f32 log-probs to 1e-4 absolute; bf16 log-probs by
correlation >= 0.999; decoded tokens exact on the same log-probs.
"""

import dataclasses
import io
import json
import math
import os
import random
import subprocess
import sys
import tarfile

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from ssak_tpu.decode import ctc_beam as JB
from ssak_tpu.decode import lexicon as JLx
from ssak_tpu.decode import lm as JLM
from ssak_tpu.infer import general as JG
from ssak_tpu.models.hf_loader import load_nemo_conformer as j_load_nemo
from ssak_tpu.models.tokenizer import CTCTokenizer as JTok
from ssak_tpu.train import checkpoint as JCK
from ssak_tpu.train import finalize as JF
from ssak_tpu_torch.decode import ctc_beam as TB
from ssak_tpu_torch.decode import lexicon as TLx
from ssak_tpu_torch.decode import lm as TLM
from ssak_tpu_torch.infer import general as TG
from ssak_tpu_torch.models.convert import conformer_from_tree, conformer_to_tree
from ssak_tpu_torch.models.hf_loader import load_nemo_conformer
from ssak_tpu_torch.models.tokenizer import CTCTokenizer
from ssak_tpu_torch.utils.yaml_reader import resolve_plain, safe_load

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHARS = "abcdefghijklmnopqrstuvwxyz"
CHAR_VOCAB = list(" " + CHARS + "'")
BPE_VOCAB = ["<unk>", "▁"] + list(CHARS) + ["'", "▁th", "e▁", "ing", "▁a", "er", "▁the", "on", "▁s", "ou", "re"]


def build_nemo_archive(path, vocab, d=32, layers=2, heads=2, k=7, n_mels=80, seed=0, extracted=False):
    """A NeMo EncDecCTCModel archive (model_config.yaml by yaml.safe_dump,
    model_weights.ckpt by torch.save) of seeded weights: a .nemo tar at
    `path`, or with `extracted` a directory. The port's copy of
    test_nemo_parity._build_tiny_nemo_archive, with norms, BatchNorm
    statistics and biases drawn too."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def rand(*shape, std=1.0, mean=0.0):
        return torch.randn(*shape, generator=g) * std + mean

    def lin(pfx, din, dout, bias=True):
        sd[f"{pfx}.weight"] = rand(dout, din, std=din ** -0.5)
        if bias:
            sd[f"{pfx}.bias"] = rand(dout, std=0.02)

    f4 = ((n_mels + 1) // 2 + 1) // 2
    sd["encoder.pre_encode.conv.0.weight"] = rand(d, 1, 3, 3, std=0.2)
    sd["encoder.pre_encode.conv.0.bias"] = rand(d, std=0.02)
    sd["encoder.pre_encode.conv.2.weight"] = rand(d, d, 3, 3, std=0.05)
    sd["encoder.pre_encode.conv.2.bias"] = rand(d, std=0.02)
    lin("encoder.pre_encode.out", d * f4, d)
    for i in range(layers):
        p = f"encoder.layers.{i}"
        for ln in ("norm_feed_forward1", "norm_self_att", "norm_conv", "norm_feed_forward2", "norm_out"):
            sd[f"{p}.{ln}.weight"] = rand(d, std=0.05, mean=1.0)
            sd[f"{p}.{ln}.bias"] = rand(d, std=0.05)
        for ff in ("feed_forward1", "feed_forward2"):
            lin(f"{p}.{ff}.linear1", d, 4 * d)
            lin(f"{p}.{ff}.linear2", 4 * d, d)
        for q in ("linear_q", "linear_k", "linear_v", "linear_out"):
            lin(f"{p}.self_attn.{q}", d, d)
        lin(f"{p}.self_attn.linear_pos", d, d, bias=False)
        sd[f"{p}.self_attn.pos_bias_u"] = rand(heads, d // heads, std=0.1)
        sd[f"{p}.self_attn.pos_bias_v"] = rand(heads, d // heads, std=0.1)
        sd[f"{p}.conv.pointwise_conv1.weight"] = rand(2 * d, d, 1, std=d ** -0.5)
        sd[f"{p}.conv.pointwise_conv1.bias"] = rand(2 * d, std=0.02)
        sd[f"{p}.conv.depthwise_conv.weight"] = rand(d, 1, k, std=0.2)
        sd[f"{p}.conv.depthwise_conv.bias"] = rand(d, std=0.02)
        sd[f"{p}.conv.batch_norm.weight"] = rand(d, std=0.05, mean=1.0)
        sd[f"{p}.conv.batch_norm.bias"] = rand(d, std=0.05)
        sd[f"{p}.conv.batch_norm.running_mean"] = rand(d, std=0.1)
        sd[f"{p}.conv.batch_norm.running_var"] = torch.rand(d, generator=g) + 0.5
        sd[f"{p}.conv.batch_norm.num_batches_tracked"] = torch.tensor(1)
        sd[f"{p}.conv.pointwise_conv2.weight"] = rand(d, d, 1, std=d ** -0.5)
        sd[f"{p}.conv.pointwise_conv2.bias"] = rand(d, std=0.02)
    sd["decoder.decoder_layers.0.weight"] = rand(len(vocab) + 1, d, 1, std=d ** -0.5)
    sd["decoder.decoder_layers.0.bias"] = rand(len(vocab) + 1, std=0.02)
    model_cfg = {
        "sample_rate": 16000,
        "train_ds": {"manifest_filepath": None, "sample_rate": "${model.sample_rate}", "batch_size": 16},
        "encoder": {"feat_in": n_mels, "d_model": d, "n_layers": layers, "n_heads": heads, "ff_expansion_factor": 4,
                    "conv_kernel_size": k, "subsampling": "striding", "subsampling_factor": 4, "xscaling": True,
                    "self_attention_model": "rel_pos", "dropout": 0.1},
        "decoder": {"feat_in": d, "num_classes": len(vocab), "vocabulary": vocab},
        "labels": vocab,
        "optim": {"name": "adamw", "lr": 2.0, "betas": [0.9, 0.98], "sched": {"min_lr": 1e-6, "warmup_ratio": None}},
    }
    config = yaml.safe_dump(model_cfg).encode()
    if extracted:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "model_config.yaml"), "wb") as f:
            f.write(config)
        torch.save(sd, os.path.join(path, "model_weights.ckpt"))
    else:
        wbuf = io.BytesIO()
        torch.save(sd, wbuf)
        with tarfile.open(path, "w") as tar:
            for name, data in (("./model_config.yaml", config), ("./model_weights.ckpt", wbuf.getvalue())):
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))
    return path


VOCABS = {"char": CHAR_VOCAB, "bpe": BPE_VOCAB}


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    root = tmp_path_factory.mktemp("nemo")
    out = {}
    for kind, vocab in VOCABS.items():
        out[kind] = build_nemo_archive(str(root / f"{kind}.nemo"), vocab, seed=len(vocab))
        out[kind + "_dir"] = build_nemo_archive(str(root / f"{kind}_dir"), vocab, seed=len(vocab), extracted=True)
    return out


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def assert_same_tree(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(_leaves(a), _leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)


# --- the YAML reader -------------------------------------------------------------------------------


NEMO_STYLE = {
    "name": "ConformerCTC",
    "model": {
        "sample_rate": 16000,
        "log_prediction": True,
        "train_ds": {"manifest_filepath": None, "sample_rate": "${model.sample_rate}", "batch_size": 16, "shuffle": True,
                     "max_duration": 16.7, "is_tarred": False,
                     "datasets": [{"manifest": "a.json", "weight": 1.0},
                                  {"manifest": "b.json", "weight": 0.5, "langs": ["fr", "en"], "tarred": None}]},
        "preprocessor": {"normalize": "per_feature", "window_size": 0.025, "dither": 1.0e-05, "pad_value": 0.0,
                         "features": 80, "log": True},
        "encoder": {"feat_in": 80, "feat_out": -1, "n_layers": 18, "d_model": 512, "att_context_size": [-1, -1],
                    "xscaling": True, "subsampling": "striding"},
        "decoder": {"feat_in": None, "num_classes": 8,
                    "vocabulary": ["<unk>", "▁", "▁the", "'", "s", "true", "1.0", "a: b", "# x", "it's", "\"q\""]},
        "optim": {"lr": 2.0, "betas": [0.9, 0.98], "sched": {"d_model": "${model.encoder.d_model}", "min_lr": 1e-6,
                                                           "warmup_ratio": None}},
        "text": "a longer description that a dump wraps over several lines, " * 3,
        "multiline": "line one\nline two\n\nline four",
        "inf": float("inf"), "neg": -3, "big": 12345678901234567890, "empty": "", "spaces": " padded ",
    },
}
DUMP_STYLES = {"default": {}, "unicode": dict(allow_unicode=True), "flow": dict(default_flow_style=True),
               "mixed": dict(default_flow_style=None), "narrow": dict(width=24, allow_unicode=True),
               "indent4": dict(indent=4, sort_keys=False)}


@pytest.mark.parametrize("style", sorted(DUMP_STYLES))
def test_yaml_reader_matches_pyyaml_on_dumps(style):
    text = yaml.safe_dump(NEMO_STYLE, **DUMP_STYLES[style])
    assert safe_load(text) == yaml.safe_load(text) == NEMO_STYLE


HANDWRITTEN = """\
# a NeMo-style config written by hand
name: &name ConformerCTC
model:
  sample_rate: 16000   # Hz
  labels: &labels [" ", a, b, "'"]
  train_ds:
    manifest_filepath: null
    sample_rate: ${model.sample_rate}
    tarred_audio_filepaths: ~
    shuffle: yes
    is_tarred: Off
    max_duration: 16.7
    min_duration: 1e-5       # no dot: PyYAML reads a string
    dither: 1.0e-05
    lr: .5
    hex: 0x1F
    octal: 017
    sexagesimal: 1:30
    datasets:
    - manifest: a.json
      weight: 1.0
    -   manifest: 'b''s.json'
        tags: [x, "y, z", {k: v}]
    - - nested
      - list
  decoder:
    vocabulary: *labels
    pieces:
      - "\\u2581the"
      - '▁a'
      - "<unk>"
  note: |
    first line
      indented
    last
  folded: >-
    one
    two

    three
  plain: a value
    that goes on
  quoted: "a \\
    joined line"
  flow: {a: [1, 2,
    3], b: null}
  url: http://example.com/x#y
  who: *name
"""


def test_yaml_reader_on_a_handwritten_config():
    assert safe_load(HANDWRITTEN) == yaml.safe_load(HANDWRITTEN)


def test_yaml_reader_on_chip_smokes_model_config():
    cs = _chip_smoke()
    text = cs.nemo_model_config_yaml(cs.NEMO_LARGE, cs.nemo_vocabulary())
    got = safe_load(text)
    assert got == yaml.safe_load(text)
    assert got["decoder"]["num_classes"] == len(got["decoder"]["vocabulary"]) == 128
    assert got["preprocessor"]["dither"] == 1e-05 and got["tokenizer"]["dir"] is None


@pytest.mark.parametrize("s", ["", "~", "null", "Null", "NULL", "true", "True", "TRUE", "yes", "On", "off", "No", "y", "0",
                               "-0", "017", "0o17", "0x_1F", "0b101", "1_000", "+12", "-3:30", "1.5", "1.", ".5", "-.5",
                               "1e5", "1.0e+5", "1.0e5", "6.8e-05", ".inf", "-.Inf", ".NaN", "nan", "1:30.5", "2024-01-01",
                               "abc", "${x.y}"])
def test_yaml_plain_scalars_resolve_as_pyyaml(s):
    want = yaml.safe_load(f"k: {s}")["k"] if s else None
    got = resolve_plain(s)
    if isinstance(want, float) and math.isnan(want):
        assert isinstance(got, float) and math.isnan(got)
    elif s == "2024-01-01":  # a timestamp to PyYAML, a string here (no NeMo config holds one)
        assert got == s
    else:
        assert type(got) is type(want) and got == want


def _random_doc(rng):
    alphabet = list("ab xyz:#'\"-[]{}|>!&*?,\n\t▁é.0123456789eE+_%@`~\\/") + ["null", "true", "1e-5", "0x1"]

    def string():
        return "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 10)))

    def value(depth=0):
        r = rng.random()
        if depth < 3 and r < 0.2:
            return {string() if rng.random() < 0.7 else rng.randint(-5, 5): value(depth + 1) for _ in range(rng.randint(0, 4))}
        if depth < 3 and r < 0.4:
            return [value(depth + 1) for _ in range(rng.randint(0, 4))]
        if r < 0.6:
            return string()
        if r < 0.7:
            return rng.randint(-10**6, 10**6)
        if r < 0.8:
            return rng.choice([0.1, -2.5e-7, 1e20, float("inf"), 3.0, 1.0e-05])
        if r < 0.9:
            return rng.choice([True, False, None])
        return "".join(rng.choice("abc ") for _ in range(rng.randint(40, 120)))

    doc = {"root": value()}
    if rng.random() < 0.5:  # an object met twice: an anchor and its alias
        shared = [string(), {"k": string()}]
        doc["a"], doc["b"] = shared, {"c": shared}
    return doc


def _same(a, b):
    """Equal values of equal types, NaN equal to NaN."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_yaml_reader_matches_pyyaml_on_random_documents(seed):
    """Seeded random documents of awkward strings, numbers, nulls and nesting,
    dumped in random styles; complex keys (which PyYAML writes for some long
    or multi-line keys) are refused by name."""
    rng = random.Random(seed)
    checked = 0
    for _ in range(150):
        kw = rng.choice(list(DUMP_STYLES.values()) + [dict(width=rng.randint(10, 60))])
        text = yaml.safe_dump(_random_doc(rng), **kw)
        want = yaml.safe_load(text)
        try:
            got = safe_load(text)
        except ValueError as e:
            assert "complex keys" in str(e), (str(e), text)
            continue
        assert _same(got, want), text
        checked += 1
    assert checked >= 120


@pytest.mark.parametrize("text", ["a: !!str 1\n", "? [a, b]\n: c\n", "a: {? x : y}\n", "a: *nowhere\n", '"open: 1\n'])
def test_yaml_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        safe_load(text)


# --- the archive ------------------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["char", "char_dir", "bpe", "bpe_dir"])
def test_archive_trees_are_bit_identical_to_jax(archives, name):
    mine, mcfg, mvocab = load_nemo_conformer(archives[name])
    ref, rcfg, rvocab = j_load_nemo(archives[name])
    assert_same_tree(mine, ref)
    assert dataclasses.asdict(mcfg) == dataclasses.asdict(rcfg)
    assert mvocab == rvocab == VOCABS[name.split("_")[0]]
    assert mcfg.blank_id == mcfg.vocab_size - 1 == len(mvocab)
    assert (mcfg.pos_type, mcfg.subsampling, mcfg.conv_norm, mcfg.frontend, mcfg.xscale) == \
           ("relpos", "striding2d", "affine", "nemo", True)


@pytest.mark.parametrize("extracted", [False, True], ids=["tar", "dir"])
def test_chip_smoke_archive_reads_back(tmp_path, extracted):
    """chip_smoke.write_nemo_archive at small widths (hand-written YAML and
    torch.save): ssak_tpu and the port load the same tree bit for bit, the
    same config and the 128-piece vocabulary, and chip_smoke's own check
    of the loaded model passes."""
    cs = _chip_smoke()
    enc = dict(cs.NEMO_LARGE, n_layers=2, d_model=32, n_heads=2, conv_kernel_size=7)
    path = str(tmp_path / ("d" if extracted else "a.nemo"))
    sd, _, size = cs.write_nemo_archive(path, enc, cs.nemo_vocabulary(), seed=5, extracted=extracted)
    mine, mcfg, mvocab = load_nemo_conformer(path)
    ref, rcfg, rvocab = j_load_nemo(path)
    assert_same_tree(mine, ref)
    assert dataclasses.asdict(mcfg) == dataclasses.asdict(rcfg) and mvocab == rvocab == cs.nemo_vocabulary()
    assert size > 0 and cs.check_nemo_load(torch, sd, TG.load_model(path, device="cpu"), enc) > 0


# --- serving ------------------------------------------------------------------------------------------


def _audio(seed=0):
    rng = np.random.RandomState(seed)
    audio = (0.1 * rng.randn(3, 24000)).astype(np.float32)
    lens = np.array([24000, 16000, 9000], np.int32)
    audio[np.arange(24000)[None, :] >= lens[:, None]] = 0
    return audio, lens


def _f32(model):
    model.cfg = dataclasses.replace(model.cfg, dtype="float32")
    return model


@pytest.mark.parametrize("kind", ["char", "bpe"])
def test_load_model_and_decode_match_jax(archives, kind):
    """load_model on the archive: the synthesised vocabulary (<pad> the blank,
    the word delimiter), then the log-probs of ragged rows in f32 (1e-4) and
    bf16 (correlation >= 0.999), and the greedy texts of the same log-probs."""
    jm, tm = JG.load_model(archives[kind]), TG.load_model(archives[kind], device="cpu")
    assert tm.type == jm.type == TG.ModelType.CONFORMER_CTC
    assert tm.tokenizer.vocab == jm.tokenizer.vocab and tm.vocab() == jm.vocab()
    assert tm.tokenizer.word_delimiter == jm.tokenizer.word_delimiter == (" " if kind == "char" else "▁")
    assert tm.tokenizer.blank_id == tm.cfg.blank_id == len(VOCABS[kind])
    assert TG.load_adapter(tm, archives[kind], "fr") is False
    audio, lens = _audio()
    bf_j, _ = JG.compute_log_probas(jm, jnp.asarray(audio), jnp.asarray(lens))
    bf_t, _ = TG.compute_log_probas(tm, audio, lens)
    assert np.corrcoef(np.asarray(bf_j).ravel(), bf_t.numpy().ravel())[0, 1] >= 0.999
    jm.cfg = dataclasses.replace(jm.cfg, dtype="float32")
    want, wfl = JG.compute_log_probas(jm, jnp.asarray(audio), jnp.asarray(lens))
    got, gfl = TG.compute_log_probas(_f32(tm), audio, lens)
    np.testing.assert_array_equal(gfl.numpy(), np.asarray(wfl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    texts = TG.decode_log_probas(tm, torch.from_numpy(np.asarray(want)), torch.from_numpy(np.asarray(wfl)))
    assert texts == JG.decode_log_probas(jm, want, wfl) and len(texts) == 3


def test_bpe_pieces_decode_and_text_encodes_by_character_as_jax():
    """CTCTokenizer with word_delimiter='▁' joins multi-character pieces and
    turns '▁' into spaces; training text is encoded character by character,
    as ssak_tpu encodes it (a reference behaviour: pieces are never formed)."""
    vocab = {t: i for i, t in enumerate(BPE_VOCAB)}
    vocab["<pad>"] = len(BPE_VOCAB)
    mine, ref = CTCTokenizer(vocab, word_delimiter="▁"), JTok(vocab, word_delimiter="▁")
    ids = [vocab[p] for p in ("▁the", "▁a", "ing", "e▁", "▁", "s", "<pad>", "re")] + [-1]
    assert mine.decode(ids) == ref.decode(ids) == "the ainge  sre"
    text = "the cat's thing"
    assert mine.encode(text) == ref.encode(text)
    assert all(len(mine.id2tok[i]) == 1 for i in mine.encode(text))


def _kaldi(root, lengths=(12000, 40000, 20000), seed=3):
    from ssak_tpu_torch.audio import save_audio

    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "wav.scp"), "w") as f:
        for i, n in enumerate(lengths):
            p = os.path.join(root, f"utt{i}.wav")
            save_audio(p, (rng.randn(n) * 0.1).astype(np.float32), 16000)
            f.write(f"utt{i} {p}\n")
    return root


def test_sak_infer_on_a_kaldi_dir_on_cpu(archives, tmp_path):
    """python -m ssak_tpu_torch.infer.cli KALDI_DIR ARCHIVE --device cpu sends
    a NeMo archive (and its extracted directory) to the CTC CLI: one line per
    file, the transcripts of in-process ctc_infer; without --device it refuses
    to start on a host without a card."""
    from ssak_tpu_torch.infer.cli import model_family
    from ssak_tpu_torch.infer.ctc_infer import ctc_infer

    kaldi = _kaldi(str(tmp_path / "kaldi"))
    for name in ("char", "bpe_dir"):
        assert model_family([kaldi, archives[name]]) == "ctc"
        out = subprocess.run([sys.executable, "-m", "ssak_tpu_torch.infer.cli", kaldi, archives[name], "--device", "cpu"],
                             cwd=REPO, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        want = [f"{i} {t}" for i, t in ctc_infer(archives[name], kaldi, output_ids=True, device="cpu")]
        assert out.stdout.strip().splitlines() == want and [w.split()[0] for w in want] == ["utt0", "utt1", "utt2"]
    if not torch.cuda.is_available():
        refused = subprocess.run([sys.executable, "-m", "ssak_tpu_torch.infer.cli", kaldi, archives["char"]], cwd=REPO,
                                 capture_output=True, text=True, timeout=300)
        assert refused.returncode != 0 and "no CUDA device" in refused.stderr and not refused.stdout.strip()


@pytest.fixture(scope="module")
def beam_setup(archives):
    """f32 log-probs of the char archive (ssak_tpu's, fed to both beams), its
    vocabulary with the blank last, a 30-word lexicon and a word 3-gram."""
    jm = JG.load_model(archives["char"])
    jm.cfg = dataclasses.replace(jm.cfg, dtype="float32")
    audio, lens = _audio(seed=4)
    lp, fl = JG.compute_log_probas(jm, jnp.asarray(audio), jnp.asarray(lens))
    lp = np.asarray(lp) * 3  # sharper rows than a random model's
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    rng = np.random.RandomState(5)
    words = sorted({"".join(CHARS[i] for i in rng.randint(0, 26, rng.randint(1, 4))) for _ in range(30)})
    sentences = [" ".join(rng.choice(words, size=rng.randint(2, 6))) for _ in range(200)]
    out = {"lp": lp.astype(np.float32), "fl": np.asarray(fl), "vocab": jm.vocab(), "blank": jm.cfg.blank_id}
    for tag, LM, Lx in (("jax", JLM, JLx), ("torch", TLM, TLx)):
        lex = Lx.Lexicon(words)
        wlm = LM.train_ngram_lm(sentences, order=3)
        out[tag] = dict(tables=(*lex.device_tables(out["vocab"], word_delimiter=" "), lex.node_word_ids()),
                        word=LM.word_lm_device_tables(wlm, lex.word_list()))
    return out


@pytest.mark.parametrize("mode", ["plain", "lexicon", "lexicon_word_lm"])
def test_device_beam_at_the_last_blank_matches_jax(beam_setup, mode):
    """The device beam at blank = V - 1 (NeMo's), width 8, on the same
    log-probs: the same tokens and lengths as ssak_tpu's, and the blank
    never emitted."""
    s = beam_setup

    def kw(tag):
        if mode == "lexicon":
            return dict(lexicon_tables=s[tag]["tables"][:2])
        if mode == "lexicon_word_lm":
            return dict(lexicon_tables=s[tag]["tables"], word_lm=s[tag]["word"], lm_alpha=0.8, lm_beta=1.2)
        return {}

    want_t, want_l = JB.ctc_beam_search_device(jnp.asarray(s["lp"]), jnp.asarray(s["fl"]), beam_width=8,
                                               blank_id=s["blank"], **kw("jax"))
    got_t, got_l = TB.ctc_beam_search_device(torch.from_numpy(s["lp"]), torch.from_numpy(s["fl"]), beam_width=8,
                                             blank_id=s["blank"], return_async=True, **kw("torch")).result()
    np.testing.assert_array_equal(got_l, want_l)
    np.testing.assert_array_equal(got_t, want_t)
    assert got_l.max() > 0 and not any(s["blank"] in got_t[b, : got_l[b]] for b in range(len(got_l)))


# --- training, checkpoints and exports -------------------------------------------------------------------


TEXTS = ["the cat sat", "a dog ran far", "it is the end", "we sat on a mat", "so far so good", "the end"]


def _train_kaldi(root, seed=0):
    from ssak_tpu_torch.audio import save_audio

    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    scp, text, dur = [], [], []
    for i, t in enumerate(TEXTS):
        n = int(rng.uniform(0.6, 1.8) * 16000)
        p = os.path.join(root, f"u{i}.wav")
        save_audio(p, (0.1 * rng.randn(n)).astype(np.float32), 16000)
        scp.append(f"u{i} {p}")
        text.append(f"u{i} {t}")
        dur.append(f"u{i} {n / 16000:.6f}")
    for name, lines in (("wav.scp", scp), ("text", text), ("utt2dur", dur)):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    return root


def test_ctc_trainer_conformer_matches_jax_and_resumes(archives, tmp_path):
    """CTCTrainer(family="conformer") of both packages from the char archive
    (f32) on one Kaldi dir: the same logged losses (+-2e-4) and grad norms
    (2e-3 relative), the same WER; then a fresh trainer resumes the last
    checkpoint with its step, parameters and optimizer state; ssak_tpu reads
    the port's checkpoint as a Conformer tree."""
    from ssak_tpu.data.dataset import kaldi_folder_to_manifest as j_manifest
    from ssak_tpu.train.loop import CTCTrainer as JTrainer
    from ssak_tpu_torch.data.dataset import kaldi_folder_to_manifest
    from ssak_tpu_torch.train.checkpoint import get_last_checkpoint
    from ssak_tpu_torch.train.loop import CTCTrainer

    d = _train_kaldi(str(tmp_path / "data"))
    jm, tm = JG.load_model(archives["char"]), TG.load_model(archives["char"], device="cpu")
    jcfg = dataclasses.replace(jm.cfg, dtype="float32")
    tcfg = dataclasses.replace(tm.cfg, dtype="float32")
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    kw = dict(learning_rate=3e-3, warmup_steps=1, total_steps=4, batch_size=3, eval_steps=2, mask_time_prob=0.0, seed=3,
              family="conformer", buckets=(2.0,))
    _, jrows = j_manifest(d)
    _, trows = kaldi_folder_to_manifest(d)
    jt = JTrainer(jcfg, jax.tree_util.tree_map(jnp.asarray, tree), jm.tokenizer, str(tmp_path / "j"), **kw)
    tt = CTCTrainer(tcfg, conformer_from_tree(tree), tm.tokenizer, str(tmp_path / "t"), device="cpu", **kw)
    jh = jt.train(jrows, jrows, max_steps=4, log_interval=1)
    th = tt.train(trows, trows, max_steps=4, log_interval=1)
    train_j, train_t = [h for h in jh if "loss" in h], [h for h in th if "loss" in h]
    assert [h["step"] for h in train_t] == [h["step"] for h in train_j] == [1, 2, 3, 4]
    for a, b in zip(train_t, train_j):
        assert abs(a["loss"] - b["loss"]) <= 2e-4 and abs(a["grad_norm"] - b["grad_norm"]) <= 2e-3 * b["grad_norm"] + 2e-4
    evals_j, evals_t = [h for h in jh if "eval_wer" in h], [h for h in th if "eval_wer" in h]
    assert [h["eval_wer"] for h in evals_t] == [h["eval_wer"] for h in evals_j] and len(evals_t) == 3
    t2 = CTCTrainer(tcfg, TG.load_model(archives["char"], device="cpu").module, tm.tokenizer, str(tmp_path / "t"),
                    device="cpu", **kw)
    assert t2.resume() and t2.state["step"] == 4
    assert all(torch.equal(a, b) for a, b in zip(tt.state["model"].parameters(), t2.state["model"].parameters()))
    assert t2.state["opt_state"]["1"]["0"]["count"] == 4
    state, _ = JCK.load_checkpoint(get_last_checkpoint(str(tmp_path / "t")))
    assert_same_tree(state["params"], conformer_to_tree(tt.state["model"]))


def test_train_cli_base_model_archive_then_finalize_on_cpu(archives, tmp_path):
    """python -m ssak_tpu_torch.train.cli TRAIN VALID --base_model ARCHIVE
    --device cpu: family conformer, model_type conformer_ctc, the archive's
    vocabulary; python -m ssak_tpu_torch.train.finalize RUN_DIR --device cpu
    exports it, and both packages load the export as the same tree."""
    d = _train_kaldi(str(tmp_path / "data"), seed=1)
    cmd = [sys.executable, "-m", "ssak_tpu_torch.train.cli", d, d, "--base_model", archives["char_dir"], "--output_dir",
           str(tmp_path / "runs"), "--batch_size", "3", "--max_steps", "2", "--eval_steps", "2", "--warmup_steps", "1",
           "--language", "en", "--device", "cpu"]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    run_dir = json.loads(out.stdout.strip().splitlines()[-1])["run_dir"]
    with open(os.path.join(run_dir, "ssak_config.json")) as f:
        saved = json.load(f)
    assert saved["model_type"] == "conformer_ctc" and saved["config"]["blank_id"] == len(CHAR_VOCAB)
    with open(os.path.join(run_dir, "vocab.json")) as f:
        assert json.load(f) == {**{t: i for i, t in enumerate(CHAR_VOCAB)}, "<pad>": len(CHAR_VOCAB)}
    fin = subprocess.run([sys.executable, "-m", "ssak_tpu_torch.train.finalize", run_dir, "--device", "cpu"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert fin.returncode == 0, fin.stderr[-3000:]
    final = fin.stdout.strip().splitlines()[-1]
    tm = TG.load_model(final, device="cpu")
    jm = JG.load_model(final)
    assert tm.type == jm.type == "conformer_ctc" and dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    assert_same_tree(conformer_to_tree(tm.module), jax.tree_util.tree_map(np.asarray, jm.params))
    assert tm.tokenizer.vocab == jm.tokenizer.vocab


def test_exports_read_across_packages(archives, tmp_path):
    """An ssak_tpu export of a Conformer (sak-finalize's format) loads in the
    port bit for bit with its config, and the port's export loads in
    ssak_tpu; the two give the same f32 log-probs (1e-4)."""
    from ssak_tpu_torch.train.finalize import export_model, load_exported

    jm = JG.load_model(archives["bpe"])
    cfg = dataclasses.replace(jm.cfg, dtype="float32")
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    jdir = JF.export_model(tree, cfg, str(tmp_path / "from_jax"), model_type="conformer_ctc", tokenizer=jm.tokenizer)
    mtype, params, tcfg, tok = load_exported(jdir)
    assert mtype == "conformer_ctc" and dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    assert_same_tree(params, tree)
    tm = TG.load_model(jdir, device="cpu")
    assert_same_tree(conformer_to_tree(tm.module), tree)
    tdir = export_model(conformer_to_tree(tm.module), tm.cfg, str(tmp_path / "from_port"), model_type="conformer_ctc",
                        tokenizer=tm.tokenizer)
    back = JG.load_model(tdir)
    assert back.type == "conformer_ctc" and dataclasses.asdict(back.cfg) == dataclasses.asdict(cfg)
    assert_same_tree(jax.tree_util.tree_map(np.asarray, back.params), tree)
    audio, lens = _audio(seed=6)
    want, _ = JG.compute_log_probas(back, jnp.asarray(audio), jnp.asarray(lens))
    got, _ = TG.compute_log_probas(tm, audio, lens)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_from_tree_builds_a_conformer(archives):
    tree, cfg, vocab = load_nemo_conformer(archives["char"])
    m = TG.from_tree(tree, cfg, device="cpu")
    assert m.type == TG.ModelType.CONFORMER_CTC and m.type in TG.CTC_TYPES
    assert_same_tree(conformer_to_tree(m.module), tree)
    quantized = TG.load_model(archives["char"], quantize_bits=8, device="cpu")  # quantized CTC models are ported
    assert quantized.type == TG.ModelType.CONFORMER_CTC and quantized.cfg == m.cfg
    from ssak_tpu_torch.models.layers import QuantLinear

    assert any(isinstance(s, QuantLinear) for s in quantized.module.modules())
    with pytest.raises(NotImplementedError, match="seeds Whisper and wav2vec2"):
        TG.load_model(None, seeded_test_config="conformer", device="cpu")


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke
