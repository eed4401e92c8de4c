"""Guards of the port's rules: ssak_tpu_torch (and chip_smoke.py) import
neither JAX nor ssak_tpu, nor the tokenizers, safetensors, transformers,
yaml, websockets or matplotlib packages that the port does without; every module imports with all of them
blocked; entry points default to the GPU and raise without one instead of
running on the CPU; the CLI runs on the CPU only when asked to.

One narrowing: the three plotting modules (PLOTTING) draw on the host after
a run, and may import matplotlib inside a function body, as ssak_tpu's do;
nowhere else, and never at module level."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ssak_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "ssak_tpu", "tokenizers", "safetensors", "transformers", "yaml", "websockets",
             "matplotlib")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


PLOTTING = {os.path.join(PORT, *p.split("/")) for p in ("eval/plots.py", "utils/viewer.py", "utils/debug.py")}


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def _imports(tree):
    """(module name, inside a function body) of every absolute import."""
    out = []

    def visit(node, in_fn):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                out.extend((a.name, in_fn) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                out.append((child.module or "", in_fn))
            visit(child, in_fn or isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)))

    visit(tree, False)
    return out


def test_no_jax_or_ssak_tpu_imports_by_ast():
    bad, lazy_plots = [], set()
    for path in _port_files():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
        for name, in_fn in _imports(tree):
            if name.split(".")[0] == "matplotlib" and in_fn and path in PLOTTING:
                lazy_plots.add(path)
            elif _forbidden(name):
                bad.append((path, name))
    assert len(_port_files()) > 15
    assert not bad, bad
    assert lazy_plots == PLOTTING  # each plotting module draws with matplotlib, imported where it draws


_BLOCKED_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys
BLOCK = ("jax", "jaxlib", "ssak_tpu", "tokenizers", "safetensors", "transformers", "yaml", "websockets", "matplotlib")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked import: " + name)
        return None
for m in list(sys.modules):
    if m.split(".")[0] in BLOCK:
        del sys.modules[m]
sys.meta_path.insert(0, Block())
import ssak_tpu_torch
names = [i.name for i in pkgutil.walk_packages(ssak_tpu_torch.__path__, "ssak_tpu_torch.")]
for n in names:
    importlib.import_module(n)
print(len(names))
print(" ".join(names))
"""


def test_every_port_module_imports_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, names = out.stdout.strip().splitlines()
    assert int(count) >= 15
    # the walk reaches slice 8f's packages and tools
    assert {"ssak_tpu_torch.align.forced", "ssak_tpu_torch.align.nn_vad", "ssak_tpu_torch.augment.vc",
            "ssak_tpu_torch.formats.voicelab", "ssak_tpu_torch.tools.align_audio_transcript",
            "ssak_tpu_torch.tools.convert_voice", "ssak_tpu_torch.tools.get_word_positions"} <= set(names.split())


def _need_gpu_less_host():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a CUDA device")


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    _need_gpu_less_host()
    from ssak_tpu_torch.eval import cli as eval_cli
    from ssak_tpu_torch.infer import cli as infer_cli
    from ssak_tpu_torch.infer.general import from_tree, load_model
    from ssak_tpu_torch.infer.whisper_infer import whisper_infer
    from ssak_tpu_torch.train import finalize
    from ssak_tpu_torch.utils.env import resolve_device

    for family in ("whisper", "wav2vec2", "nemo"):  # model directories, read only once a device is there
        d = tmp_path / family
        d.mkdir()
        if family == "nemo":
            (d / "model_config.yaml").write_text("name: ConformerCTC\n")
        else:
            (d / "config.json").write_text('{"model_type": "%s"}' % family)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_model(str(d))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            infer_cli.main([str(tmp_path), str(d)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        finalize.main([str(tmp_path / "run")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_cli.main([str(tmp_path / "ref"), str(tmp_path / "hyp")])

    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(None, seeded_test_config="whisper")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(None, seeded_test_config="whisper", quantize_bits=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(None, seeded_test_config="whisper", quantize_bits=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        whisper_infer(None, [np.zeros(1600, np.float32)], seeded_test_config="whisper")  # raises at the call
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_tree({}, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_whisper_infer_on_cpu_when_asked():
    from ssak_tpu_torch.infer.whisper_infer import whisper_infer

    rng = np.random.RandomState(0)
    audios = [(rng.randn(n) * 0.1).astype(np.float32) for n in (8000, 16000, 4000)]
    out = list(whisper_infer(None, audios, seeded_test_config="whisper", output_ids=True, max_tokens=4,
                             batch_size=2, device="cpu"))
    assert [i for i, _ in out] == ["audio000", "audio001", "audio002"]
    assert all(len(t.split()) >= 1 for _, t in out)


def test_cli_prints_one_line_per_file(tmp_path):
    _need_gpu_less_host()
    from ssak_tpu_torch.audio import save_audio

    rng = np.random.RandomState(1)
    with open(tmp_path / "wav.scp", "w") as f:
        for i in range(3):
            p = tmp_path / f"utt{i}.wav"
            save_audio(str(p), (rng.randn(12000) * 0.1).astype(np.float32), 16000)
            f.write(f"utt{i} {p}\n")
    cmd = [sys.executable, "-m", "ssak_tpu_torch.infer.whisper_infer", str(tmp_path), "none",
           "--seeded_test_config", "whisper"]
    out = subprocess.run(cmd + ["--device", "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == ["utt0", "utt1", "utt2"]
    refused = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert refused.returncode != 0 and "no CUDA device" in refused.stderr and not refused.stdout.strip()


def test_cli_4bit_accurate_long_and_short_files_on_cpu(tmp_path):
    """--load_in_4bit --accurate on --device cpu: one line per file, for
    files shorter and longer than the seeded model's window (2 s: the
    long-form seek loop); without --device it refuses to start."""
    _need_gpu_less_host()
    from ssak_tpu_torch.audio import save_audio

    rng = np.random.RandomState(2)
    with open(tmp_path / "wav.scp", "w") as f:
        for i, n in enumerate((12000, 52000, 20000)):
            p = tmp_path / f"utt{i}.wav"
            save_audio(str(p), (rng.randn(n) * 0.1).astype(np.float32), 16000)
            f.write(f"utt{i} {p}\n")
    cmd = [sys.executable, "-m", "ssak_tpu_torch.infer.whisper_infer", str(tmp_path), "none",
           "--seeded_test_config", "whisper", "--load_in_4bit", "--accurate"]
    # one intra-op thread: beside other test workers, torch's thread pool
    # oversubscribes the host's cores and spins at each of the run's small ops
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run(cmd + ["--device", "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == ["utt0", "utt1", "utt2"]
    assert all(len(ln.split()) >= 2 and all(t.isdigit() for t in ln.split()[1:]) for ln in lines)
    refused = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert refused.returncode != 0 and "no CUDA device" in refused.stderr and not refused.stdout.strip()


def test_train_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    """CTCTrainer and the train CLI run on cuda unless asked for the CPU; on
    a host without a card they raise at start, before any run dir exists."""
    _need_gpu_less_host()
    from ssak_tpu_torch.models import wav2vec2
    from ssak_tpu_torch.models.tokenizer import CTCTokenizer
    from ssak_tpu_torch.train.loop import CTCTrainer

    cfg = wav2vec2.make_config("tiny_test")
    tok = CTCTokenizer.from_corpus(["oui"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CTCTrainer(cfg, wav2vec2.init_params(cfg), tok, str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CTCTrainer(cfg, wav2vec2.init_params(cfg), tok, str(tmp_path / "b"), device="cuda:0")
    assert CTCTrainer(cfg, wav2vec2.init_params(cfg), tok, str(tmp_path / "c"), device="cpu").device == torch.device("cpu")
    cmd = [sys.executable, "-m", "ssak_tpu_torch.train.cli", str(tmp_path), str(tmp_path), "--output_dir", str(tmp_path / "runs")]
    refused = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert refused.returncode != 0 and "no CUDA device" in refused.stderr and not refused.stdout.strip()
    assert not (tmp_path / "runs").exists()


def test_whisper_fine_tuning_modules_are_guarded_and_need_a_card(tmp_path):
    """models/lora.py and train/whisper_loop.py are among the files the
    import guards read; train_whisper and python -m
    ssak_tpu_torch.train.whisper_loop run on cuda unless asked for the CPU,
    and raise without a card before writing anything."""
    files = {os.path.relpath(p, REPO) for p in _port_files()}
    assert {"ssak_tpu_torch/models/lora.py", "ssak_tpu_torch/train/whisper_loop.py"} <= files
    _need_gpu_less_host()
    from ssak_tpu_torch.models import whisper
    from ssak_tpu_torch.train.whisper_loop import train_whisper

    cfg = whisper.make_config("tiny_test")
    model = whisper.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_whisper(model, cfg, None, [], [], str(tmp_path / "a"), max_steps=1)
    assert not (tmp_path / "a").exists()
    cmd = [sys.executable, "-m", "ssak_tpu_torch.train.whisper_loop", str(tmp_path), str(tmp_path), "--output_dir",
           str(tmp_path / "runs")]
    refused = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert refused.returncode != 0 and "no CUDA device" in refused.stderr and not refused.stdout.strip()
    assert not (tmp_path / "runs").exists()


def test_ctc_serving_modules_are_guarded_and_need_a_card(tmp_path):
    """The quantized-CTC, native-LM, pool, streaming and WebSocket modules
    are among the files the import guards read (the port's copy of the
    scorer's C++ source among its own files); the streaming server and
    ctc_infer's quantized and pooled routes run on cuda unless asked for the
    CPU, and raise without a card."""
    files = {os.path.relpath(p, REPO) for p in _port_files()}
    assert {"ssak_tpu_torch/decode/native_lm.py", "ssak_tpu_torch/decode/pool.py", "ssak_tpu_torch/infer/streaming.py",
            "ssak_tpu_torch/infer/websocket.py", "ssak_tpu_torch/remote/client.py"} <= files
    assert os.path.exists(os.path.join(PORT, "decode", "native", "ngram.cpp"))
    for path in files:
        with open(os.path.join(REPO, path), encoding="utf-8") as f:
            assert "ssak_tpu/decode/native" not in f.read(), path  # no path into the JAX package's C++ source
    _need_gpu_less_host()
    from ssak_tpu_torch.infer.ctc_infer import ctc_infer
    from ssak_tpu_torch.infer.streaming import main as stream_main

    for kw in (dict(quantize_bits=8), dict(quantize_bits=4), dict(num_workers=2, lm_path=str(tmp_path / "lm.arpa"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ctc_infer(None, str(tmp_path), seeded_test_config="wav2vec2", **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream_main(["--seeded_test_config", "wav2vec2", "--port", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream_main(["--seeded_test_config", "wav2vec2", "--port", "0", "--load_in_8bit"])


def test_ingest_modules_are_guarded_and_carry_their_own_sources(tmp_path):
    """Slice 8e's modules are among the files the import guards read; the
    audio codecs' C++ sources are the port's own copies (no path into the
    JAX package's audio/native), built one library per source; the ingest
    CLIs run without a card, and load_audio's tensor format defaults to
    cuda and raises without one."""
    files = {os.path.relpath(p, REPO) for p in _port_files()}
    assert {"ssak_tpu_torch/audio/mp3.py", "ssak_tpu_torch/audio/flac.py", "ssak_tpu_torch/audio/soxcmd.py",
            "ssak_tpu_torch/audio/native/__init__.py", "ssak_tpu_torch/data/kaldi_dataset.py",
            "ssak_tpu_torch/data/kaldi_converter.py", "ssak_tpu_torch/data/segment_ops.py",
            "ssak_tpu_torch/data/tarred.py", "ssak_tpu_torch/utils/config.py",
            "ssak_tpu_torch/tools/kaldi2manifest.py", "ssak_tpu_torch/tools/kaldi_tools.py"} <= files
    for src in ("durations", "flacdec", "mp3dec", "avdec"):
        assert os.path.exists(os.path.join(PORT, "audio", "native", src + ".cpp"))
    for path in files:
        with open(os.path.join(REPO, path), encoding="utf-8") as f:
            assert "ssak_tpu/audio/native" not in f.read(), path
    _need_gpu_less_host()
    from ssak_tpu_torch.audio import load_audio, save_audio

    save_audio(str(tmp_path / "a.wav"), np.zeros(160, np.float32), 16000)
    assert load_audio(str(tmp_path / "a.wav"), return_format="torch", device="cpu").shape == (160,)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_audio(str(tmp_path / "a.wav"), return_format="torch")


def test_alignment_and_training_data_modules_are_guarded_and_need_a_card(tmp_path):
    """Slice 8f's modules are among the files the import guards read; its
    entry points (align_audio_to_transcript through load_model, the tools,
    train_nn_vad, train_voice_converter, convert_kaldi_dir, the VAD and VC
    loaders and the train CLI's --data_augment) run on cuda unless asked for
    the CPU, and raise without a card before writing anything."""
    files = {os.path.relpath(p, REPO) for p in _port_files()}
    assert {"ssak_tpu_torch/align/forced.py", "ssak_tpu_torch/align/dtw.py", "ssak_tpu_torch/align/vad.py",
            "ssak_tpu_torch/align/nn_vad.py", "ssak_tpu_torch/augment/speech.py", "ssak_tpu_torch/augment/vc.py",
            "ssak_tpu_torch/formats/transcription.py", "ssak_tpu_torch/formats/diarization.py",
            "ssak_tpu_torch/formats/transcriber.py", "ssak_tpu_torch/formats/voicelab.py",
            "ssak_tpu_torch/tools/align_audio_transcript.py", "ssak_tpu_torch/tools/get_word_positions.py",
            "ssak_tpu_torch/tools/convert_voice.py"} <= files
    _need_gpu_less_host()
    from ssak_tpu_torch.align import nn_vad
    from ssak_tpu_torch.augment import vc
    from ssak_tpu_torch.tools import align_audio_transcript, convert_voice, get_word_positions

    audio = np.zeros(16000, np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nn_vad.train_nn_vad([audio], steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vc.train_voice_converter([audio], steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vc.convert_kaldi_dir(str(tmp_path), [str(tmp_path / "m.npz")], str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        align_audio_transcript.split_long_audio_kaldifolder(str(tmp_path), str(tmp_path / "split"),
                                                            seeded_test_config="wav2vec2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_word_positions.main([str(tmp_path), "--seeded_test_config", "wav2vec2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert_voice.main(["train", str(tmp_path), "-o", str(tmp_path / "v.npz")])
    nn_vad.save_vad(nn_vad.init_params(), str(tmp_path / "vad.npz"))
    vc.save_vc(vc.init_vc_params(hidden=4, blocks=1), str(tmp_path / "vc.npz"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nn_vad.load_vad(str(tmp_path / "vad.npz"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vc.load_vc(str(tmp_path / "vc.npz"))
    assert not (tmp_path / "out").exists() and not (tmp_path / "split").exists()
    cmd = [sys.executable, "-m", "ssak_tpu_torch.train.cli", str(tmp_path), str(tmp_path), "--output_dir",
           str(tmp_path / "runs"), "--data_augment"]
    refused = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert refused.returncode != 0 and "no CUDA device" in refused.stderr and not (tmp_path / "runs").exists()


def test_parallel_modules_are_guarded_and_need_a_card(tmp_path):
    """Slice 8g's modules (parallel/) are among the files the import guards
    read and import with JAX blocked; init_distributed and ctc_infer
    --tensor_parallel run on cuda unless the CPU is asked for, raise without
    a card, and without a process group of N ranks raise naming torchrun
    (in process and from the CLI), joining no group."""
    import torch.distributed as dist

    files = {os.path.relpath(p, REPO) for p in _port_files()}
    mods = ("mesh", "sharding", "collectives", "moe", "sequence", "pipeline")
    assert {f"ssak_tpu_torch/parallel/{m}.py" for m in mods + ("__init__",)} <= files
    script = _BLOCKED_IMPORT.replace("names = [i.name for i in pkgutil.walk_packages(ssak_tpu_torch.__path__, "
                                     "\"ssak_tpu_torch.\")]",
                                     "names = [" + ", ".join(f"'ssak_tpu_torch.parallel.{m}'" for m in mods) + "]")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == str(len(mods))
    _need_gpu_less_host()
    from ssak_tpu_torch.infer.ctc_infer import ctc_infer
    from ssak_tpu_torch.parallel import init_distributed

    audio = [np.zeros(1600, np.float32)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctc_infer(None, audio, seeded_test_config="wav2vec2", tensor_parallel=2)
    with pytest.raises(ValueError, match="torchrun"):
        ctc_infer(None, audio, seeded_test_config="wav2vec2", tensor_parallel=2, device="cpu")
    assert not dist.is_initialized()
    (tmp_path / "wav.scp").write_text("")
    cmd = [sys.executable, "-m", "ssak_tpu_torch.infer.ctc_infer", str(tmp_path), "none", "--seeded_test_config",
           "wav2vec2", "--tensor_parallel", "2"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    refused = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert refused.returncode != 0 and "no CUDA device" in refused.stderr
    refused = subprocess.run(cmd + ["--device", "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert refused.returncode != 0 and "torchrun" in refused.stderr


def test_host_modules_are_guarded_and_need_a_card(tmp_path):
    """Slice 8i's modules are among the files the import guards read;
    device_memory_stats, classify_speech through load_model and the two CLIs
    it unblocked (kaldi_tools spk2gender, sak-wer --plot) default to the
    card and raise without one, writing nothing."""
    files = {os.path.relpath(p, REPO) for p in _port_files()}
    assert {f"ssak_tpu_torch/utils/{m}.py" for m in ("monitoring", "flops", "gender", "language", "anonymize",
                                                      "scraping", "docs", "viewer", "debug")} <= files
    assert {"ssak_tpu_torch/eval/plots.py", "ssak_tpu_torch/version.py", "ssak_tpu_torch/remote/client.py"} <= files
    _need_gpu_less_host()
    from ssak_tpu_torch.eval import cli as eval_cli
    from ssak_tpu_torch.infer.general import load_model
    from ssak_tpu_torch.tools import kaldi_tools
    from ssak_tpu_torch.utils.monitoring import device_memory_stats

    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_memory_stats()
    assert device_memory_stats("cpu") == {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(None, seeded_test_config="wav2vec2")  # classify_speech's model
    (tmp_path / "wav.scp").write_text("u1 missing.wav\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kaldi_tools.main(["spk2gender", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_cli.main([str(tmp_path / "ref"), str(tmp_path / "hyp"), "--plot", str(tmp_path / "w.png")])
    assert sorted(os.listdir(tmp_path)) == ["wav.scp"]
