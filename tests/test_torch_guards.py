"""Guards of the port's rules: ssak_tpu_torch (and chip_smoke.py) import
neither JAX nor ssak_tpu, nor the tokenizers, safetensors, transformers,
yaml or websockets packages that the port does without; every module imports with all of them
blocked; entry points default to the GPU and raise without one instead of
running on the CPU; the CLI runs on the CPU only when asked to."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ssak_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "ssak_tpu", "tokenizers", "safetensors", "transformers", "yaml", "websockets")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_no_jax_or_ssak_tpu_imports_by_ast():
    bad = []
    for path in _port_files():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path, a.name) for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and _forbidden(node.module or ""):
                bad.append((path, node.module))
    assert len(_port_files()) > 15
    assert not bad, bad


_BLOCKED_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys
BLOCK = ("jax", "jaxlib", "ssak_tpu", "tokenizers", "safetensors", "transformers", "yaml", "websockets")
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
"""


def test_every_port_module_imports_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


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
