"""Trainable voice conversion, any-to-one (counterpart of
ssak_tpu.augment.vc).

- Analysis and synthesis: the magnitude STFT as DFT matmuls (the hann-
  windowed matrices of ops.logmel), log-mel features, the mel filterbank's
  pseudo-inverse and Griffin-Lim phase recovery (32 iterations from zero
  phase by default). The inverse STFT's overlap-add is F.fold, which sums
  each output sample in a fixed order, so repeats on the card are
  bit-identical (a scatter-add of CUDA atomics is not).
- The converter: a dilated residual 1-D conv stack over mel frames (f32,
  GELU in its tanh form as jax.nn.gelu) with a learned target-voice bias,
  around the identity.
- Training: perturbation invariance. Inputs are resampled (pitch and
  formant shifted) crops of the target speaker's own audio, targets the
  clean mels; the numpy generator draws crops and warps in ssak_tpu's
  order.

Weights use torch layouts (conv (Cout, Cin, K)); `vc_from_tree` takes
ssak_tpu's tree (conv kernels (K, Cin, Cout)), and `save_vc` / `load_vc`
keep ssak_tpu's npz layout (train.checkpoint._flatten keys, lists with
`__len__`). `train_voice_converter` and `convert_kaldi_dir` run on cuda
unless asked for the CPU.
"""

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ssak_tpu_torch.models import layers as L

N_FFT = 400
HOP = 160
SR = 16000


# --- STFT / iSTFT / Griffin-Lim as matmuls --------------------------------


@functools.lru_cache(maxsize=None)
def _synthesis_mats():
    """Inverse windowed DFT (201, n_fft) cos and sin, and the window squared."""
    from ssak_tpu_torch.ops.logmel import hann_window

    n, nf = N_FFT, N_FFT // 2 + 1
    k = np.arange(nf)[:, None]
    t = np.arange(n)[None, :]
    c = np.full((nf, 1), 2.0 / n, np.float32)
    c[0] = c[-1] = 1.0 / n
    w = hann_window(n)[None, :]
    icos = (np.cos(2 * np.pi * k * t / n) * c * w).astype(np.float32)
    isin = (-np.sin(2 * np.pi * k * t / n) * c * w).astype(np.float32)
    return icos, isin, (w[0] ** 2)


@functools.lru_cache(maxsize=None)
def _ola_norm(n_frames: int) -> np.ndarray:
    """The overlap-added squared window of n_frames frames, floored at 1e-8."""
    _icos, _isin, w2 = _synthesis_mats()
    total = (n_frames - 1) * HOP + N_FFT
    idx = np.arange(N_FFT)[None, :] + HOP * np.arange(n_frames)[:, None]
    den = np.zeros((total,), np.float32)
    np.add.at(den, idx.reshape(-1), np.tile(w2, n_frames))
    return np.maximum(den, 1e-8)


def _const(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(a).to(dev)


def stft(audio):
    """(..., T) -> (re, im), each (..., frames, 201); center (reflect) padded."""
    from ssak_tpu_torch.ops.logmel import dft_matrices

    cos_m, sin_m = dft_matrices(N_FFT)
    lead = audio.shape[:-1]
    pad = N_FFT // 2
    x = F.pad(audio.reshape(-1, 1, audio.shape[-1]), (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, N_FFT, HOP)
    re, im = frames @ _const(cos_m, audio.device), frames @ _const(sin_m, audio.device)
    return re.reshape(*lead, *re.shape[1:]), im.reshape(*lead, *im.shape[1:])


def istft(re, im, n_samples: int):
    """(..., frames, 201) re / im -> (..., n_samples) by windowed overlap-add."""
    icos, isin, _w2 = _synthesis_mats()
    dev = re.device
    frames = re @ _const(icos, dev) + im @ _const(isin, dev)  # (..., F, n_fft)
    lead, n_frames = frames.shape[:-2], frames.shape[-2]
    total = (n_frames - 1) * HOP + N_FFT
    cols = frames.reshape(-1, n_frames, N_FFT).transpose(1, 2)  # (B, n_fft, F)
    sig = F.fold(cols, output_size=(1, total), kernel_size=(1, N_FFT), stride=(1, HOP))[:, 0, 0]
    sig = sig / _const(_ola_norm(n_frames), dev)
    pad = N_FFT // 2
    return sig[:, pad : pad + n_samples].reshape(*lead, -1)


def griffin_lim(mag, n_samples: int, iters: int = 32):
    """Phase recovery from a magnitude spectrogram (..., frames, 201)."""
    ph = torch.zeros_like(mag)
    for _ in range(iters):
        x = istft(mag * torch.cos(ph), mag * torch.sin(ph), n_samples)
        re2, im2 = stft(x)
        ph = torch.atan2(im2, re2)
    return istft(mag * torch.cos(ph), mag * torch.sin(ph), n_samples)


# --- mel features ----------------------------------------------------------


def _mel_fb(n_mels):
    from ssak_tpu_torch.ops.logmel import mel_filterbank

    return mel_filterbank(n_mels, N_FFT)  # (n_mels, 201)


@functools.lru_cache(maxsize=None)
def _mel_pinv(n_mels):
    return np.linalg.pinv(_mel_fb(n_mels)).astype(np.float32)  # (201, n_mels)


def audio_to_logmel(audio, n_mels: int = 80):
    """(..., T) -> (..., frames, n_mels): log(mel(|STFT|) + 1e-5)."""
    re, im = stft(audio)
    mag = torch.sqrt(re**2 + im**2 + 1e-10)
    mel = mag @ _const(_mel_fb(n_mels), audio.device).T
    return torch.log(mel + 1e-5)


def logmel_to_audio(logmel, n_samples: int, iters: int = 32):
    """The mel pseudo-inverse -> a linear magnitude -> Griffin-Lim."""
    pinv = _const(_mel_pinv(logmel.shape[-1]), logmel.device)
    mag = torch.clamp((torch.exp(logmel) - 1e-5) @ pinv.T, min=0.0)
    return griffin_lim(mag, n_samples, iters=iters)


# --- converter network ------------------------------------------------------


class VCBlock(nn.Module):
    def __init__(self, c1: L.Conv1d, c2: L.Conv1d, ln: L.LayerNorm):
        super().__init__()
        self.c1, self.c2, self.ln = c1, c2, ln


class VoiceConverter(nn.Module):
    """inp (hidden, n_mels, K), blocks of two (hidden, hidden, K) convs and a
    layer norm, out (n_mels, hidden, K), and the target-voice bias (n_mels,)."""

    def __init__(self, inp: L.Conv1d, blocks, out: L.Conv1d, voice):
        super().__init__()
        self.inp = inp
        self.blocks = nn.ModuleList(blocks)
        self.out = out
        self.voice = nn.Parameter(voice)

    @property
    def device(self):
        return self.voice.device

    @property
    def n_mels(self) -> int:
        return int(self.inp.weight.shape[1])


def init_vc_params(gen: torch.Generator = None, n_mels: int = 80, hidden: int = 128, blocks: int = 4,
                   kernel: int = 5) -> VoiceConverter:
    """layers.conv_init weights (N(0, 1/(K Cin))), zero biases, unit layer
    norms and a zero voice bias, from the port's own generator."""
    gen = gen or torch.Generator().manual_seed(0)
    inp = L.conv_init(gen, kernel, n_mels, hidden)
    out = L.conv_init(gen, kernel, hidden, n_mels)
    blks = [VCBlock(L.conv_init(gen, kernel, hidden, hidden), L.conv_init(gen, kernel, hidden, hidden),
                    L.ln_init(hidden)) for _ in range(blocks)]
    return VoiceConverter(inp, blks, out, torch.zeros(n_mels))


def _conv(x, p: L.Conv1d, dilation: int = 1):
    """x (B, T, Cin) -> (B, T, Cout): f32, stride 1, (K - 1) // 2 * dilation
    zero frames on each side (SAME at dilation 1)."""
    pad = (p.weight.shape[-1] - 1) // 2 * dilation
    y = F.conv1d(x.to(torch.float32).transpose(1, 2), p.weight.to(torch.float32), padding=pad, dilation=dilation)
    y = y.transpose(1, 2)
    return y + p.bias if p.bias is not None else y


def vc_forward(model: VoiceConverter, logmel):
    """logmel (T, M) or (B, T, M) -> the converted logmel, same shape."""
    squeeze = logmel.dim() == 2
    x = logmel[None] if squeeze else logmel
    h = F.gelu(_conv(x, model.inp), approximate="tanh")
    for i, blk in enumerate(model.blocks):
        y = L.layer_norm(h, blk.ln)
        y = F.gelu(_conv(y, blk.c1, 2**i), approximate="tanh")  # dilated receptive field over frames
        y = _conv(y, blk.c2, 1)
        h = h + y
    out = _conv(h, model.out)
    # the residual around the identity: the net learns the voice's delta
    out = x + out + model.voice[None, None, :]
    return out[0] if squeeze else out


def vc_from_tree(tree, device=None) -> VoiceConverter:
    """ssak_tpu's parameter tree (conv kernels (K, Cin, Cout)) -> a
    VoiceConverter on `device` (default cuda; raises without a card)."""
    from ssak_tpu_torch.utils.env import resolve_device

    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    def conv(p):
        return L.Conv1d(t(np.asarray(p["kernel"]).transpose(2, 1, 0)), t(p["bias"]) if "bias" in p else None)

    blocks = [VCBlock(conv(b["c1"]), conv(b["c2"]), L.LayerNorm(t(b["ln"]["scale"]), t(b["ln"]["bias"])))
              for b in tree["blocks"]]
    return VoiceConverter(conv(tree["inp"]), blocks, conv(tree["out"]), t(tree["voice"])).to(resolve_device(device))


def vc_to_tree(model: VoiceConverter) -> dict:
    """The inverse of vc_from_tree: numpy arrays in ssak_tpu's layouts."""

    def a(p):
        return p.detach().cpu().numpy()

    def conv(c):
        return {"kernel": a(c.weight).transpose(2, 1, 0).copy(), "bias": a(c.bias)}

    return {"inp": conv(model.inp),
            "blocks": [{"c1": conv(b.c1), "c2": conv(b.c2), "ln": {"scale": a(b.ln.scale), "bias": a(b.ln.bias)}}
                       for b in model.blocks],
            "out": conv(model.out), "voice": a(model.voice)}


# --- training ---------------------------------------------------------------


def _perturb_source(audio, rng, sample_rate=SR):
    """The target speaker's audio made to sound like another speaker: a
    polyphase resample (pitch and formant shift) re-cropped to the original
    length."""
    from ssak_tpu_torch.audio.resample import resample

    ratio = float(rng.uniform(0.78, 1.28))
    sr2 = int(round(sample_rate * ratio / 100.0) * 100)
    if sr2 == sample_rate:
        return audio
    warped = resample(audio, sample_rate, sr2)
    n = len(audio)
    if len(warped) >= n:
        return warped[:n]
    return np.pad(warped, (0, n - len(warped)))


def train_voice_converter(
    target_audios, steps: int = 300, lr: float = 2e-3, n_mels: int = 80, hidden: int = 128, blocks: int = 4,
    segment_s: float = 2.0, batch: int = 8, seed: int = 0, sample_rate: int = SR, log_every: int = 50,
    device=None, params: VoiceConverter = None,
):
    """Train an any-to-one converter from the TARGET speaker's raw audio (a
    list of float32 arrays): Adam (train.optim.adam) on the mean absolute
    error between the converted perturbed mels and the clean ones. Runs on
    `device` (default cuda; raises without a card), from `params` (moved to
    the device) or the port's seeded init. Returns (model, losses)."""
    from ssak_tpu_torch.train import optim
    from ssak_tpu_torch.utils.env import resolve_device
    from ssak_tpu_torch.utils.monitoring import logger

    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    model = params if params is not None else init_vc_params(torch.Generator().manual_seed(seed), n_mels=n_mels,
                                                             hidden=hidden, blocks=blocks)
    model = model.to(dev)
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    opt = optim.adam(lr)
    opt_state = opt.init(named)
    seg = int(segment_s * sample_rate)
    pool = [a.astype(np.float32) for a in target_audios if len(a) >= HOP * 8]
    if not pool:
        raise ValueError("no usable target audio (need clips >= 80 ms)")

    def sample_pair():
        a = pool[rng.randint(len(pool))]
        if len(a) > seg:
            o = rng.randint(len(a) - seg + 1)
            a = a[o : o + seg]
        else:
            a = np.pad(a, (0, seg - len(a)))
        src = _perturb_source(a, rng, sample_rate)
        return src, a

    losses = []
    for it in range(steps):
        pairs = [sample_pair() for _ in range(batch)]
        src = torch.from_numpy(np.stack([p[0] for p in pairs]).astype(np.float32)).to(dev)
        tgt = torch.from_numpy(np.stack([p[1] for p in pairs]).astype(np.float32)).to(dev)
        with torch.no_grad():
            src_mel, tgt_mel = audio_to_logmel(src, n_mels), audio_to_logmel(tgt, n_mels)
        for p in named.values():
            p.grad = None
        loss = torch.mean(torch.abs(vc_forward(model, src_mel) - tgt_mel))
        loss.backward()
        updates, opt_state = opt.update({k: p.grad for k, p in named.items()}, opt_state, named)
        optim.apply_updates(named, updates)
        losses.append(float(loss.detach()))
        if log_every and (it + 1) % log_every == 0:
            logger.info(f"vc train step {it + 1}/{steps}: L1 {losses[-1]:.4f}")
    return model, losses


# --- inference ---------------------------------------------------------------


def convert_voice(model: VoiceConverter, audio, sample_rate: int = SR, gl_iters: int = 32):
    """A waveform in the trained target voice, on the model's device; the
    output keeps the input's length and RMS (Kaldi segments stay aligned)."""
    audio = np.asarray(audio, np.float32)
    n = len(audio)
    with torch.no_grad():
        mel = audio_to_logmel(torch.from_numpy(audio).to(model.device), model.n_mels)
        out = logmel_to_audio(vc_forward(model, mel), n, iters=gl_iters).cpu().numpy()
    rms_in = float(np.sqrt(np.mean(audio**2)) + 1e-9)
    rms_out = float(np.sqrt(np.mean(out**2)) + 1e-9)
    return np.clip(out * (rms_in / rms_out), -1.0, 1.0)


def save_vc(model: VoiceConverter, path: str):
    """npz in ssak_tpu's layout (train.checkpoint._flatten keys)."""
    from ssak_tpu_torch.train.checkpoint import _flatten

    np.savez(path, **_flatten(vc_to_tree(model)))


def load_vc(path: str, device=None) -> VoiceConverter:
    """An npz of save_vc (either package's) -> a VoiceConverter on `device`
    (default cuda; raises without a card)."""
    from ssak_tpu_torch.train.checkpoint import _unflatten

    with np.load(path, allow_pickle=False) as z:
        return vc_from_tree(_unflatten({k: z[k] for k in z.files}), device)


# --- Kaldi-dir conversion ----------------------------------------------------


def convert_kaldi_dir(
    kaldi_in: str, model_paths, out_dir: str, audio_out_dir: str = None, seed: int = 0, sample_rate: int = SR,
    gl_iters: int = 24, device=None,
):
    """Convert every segment of a Kaldi dir with a target-voice model drawn
    at random per segment, writing a new Kaldi dir and its wavs: ids
    "vc<k>_<id>", speaker "vc<k>", text and utt2dur (3 decimals) per
    segment, spk2utt. model_paths: one or more npz of save_vc. Runs on
    `device` (default cuda; raises without a card)."""
    from ssak_tpu_torch.audio import load_audio, save_audio
    from ssak_tpu_torch.data.dataset import kaldi_folder_to_manifest
    from ssak_tpu_torch.utils.env import resolve_device

    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    if isinstance(model_paths, (str, os.PathLike)):
        model_paths = [model_paths]
    models = [load_vc(p, dev) for p in model_paths]
    audio_out_dir = audio_out_dir or os.path.join(out_dir, "wavs")
    os.makedirs(out_dir, exist_ok=True)
    os.makedirs(audio_out_dir, exist_ok=True)

    _, rows = kaldi_folder_to_manifest(kaldi_in)
    with open(os.path.join(out_dir, "text"), "w", encoding="utf-8") as ftext, \
         open(os.path.join(out_dir, "wav.scp"), "w", encoding="utf-8") as fwav, \
         open(os.path.join(out_dir, "utt2spk"), "w", encoding="utf-8") as futt2spk, \
         open(os.path.join(out_dir, "utt2dur"), "w", encoding="utf-8") as futt2dur:
        for r in rows:
            audio = load_audio(r["audio"], start=r.get("start"), end=r.get("end"), sample_rate=sample_rate)
            k = rng.randint(len(models))
            out = convert_voice(models[k], audio, sample_rate, gl_iters=gl_iters)
            uid = f"vc{k}_{r['id']}"
            wav_path = os.path.join(audio_out_dir, f"{uid}.wav")
            save_audio(wav_path, out, sample_rate)
            ftext.write(f"{uid} {r.get('text') or ''}\n")
            fwav.write(f"{uid} {wav_path}\n")
            futt2spk.write(f"{uid} vc{k}\n")
            futt2dur.write(f"{uid} {len(out) / sample_rate:.3f}\n")
    spk2utt = {}
    with open(os.path.join(out_dir, "utt2spk"), encoding="utf-8") as f:
        for line in f:
            u, s = line.split()
            spk2utt.setdefault(s, []).append(u)
    with open(os.path.join(out_dir, "spk2utt"), "w", encoding="utf-8") as f:
        for s in sorted(spk2utt):
            f.write(f"{s} {' '.join(spk2utt[s])}\n")
    return out_dir
