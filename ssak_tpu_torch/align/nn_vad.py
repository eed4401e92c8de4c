"""Neural VAD: a small trainable per-frame speech classifier (counterpart
of ssak_tpu.align.nn_vad).

40-mel log-mel frames at a 10 ms hop (ops.logmel) -> a ReLU input
projection -> two causal depthwise-separable conv blocks (kernel 9, with
residuals) -> a learned leaky integrator over frames -> one logit a frame.
The integrator is a loop over frames, as ssak_tpu's lax.scan; on the card
each frame is a few launches (host-bound, PERF.md). Weights use torch
layouts: dense (out, in), depthwise conv (H, 1, 9); `vad_from_tree` takes
ssak_tpu's tree, and `save_vad` / `load_vad` keep ssak_tpu's npz keys
("in_proj/kernel", "conv1/depth", ...), so either package reads the other's
file. get_vad_segments(method="nn") turns the probabilities into segments.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FRAME_MS = 10.0  # one decision per 10 ms (log-mel hop 160 at 16 kHz)


class Dense(nn.Module):
    """weight (out, in), bias (out,)."""

    def __init__(self, weight, bias):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class DSConv(nn.Module):
    """Causal depthwise (H, 1, K) conv, then a pointwise dense (H, H)."""

    def __init__(self, depth, point, bias):
        super().__init__()
        self.depth = nn.Parameter(depth)
        self.point = nn.Parameter(point)
        self.bias = nn.Parameter(bias)


class NNVad(nn.Module):
    def __init__(self, tree: dict):
        """tree: the parameters in torch layouts (see vad_from_tree)."""
        super().__init__()
        self.in_proj = Dense(**tree["in_proj"])
        self.conv1 = DSConv(**tree["conv1"])
        self.conv2 = DSConv(**tree["conv2"])
        self.smooth = nn.Parameter(tree["smooth"])
        self.out = Dense(**tree["out"])

    @property
    def device(self):
        return self.smooth.device


def init_params(gen: torch.Generator = None, n_mels: int = 40, hidden: int = 32) -> NNVad:
    """N(0, 0.1²) weights and zero biases, the leak's logit 2.0, from the
    port's own generator."""
    gen = gen or torch.Generator().manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen) * 0.1

    def block():
        return {"depth": normal(hidden, 1, 9), "point": normal(hidden, hidden), "bias": torch.zeros(hidden)}

    return NNVad({"in_proj": {"weight": normal(hidden, n_mels), "bias": torch.zeros(hidden)},
                  "conv1": block(), "conv2": block(), "smooth": torch.tensor(2.0),
                  "out": {"weight": normal(1, hidden), "bias": torch.zeros(1)}})


def vad_from_tree(tree, device=None) -> NNVad:
    """ssak_tpu's parameter tree (dense kernels (in, out), depthwise (K, H))
    -> an NNVad on `device` (default cuda; raises without a card)."""
    from ssak_tpu_torch.utils.env import resolve_device

    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    def block(p):
        return {"depth": t(np.asarray(p["depth"]).T[:, None, :]), "point": t(np.asarray(p["point"]).T),
                "bias": t(p["bias"])}

    m = NNVad({"in_proj": {"weight": t(np.asarray(tree["in_proj"]["kernel"]).T), "bias": t(tree["in_proj"]["bias"])},
               "conv1": block(tree["conv1"]), "conv2": block(tree["conv2"]), "smooth": t(tree["smooth"]),
               "out": {"weight": t(np.asarray(tree["out"]["kernel"]).T), "bias": t(tree["out"]["bias"])}})
    return m.to(resolve_device(device))


def vad_to_tree(model: NNVad) -> dict:
    """The inverse of vad_from_tree: numpy arrays in ssak_tpu's layouts."""

    def a(p):
        return p.detach().cpu().numpy()

    def block(c):
        return {"depth": a(c.depth)[:, 0, :].T.copy(), "point": a(c.point).T.copy(), "bias": a(c.bias)}

    return {"in_proj": {"kernel": a(model.in_proj.weight).T.copy(), "bias": a(model.in_proj.bias)},
            "conv1": block(model.conv1), "conv2": block(model.conv2), "smooth": a(model.smooth),
            "out": {"kernel": a(model.out.weight).T.copy(), "bias": a(model.out.bias)}}


def _logmel_frames(audio: np.ndarray, sample_rate: int, device) -> torch.Tensor:
    """(T,) waveform -> (F, 40) f32 log-mel at a 10 ms hop, 16 kHz, on `device`."""
    from ssak_tpu_torch.ops.logmel import log_mel_spectrogram

    if sample_rate != 16000:
        from ssak_tpu_torch.audio.resample import resample

        audio = resample(np.asarray(audio), sample_rate, 16000)
    x = torch.as_tensor(np.asarray(audio, np.float32), device=device)
    return log_mel_spectrogram(x[None], n_mels=40)[0].T


def _dsconv(x, p: DSConv):
    """Causal depthwise-separable conv along frames: x (B, F, H)."""
    k = p.depth.shape[-1]
    xt = F.pad(x.transpose(1, 2), (k - 1, 0))
    dw = F.conv1d(xt, p.depth, groups=x.shape[-1]).transpose(1, 2)
    return torch.relu(dw @ p.point.T + p.bias)


def frame_logits(model: NNVad, mel):
    """mel: (B, F, n_mels) -> (B, F) speech logits."""
    x = torch.relu(model.in_proj(mel))
    x = x + _dsconv(x, model.conv1)
    x = x + _dsconv(x, model.conv2)
    # the learned leaky temporal integrator, frame by frame
    leak = torch.sigmoid(model.smooth)
    carry = torch.zeros_like(x[:, 0])
    out = []
    for t in range(x.shape[1]):
        carry = leak * carry + (1 - leak) * x[:, t]
        out.append(carry)
    sm = torch.stack(out, dim=1)
    return model.out(sm)[..., 0]


def speech_probs(model: NNVad, audio: np.ndarray, sample_rate: int = 16000) -> np.ndarray:
    """(T,) waveform -> (frames,) speech probability at 10 ms frames, on the
    model's device."""
    mel = _logmel_frames(audio, sample_rate, model.device)
    with torch.no_grad():
        logits = frame_logits(model, mel[None])
    return torch.sigmoid(logits[0]).cpu().numpy().astype(np.float32)


def sigmoid_binary_cross_entropy(logits, labels):
    """optax.sigmoid_binary_cross_entropy, written out."""
    return -labels * F.logsigmoid(logits) - (1 - labels) * F.logsigmoid(-logits)


def train_nn_vad(examples, labels=None, steps: int = 300, lr: float = 3e-3, sample_rate: int = 16000, seed: int = 0,
                 bootstrap: bool = True, device=None, params: NNVad = None) -> NNVad:
    """Train the VAD on (audio, frame_labels) pairs. With labels None and
    bootstrap=True the labels come from the energy VAD (a self-supervised
    distillation the network then smooths). examples: 1-D float32
    waveforms. Adam (train.optim.adam, optax's arithmetic) on the mean
    sigmoid cross-entropy over the valid frames. Runs on `device` (default
    cuda; raises without a card), from `params` (a model to continue, moved
    to the device) or the port's seeded init. Returns the model."""
    from ssak_tpu_torch.align.vad import get_vad_segments
    from ssak_tpu_torch.train import optim
    from ssak_tpu_torch.utils.env import resolve_device

    dev = resolve_device(device)
    mels, ys = [], []
    for i, audio in enumerate(examples):
        mel = _logmel_frames(audio, sample_rate, dev).cpu().numpy()
        n = mel.shape[0]
        if labels is not None:
            y = np.asarray(labels[i], np.float32)[:n]
            y = np.pad(y, (0, n - len(y)))
        elif bootstrap:
            y = np.zeros(n, np.float32)
            for seg in get_vad_segments(audio, sample_rate):
                a = int(seg["start"] * 1000 / FRAME_MS)
                b = int(seg["end"] * 1000 / FRAME_MS)
                y[a: max(b, a + 1)] = 1.0
        else:
            raise ValueError("need labels or bootstrap=True")
        mels.append(mel)
        ys.append(y)

    fmax = max(m.shape[0] for m in mels)
    X = np.stack([np.pad(m, ((0, fmax - m.shape[0]), (0, 0))) for m in mels])
    Y = np.stack([np.pad(y, (0, fmax - len(y))) for y in ys])
    W = np.stack([np.pad(np.ones(len(y)), (0, fmax - len(y))) for y in ys]).astype(np.float32)

    model = (params if params is not None else init_params(torch.Generator().manual_seed(seed), n_mels=X.shape[-1]))
    model = model.to(dev)
    named = dict(model.named_parameters())
    opt = optim.adam(lr)
    opt_state = opt.init(named)
    x, y, w = (torch.from_numpy(a).to(dev) for a in (X, Y, W))
    for _ in range(steps):
        for p in named.values():
            p.grad = None
        ce = sigmoid_binary_cross_entropy(frame_logits(model, x), y)
        loss = (ce * w).sum() / w.sum()
        loss.backward()
        updates, opt_state = opt.update({k: p.grad for k, p in named.items()}, opt_state, named)
        optim.apply_updates(named, updates)
    return model


def save_vad(model: NNVad, path: str):
    """npz with ssak_tpu's "/"-joined keys and layouts."""
    flat = {"/".join(map(str, k)): np.asarray(v) for k, v in _flatten(vad_to_tree(model))}
    np.savez(path, **flat)


def load_vad(path: str, device=None) -> NNVad:
    """An npz of save_vad (either package's) -> an NNVad on `device`
    (default cuda; raises without a card)."""
    data = np.load(path)
    tree = {}
    for key in data.files:
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key]
    return vad_from_tree(tree, device)


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    else:
        yield prefix, tree
