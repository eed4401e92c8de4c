"""Waveform and spectrogram plots and audio playback (counterpart of
ssak_tpu.utils.viewer: `plot_waveform`, `plot_spectrogram`, `play_audio`,
`play_audiofile`).

Headless: plots render to files with matplotlib (Agg), imported inside each
plotting function (where it is absent, the call raises ImportError naming
it); the spectrogram is ops.logmel's on the CPU. Playback writes a wav and
hands it to the first system player found; without one the path is
returned.
"""

import os
import shutil
import subprocess
import tempfile

import numpy as np


def plot_waveform(audio, sample_rate: int = 16000, segments=None, output: str = None, title: str = None):
    """Waveform with optional segment overlays
    (segments: [{'start','end','label'?}] seconds)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    audio = np.asarray(audio)
    t = np.arange(len(audio)) / sample_rate
    fig, ax = plt.subplots(figsize=(12, 3))
    ax.plot(t, audio, linewidth=0.4)
    if segments:
        for seg in segments:
            ax.axvspan(seg["start"], seg["end"], alpha=0.2, color="tab:orange")
            if seg.get("label"):
                ax.text((seg["start"] + seg["end"]) / 2, ax.get_ylim()[1] * 0.8, seg["label"], ha="center", fontsize=8)
    ax.set_xlabel("seconds")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    output = output or os.path.join(tempfile.gettempdir(), "ssak_waveform.png")
    fig.savefig(output, dpi=110)
    plt.close(fig)
    return output


def plot_spectrogram(audio, sample_rate: int = 16000, output: str = None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    import torch

    from ssak_tpu_torch.ops.logmel import log_mel_spectrogram

    mel = log_mel_spectrogram(torch.as_tensor(np.asarray(audio, np.float32))).numpy()
    fig, ax = plt.subplots(figsize=(12, 3))
    ax.imshow(mel, aspect="auto", origin="lower", interpolation="nearest")
    ax.set_xlabel("frames (10 ms)")
    ax.set_ylabel("mel bin")
    fig.tight_layout()
    output = output or os.path.join(tempfile.gettempdir(), "ssak_spectrogram.png")
    fig.savefig(output, dpi=110)
    plt.close(fig)
    return output


_PLAYERS = ("aplay", "paplay", "play", "afplay", "ffplay")


def play_audio(audio, sample_rate: int = 16000, blocking: bool = True):
    """Play audio through the first available system player; returns the
    wav path (always written) so headless callers can fetch it."""
    from ssak_tpu_torch.audio import save_audio

    path = os.path.join(tempfile.gettempdir(), "ssak_play.wav")
    save_audio(path, np.asarray(audio), sample_rate)
    for player in _PLAYERS:
        if shutil.which(player):
            cmd = [player, path]
            if player == "ffplay":
                cmd = [player, "-nodisp", "-autoexit", path]
            if blocking:
                subprocess.run(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            else:
                subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            return path
    return path


def play_audiofile(path, start: float = None, end: float = None, sample_rate: int = 16000, **kwargs):
    from ssak_tpu_torch.audio import load_audio

    audio = load_audio(path, start=start, end=end, sample_rate=sample_rate)
    return play_audio(audio, sample_rate, **kwargs)
