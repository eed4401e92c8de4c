"""Kaldi wav.scp command pipes, read without running them (the port's own
copy of ssak_tpu.audio.soxcmd).

Kaldi data dirs routinely store entries like

    utt1 sox /path/in.mp3 -t wav -r 16k -b 16 -c 1 - |
    utt2 flac -c -d -s /path/in.flac |
    utt3 cat /path/in.wav |

`sox`, `flac` and `cat` commands are parsed, and the decode, trim, downmix
and resample are done with the port's own codecs: no sox or flac binary.
Environment variables in their paths (e.g. $DATAPATH) are expanded here, at
decode time; manifest rows keep the wav.scp text verbatim. Any other
command is run through the shell and its standard output read as WAV, as
ssak_tpu does.
"""

import os
import re
import shlex
import subprocess

import numpy as np

from ssak_tpu_torch.audio.resample import resample, to_mono

_RATE_RE = re.compile(r"^(\d+(?:\.\d+)?)(k?)$", re.IGNORECASE)


def _parse_rate(tok: str) -> int:
    m = _RATE_RE.match(tok)
    if not m:
        raise ValueError(f"cannot parse sox rate: {tok}")
    v = float(m.group(1))
    if m.group(2):
        v *= 1000
    return int(round(v))


def _expand(path: str) -> str:
    return os.path.expandvars(os.path.expanduser(path))


def parse_sox_command(cmd: str):
    """Parse a `sox IN [opts] -` command. Returns (input_path, out_rate, out_channels, trim)."""
    toks = shlex.split(cmd)
    assert toks and toks[0] == "sox"
    toks = toks[1:]
    in_path = None
    out_rate = None
    out_channels = None
    trim = None
    i = 0
    positional = []
    effects = []
    while i < len(toks):
        t = toks[i]
        if t in ("-r", "--rate"):
            val = toks[i + 1]
            # option applies to the *next* positional file; we only honour
            # output-side options (after the input path has been seen)
            if in_path is not None:
                out_rate = _parse_rate(val)
            i += 2
        elif t in ("-c", "--channels"):
            if in_path is not None:
                out_channels = int(toks[i + 1])
            i += 2
        elif t in ("-b", "--bits", "-e", "--encoding", "-t", "--type"):
            i += 2  # output encoding is irrelevant: we produce float32
        elif t in ("-G", "--guard", "-V0", "-V1", "-V2", "-V3", "-q", "-s", "-D"):
            i += 1
        elif t == "-":
            if in_path is None and positional:
                in_path = positional[-1]
            i += 1
        elif t in ("trim", "rate", "channels", "remix", "norm", "gain", "speed", "tempo"):
            effects = toks[i:]
            break
        else:
            positional.append(t)
            if in_path is None:
                in_path = t
            i += 1
    # effects: honour trim (start [length]) and rate/channels effects
    j = 0
    while j < len(effects):
        e = effects[j]
        if e == "trim":
            start = float(effects[j + 1])
            length = float(effects[j + 2]) if j + 2 < len(effects) and not effects[j + 2].isalpha() else None
            trim = (start, length)
            j += 3 if length is not None else 2
        elif e == "rate":
            k = j + 1
            while k < len(effects) and effects[k].startswith("-"):
                k += 1
            out_rate = _parse_rate(effects[k])
            j = k + 1
        elif e == "channels":
            out_channels = int(effects[j + 1])
            j += 2
        else:
            break
    if in_path is None:
        raise ValueError(f"cannot find input file in sox command: {cmd}")
    return _expand(in_path), out_rate, out_channels, trim


def decode_pipe_command(cmd: str, start: float = None, end: float = None):
    """Decode a wav.scp command pipe to (audio float32 (frames,ch), rate).

    start/end are expressed in seconds of the pipe *output* stream (i.e.
    after any sox-side resampling), matching Kaldi segments semantics.
    """
    cmd = cmd.rstrip().rstrip("|").strip()
    prog = shlex.split(cmd)[0]
    from ssak_tpu_torch.audio.io import _decode_file

    if prog == "sox":
        in_path, out_rate, out_channels, trim = parse_sox_command(cmd)
        audio, sr = _decode_file(in_path)
        if trim is not None:
            s0 = int(round(trim[0] * sr))
            s1 = len(audio) if trim[1] is None else s0 + int(round(trim[1] * sr))
            audio = audio[s0:s1]
        if out_channels == 1 and audio.ndim == 2 and audio.shape[1] > 1:
            audio = to_mono(audio)[:, None]
        if out_rate is not None and out_rate != sr:
            audio = resample(audio, sr, out_rate, axis=0)
            sr = out_rate
    elif prog in ("flac", "cat"):
        toks = shlex.split(cmd)
        paths = [t for t in toks[1:] if not t.startswith("-")]
        audio, sr = _decode_file(_expand(paths[-1]))
    else:
        # unknown program: genuinely run the pipe and parse WAV from stdout
        out = subprocess.run(cmd, shell=True, check=True, stdout=subprocess.PIPE).stdout
        import io as _io

        from ssak_tpu_torch.audio import wav as _wav

        f = _io.BytesIO(out)
        fmt = _wav.read_wav_header(f)
        raw = f.read(fmt.data_size if fmt.data_size else None)
        audio, sr = _wav._decode_frames(raw, fmt), fmt.sample_rate
    if start or end is not None:
        s = int(round((start or 0.0) * sr))
        e = len(audio) if end is None else int(round(end * sr))
        audio = audio[s:e]
    return np.asarray(audio, dtype=np.float32), sr


def pipe_command_duration(cmd: str) -> float:
    """Duration of the pipe output, from input headers where possible."""
    cmd2 = cmd.rstrip().rstrip("|").strip()
    prog = shlex.split(cmd2)[0]
    from ssak_tpu_torch.audio.io import get_audio_duration

    if prog == "sox":
        in_path, out_rate, _oc, trim = parse_sox_command(cmd2)
        dur = get_audio_duration(in_path)
        if trim is not None:
            start, length = trim
            dur = min(length, dur - start) if length is not None else dur - start
        return max(0.0, dur)
    if prog in ("flac", "cat"):
        toks = shlex.split(cmd2)
        paths = [t for t in toks[1:] if not t.startswith("-")]
        return get_audio_duration(_expand(paths[-1]))
    audio, sr = decode_pipe_command(cmd)
    return len(audio) / sr
