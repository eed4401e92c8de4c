"""The port's audio ingest against ssak_tpu's on the same files: FLAC
(the port's own decoder, audio/native/flacdec.cpp, against ssak_tpu's
libavcodec route, bit for bit), MP3 (both through libmpg123), sox / flac /
cat / shell command pipes, durations (headers, the parallel C++ scan),
load_audio's return formats, and resample_torch against resample_jax.

FLAC inputs: the committed fixtures of tests/data_torch/ (written by
libavcodec's encoder: LPC subframes, stereo decorrelation; see
tests/data_torch/encode_fixtures.cpp), and seeded files written by the
small encoder below, which lets each test pick every frame and subframe
layout the format has. Decoded FLAC and MP3 audio must be equal bit for
bit: both packages hand the decoder's integers or floats through the same
exact conversions. ssak_tpu's half needs its native library built with
libav and libmpg123 (python -m ssak_tpu.audio.native.build); where it is
not, those comparisons skip and the port is held to the encoder's own
samples.
"""

import os
import shutil
import struct

import numpy as np
import pytest
import torch

from ssak_tpu.audio import io as JIO
from ssak_tpu.audio.native import get_native_lib, scan_durations as j_scan
from ssak_tpu_torch.audio import io as TIO
from ssak_tpu_torch.audio import flac as TF
from ssak_tpu_torch.audio import mp3 as TM
from ssak_tpu_torch.audio.native import scan_durations

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data_torch")


def _jlib():
    lib = get_native_lib()
    return lib if lib is not None and hasattr(lib, "ssak_av_decode") else None


def _need_jax_av():
    if _jlib() is None:
        pytest.skip("ssak_tpu's native audio library (libav) is not built on this host")


def _need_mpg123():
    if not TM.mp3_available():
        pytest.skip("this host has no libmpg123")


# --- a small FLAC encoder ------------------------------------------------------------------
# encode_flac(samples, rate, bps, frames=...) takes integer samples (n, channels)
# and a list of frame specs {"n": blocksize, "mode": 0 | 8 | 9 | 10 (independent,
# left/side, side/right, mid/side), "sub": [subframe spec per channel], "bs_code":
# "table" | 6 | 7, "sr_code": "table" | 0 | 12 | 13 | 14}; a subframe spec is
# ("constant",), ("verbatim",), ("fixed", order) or ("lpc", order, precision,
# shift, seed), with an optional dict last: "wasted" (bits), "rice2", "porder"
# (partition order), "escape" (partition indices). Rice parameters come from
# each partition's mean; a partition whose quotients would run long is escaped.


def crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c ^= b
        for _ in range(8):
            c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
    return c


_CRC16 = []
for _i in range(256):
    _c = _i << 8
    for _ in range(8):
        _c = ((_c << 1) ^ 0x8005) & 0xFFFF if _c & 0x8000 else (_c << 1) & 0xFFFF
    _CRC16.append(_c)


def crc16(data: bytes) -> int:
    c = 0
    for b in data:
        c = ((c << 8) & 0xFFFF) ^ _CRC16[(c >> 8) ^ b]
    return c


class Bits:
    """Fields (value, width) packed MSB first."""

    def __init__(self):
        self.vals, self.lens = [], []

    def put(self, v, n):
        if n:
            self.vals.append(np.array([int(v) & ((1 << n) - 1)], np.uint64))
            self.lens.append(np.array([n], np.int64))

    def put_many(self, vals, lens):
        self.vals.append(np.asarray(vals, np.uint64))
        self.lens.append(np.asarray(lens, np.int64))

    def nbits(self):
        return int(sum(l.sum() for l in self.lens))

    def tobytes(self):
        vals, lens = np.concatenate(self.vals), np.concatenate(self.lens)
        keep = lens > 0
        vals, lens = vals[keep], lens[keep]
        ends = np.cumsum(lens)
        starts = ends - lens
        bits = np.zeros(int(ends[-1]), np.uint8)
        for b in range(int(lens.max())):
            m = lens > b
            bits[starts[m] + b] = (vals[m] >> (lens[m] - 1 - b).astype(np.uint64)) & np.uint64(1)
        assert bits.size % 8 == 0
        return np.packbits(bits).tobytes()


def utf8_number(v: int) -> bytes:
    if v < 0x80:
        return bytes([v])
    for n, lim in ((2, 0x800), (3, 0x10000), (4, 0x200000), (5, 0x4000000), (6, 0x80000000), (7, 1 << 36)):
        if v < lim:
            out = []
            for _ in range(n - 1):
                out.append(0x80 | (v & 0x3F))
                v >>= 6
            lead = (0xFF00 >> n) & 0xFF
            return bytes([lead | v] + out[::-1])
    raise ValueError(v)


_RATE_CODES = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6, 24000: 7, 32000: 8, 44100: 9, 48000: 10,
               96000: 11}
_SIZE_CODES = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6}


def _bs_table(n):
    if n == 192:
        return 1
    for c in range(2, 6):
        if n == 576 << (c - 2):
            return c
    for c in range(8, 16):
        if n == 256 << (c - 8):
            return c
    return None


def _zigzag(r):
    r = np.asarray(r, np.int64)
    return np.where(r >= 0, 2 * r, -2 * r - 1).astype(np.uint64)


def _residual(bits, res, order, n, opts):
    rice2 = opts.get("rice2", False)
    porder = opts.get("porder", 0)
    escapes = set(opts.get("escape", ()))
    bits.put(1 if rice2 else 0, 2)
    bits.put(porder, 4)
    parts = 1 << porder
    size = n >> porder
    kmax, esc = (30, 31) if rice2 else (14, 15)
    pbits = 5 if rice2 else 4
    i = order
    for p in range(parts):
        end = (p + 1) * size
        r = np.asarray(res[i:end], np.int64)
        u = _zigzag(r)
        k = 0 if r.size == 0 else min(kmax, max(0, int(np.log2(float(u.mean()) + 1.0))))
        long_q = r.size and int((u >> np.uint64(k)).max()) > 60
        if p in escapes or long_q:
            width = int(max((int(abs(x)).bit_length() + 1 for x in r), default=0))
            if p in escapes and r.size and not r.any():
                width = 0
            assert width <= 31
            bits.put(esc, pbits)
            bits.put(width, 5)
            if width:
                bits.put_many(r.astype(np.int64).astype(np.uint64) & np.uint64((1 << width) - 1), np.full(r.size, width))
        else:
            bits.put(k, pbits)
            q = (u >> np.uint64(k)).astype(np.int64)
            low = u & np.uint64((1 << k) - 1)
            vals = np.empty(2 * r.size, np.uint64)
            lens = np.empty(2 * r.size, np.int64)
            vals[0::2], lens[0::2] = 1, q + 1
            vals[1::2], lens[1::2] = low, k
            bits.put_many(vals, lens)
        i = end


def _subframe(bits, s, bps, spec):
    kind = spec[0]
    opts = spec[-1] if isinstance(spec[-1], dict) else {}
    wasted = opts.get("wasted", 0)
    s = [int(v) for v in s]
    if wasted:
        assert all(v % (1 << wasted) == 0 for v in s)
        s = [v >> wasted for v in s]
        bps -= wasted
    n = len(s)
    bits.put(0, 1)
    if kind == "constant":
        assert len(set(s)) == 1
        bits.put(0, 6)
    elif kind == "verbatim":
        bits.put(1, 6)
    elif kind == "fixed":
        bits.put(8 + spec[1], 6)
    else:
        bits.put(31 + spec[1], 6)
    if wasted:
        bits.put(1, 1)
        bits.put(1, wasted)  # wasted - 1 zeros, then a one
    else:
        bits.put(0, 1)
    if kind == "constant":
        bits.put(s[0], bps)
        return
    if kind == "verbatim":
        bits.put_many(np.array(s, np.int64).astype(np.uint64) & np.uint64((1 << bps) - 1), np.full(n, bps))
        return
    order = spec[1]
    for v in s[:order]:
        bits.put(v, bps)
    res = [0] * order
    if kind == "fixed":
        c = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}[order]
        res += [s[i] - sum(cj * s[i - 1 - j] for j, cj in enumerate(c)) for i in range(order, n)]
    else:
        _lpc, _order, precision, shift, seed = spec[:5]
        rng = np.random.RandomState(seed)
        base = {1: [1.0], 2: [2.0, -1.0]}.get(order, [1.0] + [0.0] * (order - 1))
        coef = [int(round(b * (1 << shift) * 0.9)) + int(rng.randint(-3, 4)) for b in base]
        lim = 1 << (precision - 1)
        coef = [max(-lim, min(lim - 1, c)) for c in coef]
        bits.put(precision - 1, 4)
        bits.put(shift, 5)
        for c in coef:
            bits.put(c, precision)
        res += [s[i] - (sum(cj * s[i - 1 - j] for j, cj in enumerate(coef)) >> shift) for i in range(order, n)]
    _residual(bits, res, order, n, opts)


def encode_flac(samples, rate, bps, frames, total=True, id3=False, extra_blocks=True, variable=False):
    """FLAC bytes of integer samples (n, channels) cut into `frames` (specs,
    their "n" summing to n). total=False writes 0 samples in STREAMINFO;
    variable=True uses the variable-blocksize strategy (sample numbers)."""
    samples = np.asarray(samples, np.int64)
    if samples.ndim == 1:
        samples = samples[:, None]
    n_all, ch = samples.shape
    assert sum(f["n"] for f in frames) == n_all
    sizes = [f["n"] for f in frames]
    out = bytearray()
    at = 0
    for fi, f in enumerate(frames):
        n = f["n"]
        block = samples[at : at + n]
        mode = f.get("mode", 0)
        hdr = Bits()
        hdr.put(0x3FFE, 14)
        hdr.put(0, 1)
        hdr.put(1 if variable else 0, 1)
        bs_code = f.get("bs_code", "table")
        code = _bs_table(n) if bs_code == "table" else bs_code
        if code is None:
            code = 6 if n <= 256 else 7
        hdr.put(code, 4)
        sr_code = f.get("sr_code", "table")
        if sr_code == "table":
            sr_code = _RATE_CODES.get(rate, 0)
        hdr.put(sr_code, 4)
        hdr.put(mode if mode else ch - 1, 4)
        hdr.put(_SIZE_CODES.get(bps, 0) if f.get("ss_code", "table") == "table" else f["ss_code"], 3)
        hdr.put(0, 1)
        head = hdr.tobytes() + utf8_number(at if variable else fi)
        if code == 6:
            head += bytes([n - 1])
        elif code == 7:
            head += struct.pack(">H", n - 1)
        if sr_code == 12:
            head += bytes([rate // 1000])
        elif sr_code == 13:
            head += struct.pack(">H", rate)
        elif sr_code == 14:
            head += struct.pack(">H", rate // 10)
        head += bytes([crc8(head)])
        body = Bits()
        if mode == 0:
            chans = [(block[:, c], bps) for c in range(ch)]
        else:
            left, right = block[:, 0], block[:, 1]
            side = left - right
            if mode == 8:
                chans = [(left, bps), (side, bps + 1)]
            elif mode == 9:
                chans = [(side, bps + 1), (right, bps)]
            else:
                chans = [((left + right) >> 1, bps), (side, bps + 1)]
        for (s, b), spec in zip(chans, f["sub"]):
            _subframe(body, s, b, spec)
        pad = (-body.nbits()) % 8
        body.put(0, pad)
        frame = head + body.tobytes()
        frame += struct.pack(">H", crc16(frame))
        out += frame
        at += n
    info = struct.pack(">HH", min(sizes), max(sizes)) + b"\0" * 6
    packed = (rate << 44) | ((ch - 1) << 41) | ((bps - 1) << 36) | (n_all if total else 0)
    info += packed.to_bytes(8, "big") + b"\0" * 16
    meta = bytearray(b"fLaC")
    meta += bytes([0x00 if extra_blocks else 0x80]) + len(info).to_bytes(3, "big") + info
    if extra_blocks:
        vendor = b"ssak_tpu_torch tests"
        comment = struct.pack("<I", len(vendor)) + vendor + struct.pack("<I", 0)
        meta += bytes([0x04]) + len(comment).to_bytes(3, "big") + comment
        meta += bytes([0x81]) + (16).to_bytes(3, "big") + b"\0" * 16  # PADDING, the last block
    prefix = b""
    if id3:
        prefix = b"ID3\x04\x00\x00\x00\x00\x00\x0a" + b"\0" * 10
    return prefix + bytes(meta) + bytes(out)


# --- FLAC ----------------------------------------------------------------------------------


def _signal(seed, n, ch, bps, wasted=0):
    """Integer samples (n, ch) of bps bits: tones and noise at 0.4 of full
    scale, multiples of 2^wasted."""
    rng = np.random.RandomState(seed)
    t = np.arange(n)[:, None] / 16000.0
    f = rng.uniform(100, 3000, size=(3, ch))
    x = sum(0.12 * np.sin(2 * np.pi * f[i] * t + i) for i in range(3)) + 0.04 * rng.randn(n, ch)
    full = 1 << (bps - 1)
    s = np.clip(np.round(x * full), -full, full - 1).astype(np.int64)
    return (s >> wasted) << wasted


def _expected(samples, bps):
    """What libavcodec + avdec.cpp give: the samples over 2^(bps-1), exact in f32."""
    return (np.asarray(samples, np.float64) / (1 << (bps - 1))).astype(np.float32)


def _check_flac(path, samples, bps, rate, total=True):
    audio, sr = TF.read_flac(path)
    assert sr == rate and audio.dtype == np.float32
    np.testing.assert_array_equal(audio, _expected(samples, bps))
    got, sr2 = TIO._decode_file(path)
    assert sr2 == rate and np.array_equal(got, audio)
    if total:
        assert scan_durations([path]) == [len(samples) / rate]
    if _jlib() is not None:
        from ssak_tpu.audio.flac import flac_duration as j_dur, read_any as j_read

        ref, rsr = j_read(path)
        assert rsr == rate
        np.testing.assert_array_equal(audio, ref)  # bit for bit with libavcodec's decoder
        if total:
            assert TF.flac_duration(path) == j_dur(path)
            assert scan_durations([path]) == j_scan([path])


def _frames(n, block, sub, **kw):
    out, at = [], 0
    while at < n:
        m = min(block, n - at)
        out.append({"n": m, "sub": sub, **kw})
        at += m
    return out


FLAC_CASES = {
    # mono 16 bit: FIXED orders 0-4, the last frame short (its size in 16 bits)
    "fixed_orders": dict(rate=16000, bps=16, ch=1, frames=[
        {"n": 4096, "sub": [("fixed", o)]} for o in range(4)] + [{"n": 1000, "sub": [("fixed", 4)]}]),
    # stereo 24 bit at 48 kHz, mid/side, LPC 8 with 2^3 Rice2 partitions
    "lpc_mid_side_24": dict(rate=48000, bps=24, ch=2, frames=_frames(9000, 4608, [
        ("lpc", 8, 15, 12, 1, {"rice2": True, "porder": 3}), ("lpc", 8, 15, 12, 2, {"rice2": True, "porder": 3})], mode=10)),
    # 8 and 12 bit stereo, left/side and side/right, LPC 1-3 and FIXED
    "left_side_8": dict(rate=22050, bps=8, ch=2, frames=_frames(5000, 1152, [
        ("lpc", 2, 8, 5, 3, {"porder": 2}), ("fixed", 2)], mode=8)),
    "side_right_12": dict(rate=44100, bps=12, ch=2, frames=_frames(5000, 2304, [
        ("fixed", 1), ("lpc", 3, 9, 6, 4, {"porder": 1})], mode=9)),
    # 20 bit mono: silence as CONSTANT, VERBATIM, escaped partitions, wasted bits
    "constant_verbatim_escape_wasted": dict(rate=44100, bps=20, ch=1, wasted=3, frames=[
        {"n": 576, "sub": [("constant",)], "silence": True},
        {"n": 1152, "sub": [("verbatim", {"wasted": 3})]},
        {"n": 2304, "sub": [("fixed", 2, {"porder": 2, "escape": (0, 2), "wasted": 3})]},
        {"n": 4608, "sub": [("lpc", 4, 12, 9, 5, {"porder": 4, "escape": (1,), "wasted": 2})]},
        {"n": 192, "sub": [("fixed", 0, {"wasted": 1})]}]),
    # every block-size and sample-rate code: 192, 576 * 2^k, 8 and 16 bit sizes,
    # 256 * 2^k; the rate from STREAMINFO, in kHz, in Hz, in tens of Hz
    "block_and_rate_codes": dict(rate=16000, bps=16, ch=1, frames=[
        {"n": n, "sub": [("fixed", 2)], "bs_code": code, "sr_code": sr}
        for n, code, sr in ((192, "table", 0), (576, "table", 12), (1152, "table", 13), (2304, "table", 14),
                            (4608, "table", "table"), (100, 6, 0), (300, 7, 12), (256, "table", 13),
                            (512, "table", 14), (1024, "table", 0), (2048, "table", 12), (8192, "table", 13),
                            (16384, "table", 14))]),
    # three channels, variable block sizes (sample numbers), an ID3v2 tag ahead
    # of fLaC, no sample count in STREAMINFO, only STREAMINFO as metadata
    "three_channels_variable": dict(rate=32000, bps=16, ch=3, variable=True, id3=True, total=False, extra_blocks=False,
                                    frames=[{"n": n, "sub": [("fixed", 1), ("lpc", 2, 14, 11, 6), ("verbatim",)]}
                                            for n in (1000, 333, 4000, 77)]),
    # 4-bit samples, their size only in STREAMINFO
    "bps4_from_streaminfo": dict(rate=8000, bps=4, ch=1, frames=[{"n": 2000, "sub": [("fixed", 2)], "ss_code": 0}]),
}


@pytest.mark.parametrize("case", sorted(FLAC_CASES))
def test_seeded_flac_decodes_bit_for_bit(tmp_path, case):
    c = FLAC_CASES[case]
    n = sum(f["n"] for f in c["frames"])
    samples = _signal(sum(map(ord, case)), n, c["ch"], c["bps"], c.get("wasted", 0))
    at = 0
    for f in c["frames"]:
        if f.get("silence"):
            samples[at : at + f["n"]] = -1 << c.get("wasted", 0)
        at += f["n"]
    data = encode_flac(samples, c["rate"], c["bps"], c["frames"], total=c.get("total", True), id3=c.get("id3", False),
                       extra_blocks=c.get("extra_blocks", True), variable=c.get("variable", False))
    path = str(tmp_path / f"{case}.flac")
    with open(path, "wb") as f:
        f.write(data)
    _check_flac(path, samples, c["bps"], c["rate"], total=c.get("total", True))


@pytest.mark.parametrize("name,rate,ch", [("stereo_48k.flac", 48000, 2), ("mono_16k_24bit.flac", 16000, 1)])
def test_flac_fixtures_match_libavcodec(name, rate, ch):
    """libavcodec's encoder's files (LPC, stereo decorrelation, its own
    partitions): the port's decoder against ssak_tpu's (libavcodec) bit for
    bit, and against the file's own STREAMINFO."""
    path = os.path.join(DATA, name)
    audio, sr = TF.read_flac(path)
    rate_i, ch_i, bps, total = TF.flac_info(path)
    assert (sr, audio.shape[1], rate_i, ch_i, total) == (rate, ch, rate, ch, len(audio))
    assert TF.flac_duration(path) == TIO.get_audio_duration(path) == len(audio) / rate
    assert np.abs(audio).max() < 1.0 and np.abs(audio).max() > 0.3
    _need_jax_av()
    from ssak_tpu.audio.flac import flac_duration as j_dur, read_any as j_read

    ref, rsr = j_read(path)
    assert rsr == rate
    np.testing.assert_array_equal(audio, ref)
    assert TF.flac_duration(path) == j_dur(path)
    np.testing.assert_array_equal(TIO.load_audio(path), JIO.load_audio(path))


def test_flac_duration_rounds_to_microseconds_as_libavformat(tmp_path):
    """STREAMINFO samples over the rate, rounded to the microsecond, ties
    away from zero: 7 samples at 44.1 kHz are 158.73 us, at 48 kHz 145.83."""
    for rate, n in ((44100, 7), (48000, 7), (44100, 44101), (22050, 3), (16000, 17)):
        samples = _signal(n, n, 1, 16)
        path = str(tmp_path / f"d{rate}_{n}.flac")
        with open(path, "wb") as f:
            f.write(encode_flac(samples, rate, 16, [{"n": n, "sub": [("verbatim",)], "bs_code": 7}]))
        want = ((2 * n * 1_000_000 + rate) // (2 * rate)) / 1e6
        assert TF.flac_duration(path) == want
        if _jlib() is not None:
            from ssak_tpu.audio.flac import flac_duration as j_dur

            assert j_dur(path) == want


def test_flac_refuses_broken_streams(tmp_path):
    samples = _signal(0, 3000, 2, 16)
    data = bytearray(encode_flac(samples, 16000, 16, _frames(3000, 1152, [("fixed", 2), ("fixed", 2)])))
    p = tmp_path / "ok.flac"
    p.write_bytes(bytes(data))
    assert TF.read_flac(str(p))[0].shape == (3000, 2)
    bad = bytearray(data)
    bad[-200] ^= 0x10  # inside the last frame's body: its CRC-16 no longer holds
    p.write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="code -5|code -4|code -7"):
        TF.read_flac(str(p))
    p.write_bytes(bytes(data[:-50]))  # cut inside the last frame
    with pytest.raises(ValueError):
        TF.read_flac(str(p))
    p.write_bytes(b"RIFF" + bytes(data[4:]))
    with pytest.raises(ValueError, match="code -1"):
        TF.read_flac(str(p))


# --- MP3 -----------------------------------------------------------------------------------


@pytest.mark.parametrize("name,rate,ch", [("stereo_44k.mp3", 44100, 2), ("mono_16k.mp3", 16000, 1)])
def test_mp3_fixtures_match_jax(name, rate, ch):
    """MPEG-1 and MPEG-2 Layer III from libmp3lame (an ID3v2 tag, a Xing
    frame): durations by the frame walk, decoded audio through libmpg123,
    equal to ssak_tpu's bit for bit."""
    from ssak_tpu.audio import mp3 as JM

    path = os.path.join(DATA, name)
    with open(path, "rb") as f:
        data = f.read()
    assert list(TM.walk_frames(data)) == list(JM.walk_frames(data))
    assert TM.mp3_duration(path) == JM.mp3_duration(path) == TIO.get_audio_duration(path)
    _need_mpg123()
    audio, sr = TM.read_mp3(path)
    assert (sr, audio.shape[1]) == (rate, ch) and audio.dtype == np.float32
    if get_native_lib() is not None:
        ref, rsr = JM.read_mp3(path)
        assert rsr == sr
        np.testing.assert_array_equal(audio, ref)
        for kw in ({}, dict(start=0.25, end=0.75), dict(sample_rate=None, mono=False)):
            np.testing.assert_array_equal(TIO.load_audio(path, **kw), JIO.load_audio(path, **kw))


def test_mp3_without_libmpg123_raises_by_name(monkeypatch):
    """A host without libmpg123 still walks frames for durations; decoding
    raises a RuntimeError that names the library (the card host's case)."""
    from ssak_tpu_torch.audio import native

    class NoMpg123:
        @staticmethod
        def ssak_mp3_available():
            return 0

    monkeypatch.setattr(native, "library", lambda name: NoMpg123)
    path = os.path.join(DATA, "stereo_44k.mp3")
    assert not TM.mp3_available()
    with pytest.raises(RuntimeError, match="libmpg123"):
        TM.read_mp3(path)
    with pytest.raises(RuntimeError, match="libmpg123"):
        TIO.load_audio(path)
    assert TIO.get_audio_duration(path) > 2.0


# --- pipes, durations, return formats ------------------------------------------------------


@pytest.fixture()
def pipe_dir(tmp_path, monkeypatch):
    """A 3 s 8 kHz WAV, a 2 s 48 kHz stereo FLAC and a 1 s 16 kHz WAV under
    a directory named by $SCR_D."""
    rng = np.random.RandomState(3)
    JIO.save_audio(str(tmp_path / "a8k.wav"), (rng.randn(24000) * 0.1).astype(np.float32), 8000)
    s = _signal(5, 96000, 2, 16)
    (tmp_path / "b.flac").write_bytes(encode_flac(s, 48000, 16, _frames(96000, 4608, [("fixed", 2), ("fixed", 2)], mode=10)))
    JIO.save_audio(str(tmp_path / "c.wav"), (rng.randn(16000) * 0.1).astype(np.float32), 16000)
    monkeypatch.setenv("SCR_D", str(tmp_path))
    return tmp_path


PIPES = [
    "sox $SCR_D/a8k.wav -t wav -r 16k -b 16 -c 1 - |",
    "sox $SCR_D/b.flac -t wav -r 16000 -c 1 - |",
    "sox $SCR_D/b.flac -t wav - trim 0.5 1.0 |",
    "sox $SCR_D/a8k.wav -t wav - rate -v 16k |",
    "flac -c -d -s $SCR_D/b.flac |",
    "cat $SCR_D/c.wav |",
    "head -c 100000000 $SCR_D/c.wav |",  # no codec of its own: run through the shell
]


@pytest.mark.parametrize("cmd", PIPES)
def test_pipes_match_jax(pipe_dir, cmd):
    """Each pipe decoded whole, in a [start, end) window, at its native rate
    and in stereo, with its duration: the same arrays and seconds as
    ssak_tpu's (the same numpy and scipy arithmetic); $SCR_D expanded at
    decode time."""
    if cmd.startswith("head") and shutil.which("head") is None:
        pytest.skip("no head binary")
    for kw in ({}, dict(start=0.25, end=0.75), dict(sample_rate=None, mono=False)):
        got, ref = TIO.load_audio(cmd, **kw), JIO.load_audio(cmd, **kw)
        assert got.shape == ref.shape and got.size > 0
        np.testing.assert_array_equal(got, ref)
    assert TIO.get_audio_duration(cmd) == JIO.get_audio_duration(cmd)


def test_parse_sox_command_matches_jax(pipe_dir):
    from ssak_tpu.audio.soxcmd import parse_sox_command as j_parse
    from ssak_tpu_torch.audio.soxcmd import parse_sox_command

    for cmd in [c.rstrip(" |") for c in PIPES if c.startswith("sox")] + [
            "sox -V1 -G $SCR_D/a8k.wav -r 16000 -t wav - channels 1 rate 16k trim 1.5",
            "sox in.mp3 -t wav --rate 22.05k - "]:
        assert parse_sox_command(cmd) == j_parse(cmd)
    with pytest.raises(ValueError):
        parse_sox_command("sox -t wav -r 16k")


def test_durations_and_return_formats(pipe_dir):
    paths = [str(pipe_dir / "a8k.wav"), str(pipe_dir / "b.flac"), os.path.join(DATA, "stereo_44k.mp3"),
             "sox $SCR_D/b.flac -t wav - trim 0.5 1.0 |"]
    for p in paths:
        assert TIO.get_audio_duration(p) == JIO.get_audio_duration(p)
    assert TIO.get_audio_total_duration(paths) == JIO.get_audio_total_duration(paths)
    wav = str(pipe_dir / "c.wav")
    arr = TIO.load_audio(wav)
    assert TIO.load_audio(wav, return_format="bytes") == JIO.load_audio(wav, return_format="bytes")
    np.testing.assert_array_equal(TIO.bytes_to_array(TIO.array_to_bytes(arr)), JIO.bytes_to_array(JIO.array_to_bytes(arr)))
    t = TIO.load_audio(wav, return_format="torch", device="cpu")
    assert t.dtype == torch.float32 and t.device.type == "cpu" and np.array_equal(t.numpy(), arr)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TIO.load_audio(wav, return_format="torch")
    with pytest.raises(ValueError):
        TIO.load_audio(wav, return_format="jax")
    out_t, out_j = str(pipe_dir / "mix_t.wav"), str(pipe_dir / "mix_j.wav")
    TIO.mix_audios([wav, str(pipe_dir / "a8k.wav"), str(pipe_dir / "b.flac")], out_t)
    JIO.mix_audios([wav, str(pipe_dir / "a8k.wav"), str(pipe_dir / "b.flac")], out_j)
    assert open(out_t, "rb").read() == open(out_j, "rb").read()


def test_other_formats_go_through_libav(pipe_dir):
    """Extensions other than .wav, .mp3 and .flac are decoded by the port's
    copy of avdec.cpp (libavformat probes the content: here WAV bytes in a
    .m4a name), as ssak_tpu decodes them."""
    _need_jax_av()
    p = str(pipe_dir / "c.m4a")
    shutil.copy(pipe_dir / "c.wav", p)
    a, sr = TF.read_any(p)
    from ssak_tpu.audio.flac import read_any as j_read

    b, sr2 = j_read(p)
    assert sr == sr2 == 16000 and a.shape == (16000, 1)
    np.testing.assert_array_equal(a, b)
    assert TIO.get_audio_duration(p) == JIO.get_audio_duration(p)


def test_scan_durations_matches_jax(pipe_dir, tmp_path):
    """The parallel header scan: WAV (16 and 32 bit, stereo), FLAC, and None
    for an MP3, a missing file and a pipe-less stranger."""
    rng = np.random.RandomState(4)
    JIO.save_audio(str(tmp_path / "s32.wav"), (rng.randn(3001, 2) * 0.1).astype(np.float32), 22050, bits=32)
    (tmp_path / "junk.bin").write_bytes(b"0123456789abcdef")
    paths = [str(pipe_dir / "a8k.wav"), str(pipe_dir / "b.flac"), str(tmp_path / "s32.wav"),
             os.path.join(DATA, "stereo_48k.flac"), os.path.join(DATA, "mono_16k.mp3"), str(tmp_path / "none.wav"),
             str(tmp_path / "junk.bin")]
    got = scan_durations(paths, n_threads=3)
    assert got == [3.0, 2.0, 3001 / 22050, 0.5, None, None, None]
    assert scan_durations([]) == []
    if get_native_lib() is not None and hasattr(get_native_lib(), "ssak_scan_durations"):
        assert got == j_scan(paths, n_threads=3)


# --- resample_torch ------------------------------------------------------------------------


@pytest.mark.parametrize("orig,target,n", [(16000, 8000, 800), (8000, 16000, 500), (48000, 16000, 900), (44100, 16000, 300)])
def test_resample_torch_matches_resample_jax(orig, target, n):
    """The same lengths (ceil(n * up / down)) and values as resample_jax, to
    1e-5 of the largest output: both sum the same 2 * 24 * max(up, down) + 1
    f32 taps, in different orders. A 44.1 kHz input is kept short: its filter
    has 21,169 taps over a signal stuffed x160."""
    from ssak_tpu.audio import resample_jax
    from ssak_tpu_torch.audio import resample_torch

    rng = np.random.RandomState(n)
    x = (rng.randn(2, n) * 0.3).astype(np.float32)
    ref = np.asarray(resample_jax(x, orig, target))
    got = resample_torch(torch.from_numpy(x), orig, target)
    assert got.shape == ref.shape == (2, int(np.ceil(n * target / orig)))
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    one = resample_torch(x[0], orig, target)  # a 1-D numpy array goes to the CPU
    assert isinstance(one, torch.Tensor) and one.shape == got[0].shape
    assert np.abs(one.numpy() - got[0].numpy()).max() <= 1e-6 * np.abs(ref).max()  # one row, another sum order
    assert resample_torch(x, orig, orig) is x


def test_resample_torch_agrees_with_the_host_resampler():
    """As tests/test_audio.py holds resample_jax: within 0.02 of scipy's
    resample_poly away from the filter edges, on a 300 Hz tone."""
    from ssak_tpu_torch.audio import resample, resample_torch

    for orig, target in ((16000, 8000), (8000, 16000), (48000, 16000)):
        t = np.arange(orig // 4) / orig
        x = np.sin(2 * np.pi * 300 * t).astype(np.float32)
        host, dev = resample(x, orig, target), resample_torch(x, orig, target).numpy()
        n = min(len(host), len(dev))
        assert np.abs(host[100 : n - 100] - dev[100 : n - 100]).max() < 0.02


def test_chip_smoke_flac_writer_reads_back(tmp_path):
    """chip_smoke.flac_bytes, which writes the card run's FLAC corpus
    (mid/side, FIXED order 2, two-byte frame numbers, a short last frame):
    the port's decoder gives the integers written, bit for bit as
    libavcodec does, and its duration comes from STREAMINFO."""
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    for ch, n in ((2, 4096 * 130 + 77), (1, 5000)):
        samples = _signal(ch, n, ch, 16)
        path = str(tmp_path / f"cs{ch}.flac")
        with open(path, "wb") as f:
            f.write(chip_smoke.flac_bytes(samples, 48000))
        _check_flac(path, samples, 16, 48000)
