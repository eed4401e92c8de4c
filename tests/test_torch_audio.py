"""The port's host-side ingest (ssak_tpu_torch.audio / .data) against
ssak_tpu's on the same files: WAV decode + mono + resample, the int16
wire, and Kaldi-dir batching. These are numpy copies of the JAX package's
host code, so the results must be identical."""

import numpy as np
import pytest
import torch


from ssak_tpu.audio import load_audio as jax_load_audio, save_audio as jax_save_audio
from ssak_tpu.audio import wire as jax_wire
from ssak_tpu.data.dataset import to_audio_batches as jax_to_audio_batches
from ssak_tpu_torch.audio import load_audio
from ssak_tpu_torch.audio import wire
from ssak_tpu_torch.data.dataset import to_audio_batches
from ssak_tpu_torch.data.prefetch import prefetch_iterator, prefetch_map


@pytest.mark.parametrize("rate,channels,bits", [(16000, 1, 16), (8000, 1, 16), (16000, 2, 32), (22050, 2, 16)])
def test_load_audio_matches(tmp_path, rate, channels, bits):
    rng = np.random.RandomState(rate + channels)
    audio = (rng.randn(rate // 2, channels) * 0.2).clip(-1, 1).astype(np.float32)
    path = str(tmp_path / "a.wav")
    jax_save_audio(path, audio[:, 0] if channels == 1 else audio, rate, bits=bits)
    ref = jax_load_audio(path)
    got = load_audio(path)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_load_audio_refuses_other_formats(tmp_path):
    """MP3, FLAC and the ffmpeg formats are ported (tests/test_torch_audio_ingest.py):
    what neither package can decode, a missing file or bytes that are no
    audio, both refuse with the same error."""
    with pytest.raises(FileNotFoundError):
        jax_load_audio(str(tmp_path / "a.mp3"))
    with pytest.raises(FileNotFoundError):
        load_audio(str(tmp_path / "a.mp3"))
    for ext in (".mp3", ".flac"):
        p = tmp_path / f"noise{ext}"
        p.write_bytes(bytes(range(256)) * 4)
        for fn in (jax_load_audio, load_audio):
            with pytest.raises(ValueError):
                fn(str(p))


def test_wire_matches():
    rng = np.random.RandomState(0)
    rows = [(rng.randn(n) * 0.3).clip(-1, 1).astype(np.float32) for n in (50, 120, 0)]
    rows[0][3] = 1.0  # full scale clips to 32767 in both packages
    for rs in (rows, rows + [np.full(10, 1.5, np.float32)]):  # int16 wire, then the f32 guard
        ref = jax_wire.encode_rows(rs, 4, 100)
        got = wire.encode_rows(rs, 4, 100)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
        dev = wire.to_device_f32(got, "cpu")
        assert dev.dtype == torch.float32
        np.testing.assert_array_equal(dev.numpy(), np.asarray(jax_wire.to_device_f32(ref), np.float32))


def test_to_audio_batches_kaldi_dir_matches(tmp_path):
    rng = np.random.RandomState(1)
    with open(tmp_path / "wav.scp", "w") as f:
        for utt in ("c_utt", "a_utt", "b_utt"):  # unsorted on purpose: both sort by id
            p = tmp_path / f"{utt}.wav"
            jax_save_audio(str(p), (rng.randn(4000) * 0.1).astype(np.float32), 16000)
            f.write(f"{utt} {p}\n")
    ref = list(jax_to_audio_batches(str(tmp_path), batch_size=2, output_ids=True))
    got = list(to_audio_batches(str(tmp_path), batch_size=2, output_ids=True, io_threads=2))
    assert [ids for _, ids in got] == [ids for _, ids in ref] == [["a_utt", "b_utt"], ["c_utt"]]
    for (gb, _), (rb, _) in zip(got, ref):
        for g, r in zip(gb, rb):
            np.testing.assert_array_equal(g, r)
    # a list file of wav paths, and arrays, batch the same way
    lst = tmp_path / "list.txt"
    lst.write_text("".join(f"{tmp_path / u}.wav\n" for u in ("b_utt", "a_utt")))
    assert [ids for _, ids in to_audio_batches(str(lst), batch_size=5, output_ids=True)] == [["b_utt", "a_utt"]]
    arrays = [np.zeros(5, np.float32), np.ones(3, np.float32)]
    assert [ids for _, ids in to_audio_batches(arrays, batch_size=1, output_ids=True)] == [["audio000"], ["audio001"]]


def test_to_audio_batches_refuses_what_is_not_ported(tmp_path):
    """Command pipes are ported (tests/test_torch_audio_ingest.py): a pipe
    whose input file is missing, whole or cut by segments, fails in both
    packages with the same error when it is decoded."""
    (tmp_path / "wav.scp").write_text("u1 sox in.mp3 -t wav - |\n")
    for batches in (jax_to_audio_batches, to_audio_batches):
        with pytest.raises(FileNotFoundError):
            list(batches(str(tmp_path)))
    (tmp_path / "segments").write_text("s1 u1 0.0 1.0\n")
    for batches in (jax_to_audio_batches, to_audio_batches):
        with pytest.raises(FileNotFoundError):
            list(batches(str(tmp_path)))


def test_prefetch_keeps_order_and_reraises():
    assert list(prefetch_map(lambda x: x * x, range(20), workers=3, depth=4)) == [x * x for x in range(20)]
    assert list(prefetch_iterator(iter(range(7)), depth=2)) == list(range(7))

    def broken():
        yield 1
        raise KeyError("producer failed")

    it = prefetch_iterator(broken(), depth=1)
    assert next(it) == 1
    with pytest.raises(KeyError):
        next(it)
