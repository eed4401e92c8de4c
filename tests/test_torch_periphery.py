"""The port's periphery against ssak_tpu's on the CPU: utils/anonymize,
utils/scraping, utils/docs, version, and the smaller public names the port
carries under ssak_tpu's names (ops.logmel.frame_signal,
audio.io.SUPPORTED_EXTENSIONS, data.dataset.AUDIO_SPEC_SEP with
to_audio_batches' ':start-end' windows, infer.ctc_infer.CHUNK_OVERLAP,
decode.native_lm.native_available, decode.ctc_beam.decode_beam_to_text,
models.layers.decode_attention_int8).

Exact, as the same NumPy and standard-library code: anonymize_waveform and
anonymize_kaldi_dir bit for bit under one seed (every file of the output
dir, the audio included), doc2text on DOCX / ODT / XLSX / PDF files built
as tests/test_aux.py builds them, the scraping parsers on local HTML and
against a local http.server (no network), frame_signal, the windows and
decode_beam_to_text. decode_attention_int8 is ssak_tpu's int8 arithmetic
with f32 softmax sums in another order: 1e-4 of its largest value, as
tests/test_torch_layers.py holds self_attention_int8."""

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ssak_tpu
import ssak_tpu.utils.anonymize as JA
import ssak_tpu.utils.docs as JD
import ssak_tpu.utils.scraping as JS
import ssak_tpu_torch
import ssak_tpu_torch.utils.anonymize as TA
import ssak_tpu_torch.utils.docs as TD
import ssak_tpu_torch.utils.scraping as TS
from ssak_tpu_torch.audio import save_audio
from ssak_tpu_torch.data.kaldi_dataset import KaldiDataset, KaldiDatasetRow
from test_aux import TestDocExtraction as _Docs
from test_scraping_tools import TIMEDTEXT_XML, WATCH_HTML

SR = 16000


def test_version_matches_jax():
    from ssak_tpu.version import __version__ as jv
    from ssak_tpu_torch.version import __version__ as tv

    assert tv == jv == ssak_tpu.__version__ == ssak_tpu_torch.__version__


# --- anonymize -----------------------------------------------------------------------------


@pytest.mark.parametrize("semitones", [3.0, -2.5, 4.71, 0.0])
def test_anonymize_waveform_matches_jax(semitones):
    rng = np.random.RandomState(int(abs(semitones) * 10))
    t = np.arange(int(1.3 * SR)) / SR
    audio = (0.3 * np.sin(2 * np.pi * 140 * t) + 0.05 * rng.randn(len(t))).astype(np.float32)
    got = TA.anonymize_waveform(audio, SR, semitones=semitones)
    want = JA.anonymize_waveform(audio, SR, semitones=semitones)
    assert got.dtype == want.dtype == np.float32 and got.shape == audio.shape
    np.testing.assert_array_equal(got, want)


def _anon_source(root):
    """Four utterances of three speakers (one speaker twice), each a window
    of its recording (segments), with texts and genders."""
    rng = np.random.RandomState(3)
    ds = KaldiDataset(name="src")
    for i, (spk, f0, secs, start, end) in enumerate([("alice", 210, 1.0, 0.0, 1.0), ("bob", 110, 0.8, 0.1, 0.7),
                                                     ("alice", 190, 1.4, 0.2, 1.1), ("carol", 170, 0.6, 0.0, 0.6)]):
        t = np.arange(int(secs * SR)) / SR
        wav = root / f"rec{i}.wav"
        save_audio(str(wav), (0.3 * np.sin(2 * np.pi * f0 * t) + 0.02 * rng.randn(len(t))).astype(np.float32), SR)
        ds.append(KaldiDatasetRow(id=f"utt{i}", text=f"texte {i}", audio_id=f"rec{i}", audio_path=str(wav),
                                  start=start, end=end, speaker=spk, gender="f" if spk != "bob" else "m"))
    ds.save(str(root / "src"), check=False)
    return str(root / "src")


def test_anonymize_kaldi_dir_matches_jax(tmp_path):
    src = _anon_source(tmp_path)
    for tag, mod in (("t", TA), ("j", JA)):
        assert mod.anonymize_kaldi_dir(src, str(tmp_path / tag), seed=5) == str(tmp_path / tag)
    t, j = tmp_path / "t", tmp_path / "j"
    files = sorted(os.path.relpath(os.path.join(d, f), j) for d, _, fs in os.walk(j) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), t) for d, _, fs in os.walk(t) for f in fs)
    assert "wav.scp" in files and sum(f.startswith("audio") for f in files) == 4
    for rel in files:
        assert (t / rel).read_bytes().replace(bytes(t), b"OUT") == (j / rel).read_bytes().replace(bytes(j), b"OUT"), rel
    assert "spk001" in (t / "utt2spk").read_text() and "alice" not in (t / "utt2spk").read_text()


def test_anonymize_kaldi_dir_convert_fn_matches_jax(tmp_path):
    src = _anon_source(tmp_path)
    seen = {"t": [], "j": []}
    for tag, mod in (("t", TA), ("j", JA)):
        def convert(audio, spk, tag=tag):
            seen[tag].append((len(audio), spk))
            return audio[::-1].copy()

        mod.anonymize_kaldi_dir(src, str(tmp_path / tag), audio_out_dir=str(tmp_path / f"a_{tag}"), convert_fn=convert)
    assert seen["t"] == seen["j"] and len(seen["t"]) == 4
    for f in sorted(os.listdir(tmp_path / "a_j")):
        assert (tmp_path / "a_t" / f).read_bytes() == (tmp_path / "a_j" / f).read_bytes()


# --- docs ----------------------------------------------------------------------------------


@pytest.mark.parametrize("ext", ["docx", "odt", "xlsx", "pdf"])
def test_doc2text_matches_jax(tmp_path, ext):
    p = str(tmp_path / f"a.{ext}")
    getattr(_Docs(), f"_mk_{ext}")(p)
    got = TD.doc2text(p)
    assert got == JD.doc2text(p) and got.strip()


def test_extractors_match_jax(tmp_path):
    assert sorted(TD.EXTRACTORS) == sorted(JD.EXTRACTORS)
    assert {k: f.__name__ for k, f in TD.EXTRACTORS.items()} == {k: f.__name__ for k, f in JD.EXTRACTORS.items()}
    for mod in (TD, JD):
        with pytest.raises(ValueError, match="unsupported document type"):
            mod.doc2text(str(tmp_path / "x.rtf"))
    raw = b"BT (plain \\(esc\\) \\101\\102 text) Tj [(A) -20 (B)] TJ ET"
    pdf = b"%PDF-1.4\n1 0 obj\n<< /Length 9 >>\nstream\n" + raw + b"\nendstream\nendobj\n"
    (tmp_path / "raw.pdf").write_bytes(pdf)
    assert TD.doc2text(str(tmp_path / "raw.pdf")) == JD.doc2text(str(tmp_path / "raw.pdf")) == "plain (esc) AB text AB"


# --- scraping ------------------------------------------------------------------------------

PAGE = ('<html><head><style>p {color: red}</style></head><body><a href="/a.mp3">x</a><script>var a=1;</script>'
        '<audio src="b.wav"></audio><video><source src="https://cdn.example.org/c.mp4"></video><p>Bonjour</p>'
        '<a href="/a.mp3">again</a><a name="no-href">n</a><p>  deux  </p></body></html>')


def test_scraping_parsers_match_jax(tmp_path):
    for base in (None, "http://example.org/dir/"):
        for pattern in (None, r"\.wav$", r"example"):
            assert TS.find_all_links(PAGE, base_url=base, pattern=pattern) == JS.find_all_links(PAGE, base_url=base,
                                                                                               pattern=pattern)
    assert TS.extract_text(PAGE) == JS.extract_text(PAGE) == "x\nBonjour\nagain\nn\ndeux"
    assert TS.extract_video_ids(WATCH_HTML) == JS.extract_video_ids(WATCH_HTML)
    pr = TS.extract_player_response(WATCH_HTML)
    assert pr == JS.extract_player_response(WATCH_HTML) and pr
    assert TS.video_metadata(pr) == JS.video_metadata(pr) and TS.video_metadata({}) == JS.video_metadata({})
    assert TS.extract_player_response("<html></html>") == JS.extract_player_response("<html></html>") == {}
    j3 = json.dumps({"events": [{"tStartMs": 100, "dDurationMs": 900, "segs": [{"utf8": "sa"}, {"utf8": "lut\n"}]},
                                {"tStartMs": 2000}, {"segs": [{"utf8": "x"}]}, {"tStartMs": 3000, "segs": [{"utf8": " "}]}]})
    for payload in (TIMEDTEXT_XML, j3, "  " + TIMEDTEXT_XML.replace("merci", "<b>merci</b> &lt;3"), ""):
        assert TS.parse_timedtext(payload) == JS.parse_timedtext(payload)
    segs = TS.parse_timedtext(TIMEDTEXT_XML) + [("a;b \"c\"", 3.14159, 0.5)]
    TS.write_transcript_csv(segs, str(tmp_path / "t.csv"))
    JS.write_transcript_csv(segs, str(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    assert TS.read_transcript_csv(str(tmp_path / "t.csv")) == JS.read_transcript_csv(str(tmp_path / "t.csv"))
    assert TS.DEFAULT_HEADERS == JS.DEFAULT_HEADERS


@pytest.fixture()
def page_server():
    """Local pages: /page.html (latin-1 charset), /watch, /file.bin; every
    request's path and User-Agent recorded."""
    seen = []
    blob = bytes(range(256)) * 700

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            seen.append((self.path, self.headers.get("User-Agent")))
            if self.path == "/page.html":
                data, ctype = (PAGE + "<p>café</p>").encode("latin-1"), "text/html; charset=iso-8859-1"
            elif self.path == "/watch":
                data, ctype = WATCH_HTML.encode(), "text/html"
            elif self.path == "/file.bin":
                data, ctype = blob, "application/octet-stream"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    srv = HTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_port}", seen, blob
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def test_scraping_over_a_local_server_matches_jax(page_server, tmp_path):
    url, seen, blob = page_server
    outs = []
    for tag, mod in (("t", TS), ("j", JS)):
        seen.clear()
        out = [mod.fetch_page(url + "/page.html"), mod.find_all_links(url + "/page.html"),
               mod.find_all_links(url + "/page.html", pattern=r"mp3"), mod.extract_video_ids(url + "/watch")]
        path = str(tmp_path / tag / "sub" / "f.bin")
        assert mod.download_link_to_file(url + "/file.bin", path) == path
        assert mod.download_link_to_file(url + "/missing", path) == path  # kept: no request without overwrite
        out.append(open(path, "rb").read() == blob and not os.path.exists(path + ".part"))
        outs.append((out, list(seen)))
    assert outs[0] == outs[1]
    assert "café" in outs[0][0][0] and outs[0][0][-1] is True and len(outs[0][1]) == 5


# --- the smaller names ---------------------------------------------------------------------


@pytest.mark.parametrize("shape,n_fft,hop", [((1000,), 400, 160), ((2, 3, 777), 400, 160), ((2, 512), 64, 16)])
def test_frame_signal_matches_jax(shape, n_fft, hop):
    from ssak_tpu.ops.logmel import frame_signal as jframe
    from ssak_tpu_torch.ops.logmel import frame_signal

    x = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)
    got = frame_signal(torch.from_numpy(x), n_fft, hop)
    want = np.asarray(jframe(jnp.asarray(x), n_fft, hop))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_constants_match_jax():
    import ssak_tpu.audio.io as JIO
    import ssak_tpu.data.dataset as JDS
    import ssak_tpu.infer.ctc_infer as JCI
    import ssak_tpu_torch.audio.io as TIO
    import ssak_tpu_torch.data.dataset as TDS
    import ssak_tpu_torch.infer.ctc_infer as TCI

    assert TIO.SUPPORTED_EXTENSIONS == JIO.SUPPORTED_EXTENSIONS
    assert TDS.AUDIO_SPEC_SEP == JDS.AUDIO_SPEC_SEP
    assert TCI.CHUNK_OVERLAP == JCI.CHUNK_OVERLAP


def test_audio_spec_windows_match_jax(tmp_path):
    """A file with ':start-end,...' windows gives one row a window, with
    ssak_tpu's ids and samples; a spec whose path does not exist, or whose
    windows do not parse, is a path as it is."""
    from ssak_tpu.data.dataset import _parse_audio_spec as jparse
    from ssak_tpu.data.dataset import to_audio_batches as jbatches
    from ssak_tpu_torch.data.dataset import _parse_audio_spec, to_audio_batches

    wav = tmp_path / "a.wav"
    save_audio(str(wav), (0.1 * np.random.RandomState(0).randn(3 * SR)).astype(np.float32), SR)
    for spec in (f"{wav}:0.5-1.25,2-2.5", f"{wav}:1-x", f"{tmp_path}/none.wav:1-2", str(wav), "a:b:1-2"):
        assert _parse_audio_spec(spec) == jparse(spec)
    src = [f"{wav}:0.5-1.25,2-2.5", str(wav)]
    got = list(to_audio_batches(src, batch_size=2, output_ids=True))
    want = list(jbatches(src, batch_size=2, output_ids=True))
    assert [ids for _b, ids in got] == [ids for _b, ids in want] == [["a_0.50-1.25", "a_2.00-2.50"], ["a"]]
    for (gb, _), (wb, _) in zip(got, want):
        for g, w in zip(gb, wb):
            np.testing.assert_array_equal(g, w)


def test_native_available_matches_jax():
    from ssak_tpu.decode.native_lm import native_available as jnative
    from ssak_tpu_torch.decode import native_lm

    assert native_lm.native_available() is jnative() is True  # g++ builds the scorer on this host

    def broken():
        raise RuntimeError("g++ failed")

    orig = native_lm._load_lib
    native_lm._load_lib = broken
    try:
        assert native_lm.native_available() is False
    finally:
        native_lm._load_lib = orig


def test_decode_beam_to_text_matches_jax():
    from ssak_tpu.decode.ctc_beam import decode_beam_to_text as jdecode
    from ssak_tpu.models.tokenizer import CTCTokenizer as JTok
    from ssak_tpu_torch.decode.ctc_beam import decode_beam_to_text
    from ssak_tpu_torch.models.tokenizer import CTCTokenizer

    vocab = {"<pad>": 0, "|": 1, "a": 2, "b": 3, "c": 4, "<unk>": 5}
    tokens = np.array([[2, 3, 1, 4, 4, -1], [4, 1, 1, 2, 0, 0], [-1, -1, -1, -1, -1, -1]], np.int32)
    lengths = np.array([5, 4, 0], np.int32)
    got = decode_beam_to_text(tokens, lengths, CTCTokenizer(dict(vocab)))
    assert got == jdecode(tokens, lengths, JTok(dict(vocab))) == ["ab cc", "c  a", ""]


@pytest.mark.parametrize("Tq", [1, 3])
def test_decode_attention_int8_matches_jax(Tq):
    import ssak_tpu.models.layers as JL
    from ssak_tpu_torch.models import layers as L

    rng = np.random.RandomState(11 + Tq)
    B, H, Dh, T = 2, 3, 16, 20
    q = rng.randn(B, Tq, H, Dh).astype(np.float32)
    kT, vT = rng.randn(B, H, Dh, T).astype(np.float32), rng.randn(B, H, Dh, T).astype(np.float32)
    mask = np.arange(T)[None, None, None, :] < np.array([20, 13])[:, None, None, None]
    jkv = JL.quantize_decode_kv(jnp.asarray(kT), jnp.asarray(vT))
    tkv = L.quantize_decode_kv(torch.from_numpy(kT), torch.from_numpy(vT))
    want = np.asarray(JL.decode_attention_int8(jnp.asarray(q), jkv, mask=jnp.asarray(mask), dtype=jnp.float32))
    got = L.decode_attention_int8(torch.from_numpy(q), tkv, mask=torch.from_numpy(mask), dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    torch.testing.assert_close(got, L.self_attention_int8(torch.from_numpy(q), tkv, mask=torch.from_numpy(mask),
                                                          dtype=torch.float32), rtol=0, atol=0)
