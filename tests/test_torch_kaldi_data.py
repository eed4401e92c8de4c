"""The port's Kaldi-data layer against ssak_tpu's on the same directories:
manifest rows (wav.scp values verbatim), check_kaldi_dir's fixes and
reports, KaldiDataset, segment_ops, the corpus converters, tarred shards,
the manifest cache, the train CLI's --config / --set / --use_manifest_cache,
and the two ingest CLIs (python -m ssak_tpu_torch.tools.kaldi2manifest and
.kaldi_tools against tools/kaldi2manifest.py and tools/kaldi_tools.py).

Host code on both sides, the same arithmetic: outputs must be equal, files
byte for byte. The directories mix 16 kHz and 8 kHz WAV, FLAC and MP3 files
(tests/data_torch/) and sox command pipes whose paths hold $SCR_D.
"""

import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tarfile

import numpy as np
import pytest

from ssak_tpu.audio import save_audio
from ssak_tpu.data import dataset as JD
from ssak_tpu.data import kaldi as JK
from ssak_tpu_torch.data import dataset as TD
from ssak_tpu_torch.data import kaldi as TK

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data_torch")
TEXTS = ["bonjour à tous", "le chat dort", "il fait beau aujourd'hui", "ça va très bien", "oui", "l'été est là"]


def _tool(name):
    """tools/<name>.py, the JAX package's CLI, imported from its file."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def corpus(tmp_path, monkeypatch):
    """Audio of every ingest kind under $SCR_D: two 16 kHz WAV, an 8 kHz
    stereo WAV, the FLAC and MP3 fixtures. ssak_tpu reads FLAC headers and
    decodes FLAC and MP3 through its native library (libav, libmpg123),
    built at first use; without it the JAX half cannot run."""
    from ssak_tpu.audio.native import get_native_lib

    lib = get_native_lib()
    if lib is None or not hasattr(lib, "ssak_av_decode"):
        pytest.skip("ssak_tpu's native audio library is not built on this host")
    audio = tmp_path / "audio"
    audio.mkdir()
    rng = np.random.RandomState(0)
    save_audio(str(audio / "w1.wav"), (rng.randn(20000) * 0.1).astype(np.float32), 16000)
    save_audio(str(audio / "w2.wav"), (rng.randn(30000) * 0.1).astype(np.float32), 16000)
    save_audio(str(audio / "s8.wav"), (rng.randn(12000, 2) * 0.1).astype(np.float32), 8000)
    for f in ("stereo_48k.flac", "mono_16k_24bit.flac", "stereo_44k.mp3"):
        shutil.copy(os.path.join(DATA, f), audio / f)
    monkeypatch.setenv("SCR_D", str(audio))
    monkeypatch.setenv("SSAK_TPU_CACHE", str(tmp_path / "jax_cache"))
    monkeypatch.setenv("SSAK_TPU_TORCH_CACHE", str(tmp_path / "torch_cache"))
    return tmp_path


def _write(d, files):
    os.makedirs(d, exist_ok=True)
    for name, lines in files.items():
        with open(os.path.join(d, name), "w", encoding="utf-8") as f:
            f.write("".join(line + "\n" for line in lines))
    return str(d)


def _plain_dir(root, audio, unsorted=True):
    """Utterance = recording: files, a pipe, utt2spk and text with gaps."""
    recs = [("u1", f"{audio}/w1.wav"), ("u2", f"{audio}/w2.wav"), ("u3", f"{audio}/stereo_48k.flac"),
            ("u4", "sox $SCR_D/s8.wav -t wav -r 16k -b 16 -c 1 - |"), ("u5", f"{audio}/mono_16k_24bit.flac"),
            ("u6", f"{audio}/stereo_44k.mp3"), ("u7", "flac -c -d -s $SCR_D/stereo_48k.flac |")]
    if unsorted:
        recs = recs[::-1]
    return _write(root, {
        "wav.scp": [f"{k} {v}" for k, v in recs],
        "text": [f"u{i} {TEXTS[i % 6]}" for i in range(1, 8) if i != 6] + ["ghost bonjour"],
        "utt2spk": [f"u{i} spk{i % 3}" for i in range(1, 8) if i != 2],
        "spk2gender": ["spk0 m", "spk1 f", "spk2 x"],
    })


def _segment_dir(root):
    audio = os.environ["SCR_D"]
    return _write(root, {
        "wav.scp": [f"r1 {audio}/w2.wav", "r2 sox $SCR_D/stereo_48k.flac -t wav -r 16000 -c 1 - |", f"r3 {audio}/w1.wav"],
        "segments": ["a1 r1 0.0 0.8", "a2 r1 0.7 1.5", "a3 r2 0.1 0.45", "a4 r2 0.3 0.2", "a5 rX 0 1", "a6 r3 0.2 1.1"],
        "text": [f"a{i} {TEXTS[i % 6]} ï" for i in range(1, 7)],
        "utt2spk": ["a1 s1", "a2 s2", "a3 s1", "a4 s1", "a5 s3", "a6 s1"],
    })


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d)) if os.path.isfile(os.path.join(d, f))}


# --- the repair: rows keep wav.scp verbatim ------------------------------------------------


def test_manifest_rows_keep_wavscp_values_verbatim(tmp_path, monkeypatch):
    """A wav.scp value holding $SCR_D stays "$SCR_D/a.wav" in the rows of both
    packages, plain, cut by segments, or as a pipe (whose $SCR_D is expanded
    when it is decoded). A plain path with a $VAR then fails to open, in
    both packages alike (ROADMAP.md §3, reference behaviours)."""
    monkeypatch.setenv("SCR_D", "/tmp/x")
    d = _write(tmp_path / "k", {"wav.scp": ["u1 $SCR_D/a.wav"]})
    j, t = JD.kaldi_folder_to_manifest(d), TD.kaldi_folder_to_manifest(d)
    assert t == j
    assert t[1][0]["audio"] == "$SCR_D/a.wav"
    d = _write(tmp_path / "k", {"wav.scp": ["u1 $SCR_D/a.wav", "u2 sox $SCR_D/b.wav -t wav - |"], "text": ["u1 a", "u2 b"]})
    j, t = JD.kaldi_folder_to_manifest(d), TD.kaldi_folder_to_manifest(d)
    assert t == j
    assert [r["audio"] for r in t[1]] == ["$SCR_D/a.wav", "sox $SCR_D/b.wav -t wav - |"]
    s = _write(tmp_path / "s", {"wav.scp": ["r1 $SCR_D/a.wav"], "segments": ["u1 r1 0.5 1.5"]})
    assert TD.kaldi_folder_to_manifest(s) == JD.kaldi_folder_to_manifest(s)
    assert TD.kaldi_folder_to_manifest(s)[1][0]["audio"] == "$SCR_D/a.wav"
    from ssak_tpu.audio import load_audio as j_load
    from ssak_tpu_torch.audio import load_audio as t_load

    for load in (j_load, t_load):
        with pytest.raises(FileNotFoundError):
            load(t[1][0]["audio"])


# --- check_kaldi_dir -----------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["plain", "segments", "sorted_clean"])
def test_check_kaldi_dir_matches_jax(corpus, kind):
    """Both packages fix a copy of the same dir: the same report (removed
    utterances, warnings, counts) and the same files byte for byte (sorted
    keyed files, spk2utt, filtered spk2gender, utt2dur from the headers: the
    C++ scan for WAV and FLAC, the frame walk for MP3, the input's header for
    pipes). fix=False refuses an inconsistent dir in both."""
    audio = str(corpus / "audio")
    make = {"plain": lambda d: _plain_dir(d, audio), "segments": _segment_dir,
            "sorted_clean": lambda d: _write(d, {"wav.scp": [f"u1 {audio}/w1.wav", f"u2 {audio}/stereo_48k.flac"],
                                                 "text": ["u1 oui", "u2 non"], "utt2spk": ["u1 a", "u2 b"]})}[kind]
    jd, td = make(corpus / "j"), make(corpus / "t")
    if kind != "sorted_clean":
        with pytest.raises(JK.KaldiValidationError):
            JK.check_kaldi_dir(jd, fix=False)
        with pytest.raises(TK.KaldiValidationError):
            TK.check_kaldi_dir(td, fix=False)
    jr = JK.check_kaldi_dir(jd, fix=True, language="fr")
    tr = TK.check_kaldi_dir(td, fix=True, language="fr")
    assert tr == jr
    assert _files(td) == _files(jd)
    assert "utt2dur" in _files(td)
    if kind == "plain":  # durations: the scan's, the MP3 frame walk's, the pipe input's header
        durs = TK.read_keyed_file(os.path.join(td, "utt2dur"))
        assert float(durs["u1"]) == 1.25 and float(durs["u4"]) == 1.5 and float(durs["u3"]) == 0.5
    assert TK.compute_durations(TK.parse_wavscp(os.path.join(td, "wav.scp")), num_workers=3) == \
        JK.compute_durations(JK.parse_wavscp(os.path.join(jd, "wav.scp")), num_workers=3)
    with pytest.raises(TK.KaldiValidationError):
        TK.check_kaldi_dir(str(corpus / "nothing"))


def test_keyed_file_helpers_match_jax(tmp_path):
    u2s = {"b": "s2", "a": "s1", "c": "s1"}
    assert TK.utt2spk_to_spk2utt(u2s) == JK.utt2spk_to_spk2utt(u2s)
    s2u = TK.utt2spk_to_spk2utt(u2s)
    assert TK.spk2utt_to_utt2spk(s2u) == JK.spk2utt_to_utt2spk(s2u)
    for mod, name in ((TK, "t"), (JK, "j")):
        mod.write_keyed_file(str(tmp_path / f"{name}_k"), {"z": "1", "a": "", "m": "x y"})
        mod.write_segments(str(tmp_path / f"{name}_s"), {"u2": ("r", 1.0, 2.5), "u1": ("r", 0.0, 1.0004)})
    for f in ("k", "s"):
        assert (tmp_path / f"t_{f}").read_bytes() == (tmp_path / f"j_{f}").read_bytes()


# --- KaldiDataset, segment_ops -------------------------------------------------------------


def _rows(ds):
    return [dataclasses.asdict(r) for r in ds]


def test_kaldi_dataset_matches_jax(corpus):
    from ssak_tpu.data.kaldi_dataset import KaldiDataset as JDS
    from ssak_tpu_torch.data.kaldi_dataset import KaldiDataset as TDS
    from ssak_tpu_torch.data.kaldi_dataset import KaldiDatasetRow

    src = _segment_dir(corpus / "src")
    JK.check_kaldi_dir(src)
    j, t = JDS.load(src), TDS.load(src)
    assert _rows(t) == _rows(j) and t.name == j.name and len(t) == 4
    assert t.speakers() == j.speakers() and t.total_duration() == j.total_duration()
    assert _rows(t.filter_by_duration(0.5, 1.0)) == _rows(j.filter_by_duration(0.5, 1.0))
    assert _rows(t.filter_by_speaker(["s1"], keep=False)) == _rows(j.filter_by_speaker(["s1"], keep=False))
    assert _rows(t.filter_by_audio(lambda r: "sox" in r.audio_path)) == _rows(j.filter_by_audio(lambda r: "sox" in r.audio_path))
    for kw in (dict(by_speaker=True, seed=1), dict(by_speaker=False, seed=2, ratios=(0.5, 0.25, 0.25))):
        assert [_rows(p) for p in t.split(**kw)] == [_rows(p) for p in j.split(**kw)]
    t.append({"id": "bad", "audio_path": "$SCR_D/missing.wav", "start": 0.0, "end": 1.0})
    j.append({"id": "bad", "audio_path": "$SCR_D/missing.wav", "start": 0.0, "end": 1.0})
    assert not t.append(KaldiDatasetRow(id="neg", start=2.0, end=1.0), show_warnings=False)
    assert t.audio_checks() == j.audio_checks() == ["bad"]
    assert _rows(t.normalize_dataset("fr")) == _rows(j.normalize_dataset("fr"))
    t.rows.pop(), j.rows.pop()
    t.save(str(corpus / "t_out")), j.save(str(corpus / "j_out"))
    assert _files(str(corpus / "t_out")) == _files(str(corpus / "j_out"))


def test_segment_ops_match_jax(corpus):
    from ssak_tpu.data import segment_ops as JS
    from ssak_tpu.data.kaldi_dataset import KaldiDataset as JDS
    from ssak_tpu_torch.data import segment_ops as TS
    from ssak_tpu_torch.data.kaldi_dataset import KaldiDataset as TDS

    rows = [dict(id=f"x{i}", audio_id=rec, audio_path=f"$SCR_D/{rec}.wav", start=s, end=e, speaker=spk, text=f"t{i}")
            for i, (rec, s, e, spk) in enumerate([("r1", 0.0, 1.0, "a"), ("r1", 0.9, 2.0, "b"), ("r1", 2.1, 3.0, "a"),
                                                  ("r1", 3.2, 4.0, "a"), ("r2", 0.0, 5.0, "c"), ("r2", 5.3, 9.0, "c"),
                                                  ("r2", 9.1, 20.0, "c")])]

    def both():
        return TDS(rows=[], name="n"), JDS(rows=[], name="n")

    t, j = both()
    for r in rows:
        t.append(dict(r)), j.append(dict(r))
    assert TS.find_overlapping_segments(t) == JS.find_overlapping_segments(j)
    for kw in (dict(), dict(mode="all"), dict(mode="all", max_silence=0.15, max_duration=4.0)):
        assert _rows(TS.glue_overlapping_segments(t, **kw)) == _rows(JS.glue_overlapping_segments(j, **kw))
    for kw in (dict(), dict(rename_utt_ids=False), dict(rename_audio_ids=False, rename_speakers=False)):
        t, j = both()
        for r in rows:
            t.append(dict(r)), j.append(dict(r))
        assert _rows(TS.rename_ids(t, "r", "R-", **kw)) == _rows(JS.rename_ids(j, "r", "R-", **kw))


# --- corpus converters ---------------------------------------------------------------------

TEI = """<?xml version="1.0" encoding="UTF-8"?>
<TEI xmlns="http://www.tei-c.org/ns/1.0"><teiHeader><profileDesc><particDesc><listPerson>
<person xml:id="L1" sex="2"/><person xml:id="L2" sex="1"/></listPerson></particDesc></profileDesc></teiHeader>
<text><timeline><when xml:id="T0" absolute="00:00:00.00"/><when xml:id="T1" absolute="00:00:01.50"/>
<when xml:id="T2" absolute="00:00:03.25"/><when xml:id="T3" absolute="00:00:05.00"/></timeline>
<body><anchor synch="#T0"/><u who="#L1"><w>bonjour</w><w>à</w><anchor synch="#T1"/><w>tous</w>
<choice><orig>ben</orig><reg>bien</reg></choice></u><anchor synch="#T2"/><u who="#L2"><seg><w>oui</w><w>merci</w></seg></u>
</body></text></TEI>"""


TEXTGRID = """File type = "ooTextFile"
Object class = "TextGrid"

xmin = 0
xmax = 4.5
tiers? <exists>
size = 2
item []:
    item [1]:
        class = "IntervalTier"
        name = "words"
        xmin = 0
        xmax = 4.5
        intervals: size = 4
        intervals [1]:
            xmin = 0
            xmax = 1.25
            text = "bonjour à tous"
        intervals [2]:
            xmin = 1.25
            xmax = 1.255
            text = "euh"
        intervals [3]:
            xmin = 1.255
            xmax = 2.0
            text = ""
        intervals [4]:
            xmin = 2.0
            xmax = 4.5
            text = "  merci bien "
    item [2]:
        class = "IntervalTier"
        name = "speaker"
        xmin = 0
        xmax = 4.5
        intervals: size = 2
        intervals [1]:
            xmin = 0
            xmax = 2.0
            text = "L1"
        intervals [2]:
            xmin = 2.0
            xmax = 4.5
            text = "L2"
"""


def test_converters_match_jax(corpus):
    from ssak_tpu.data import kaldi_converter as JC
    from ssak_tpu_torch.data import kaldi_converter as TC

    root = corpus / "corpus"
    (root / "wavs" / "sub").mkdir(parents=True)
    (root / "txt").mkdir()
    for i, f in enumerate(("w1.wav", "stereo_48k.flac", "stereo_44k.mp3")):
        shutil.copy(corpus / "audio" / f, root / "wavs" / ("sub" if i else "") / f"spk{i}-utt{i}{os.path.splitext(f)[1]}")
        (root / "txt" / f"spk{i}-utt{i}.txt").write_text(f" {TEXTS[i]} \n", encoding="utf-8")
    (root / "meta.tsv").write_text("id\tspeaker\tgender\nspk0-utt0\tA\tfemale\nspk2-utt2\tB\th\n", encoding="utf-8")
    (root / "genders.tsv").write_text("A\t2\nB\tM\n", encoding="utf-8")
    (root / "lines.txt").write_text("un\ndeux\ntrois\n", encoding="utf-8")
    (root / "x.xml").write_text(TEI, encoding="utf-8")

    def pipeline(C):
        return [C.AudioFolder2Kaldi("wavs"), C.TextFolder2Kaldi("txt"),
                C.ColumnFile2Kaldi("meta.tsv", ["id", "speaker", "gender"], skip_header=True),
                C.Row2Info("split", r"utt(\d)"), C.Row2Duration(), C.ListFile2Kaldi("lines.txt", column="text"),
                C.TextRegexFilter(r"^deux$")]

    t = TC.Reader2Kaldi(str(root), pipeline(TC)).load()
    j = JC.Reader2Kaldi(str(root), pipeline(JC)).load()
    assert _rows(t) == _rows(j) and len(t) == 2
    t = TC.Reader2Kaldi(str(root), [TC.Tei2Kaldi()]).load(require=("text",))
    j = JC.Reader2Kaldi(str(root), [JC.Tei2Kaldi()]).load(require=("text",))
    assert _rows(t) == _rows(j) and len(t) >= 2
    seg = {"a": {"audio_id": "spk0-utt0"}, "b": {"audio_id": "spk2-utt2", "speaker": "B"}}
    for C, out in ((TC, {}), (JC, {})):
        rows = {k: dict(v) for k, v in seg.items()}
        C.AudioFolder2Kaldi("wavs", merge_on="audio_id").process(rows, str(root))
        C.ColumnFile2Kaldi("genders.tsv", ["speaker", "gender"], merge_on="speaker").process(rows, str(root))
        out.update(rows)
        if C is TC:
            t_rows = rows
    assert t_rows == rows
    # TextGrid2Kaldi on a two-tier TextGrid (formats.transcription.parse_textgrid_tiers, slice 8f)
    (root / "tg").mkdir()
    (root / "tg" / "rec1.TextGrid").write_text(TEXTGRID, encoding="utf-8")
    for tiers in ((0,), (1,), (0, 1, 5)):
        t = TC.Reader2Kaldi(str(root), [TC.TextGrid2Kaldi("tg", tiers=tiers)]).load(require=("text",))
        j = JC.Reader2Kaldi(str(root), [JC.TextGrid2Kaldi("tg", tiers=tiers)]).load(require=("text",))
        assert _rows(t) == _rows(j) and len(t) >= 2
    with pytest.raises(ValueError):
        TC.ListFile2Kaldi("lines.txt").process({"x": {}}, str(root))


# --- tarred shards -------------------------------------------------------------------------


def test_tarred_shards_match_jax(corpus):
    """Both packages shard the same manifest (pipes and FLAC among it): the
    same metadata, per-bucket manifests and tar members byte for byte; the
    iterators give the same batches, each row the int16 rounding of
    load_audio's array, with hosts taking every other shard."""
    from ssak_tpu.data.tarred import create_tarred_dataset as j_create, iterate_tarred_dataset as j_iter
    from ssak_tpu_torch.audio import array_to_bytes, bytes_to_array, load_audio
    from ssak_tpu_torch.data.tarred import create_tarred_dataset, iterate_tarred_dataset

    src = _plain_dir(corpus / "src", str(corpus / "audio"))
    JK.check_kaldi_dir(src)
    _, rows = TD.kaldi_folder_to_manifest(src)
    kw = dict(buckets=(1.0, 2.0, 4.0), shard_size=2)
    tm, jm = create_tarred_dataset(rows, str(corpus / "t_tar"), **kw), j_create(rows, str(corpus / "j_tar"), **kw)
    assert tm == jm
    for b in tm["buckets"]:
        td, jd = _files(str(corpus / "t_tar" / f"bucket_{b}")), _files(str(corpus / "j_tar" / f"bucket_{b}"))
        assert td.keys() == jd.keys()
        for name in td:
            if name.endswith(".tar"):
                with tarfile.open(corpus / "t_tar" / f"bucket_{b}" / name) as a, \
                        tarfile.open(corpus / "j_tar" / f"bucket_{b}" / name) as c:
                    assert [(m.name, a.extractfile(m).read()) for m in a] == [(m.name, c.extractfile(m).read()) for m in c]
            else:
                assert td[name] == jd[name]
    by_id = {r["id"]: r for r in rows}
    for kw in (dict(), dict(shard_shuffle_seed=3), dict(process_index=1, process_count=2)):
        got = list(iterate_tarred_dataset(str(corpus / "t_tar"), 2, **kw))
        ref = list(j_iter(str(corpus / "j_tar"), 2, **kw))
        assert len(got) == len(ref) > 0
        for (gx, gl, gr), (rx, rl, rr) in zip(got, ref):
            np.testing.assert_array_equal(gx, rx)
            np.testing.assert_array_equal(gl, rl)
            assert gr == rr
            for x, n, r in zip(gx, gl, gr):
                if r is not None:
                    a = load_audio(by_id[r["id"]]["audio"])
                    np.testing.assert_array_equal(x[:n], bytes_to_array(array_to_bytes(a)))


# --- the manifest cache --------------------------------------------------------------------


def test_manifest_cache_matches_jax(corpus, monkeypatch):
    """use_cache: the same key, file name and JSONL content as ssak_tpu's, in
    the port's own cache directory; a second call reads the file (not
    rewritten) and gives the same rows; touching a Kaldi file misses."""
    src = _plain_dir(corpus / "src", str(corpus / "audio"))
    JK.check_kaldi_dir(src)
    lst = corpus / "list.txt"
    lst.write_text(f"{src} 1.5\n{_segment_dir(corpus / 'seg')}\n", encoding="utf-8")
    for path, kw in ((src, dict(min_duration=0.6)), (str(lst), dict(max_data=5, seed=3)), ([src], dict(sort_by_len=-1))):
        t = TD.kaldi_folder_to_manifest(path, use_cache=True, **kw)
        j = JD.kaldi_folder_to_manifest(path, use_cache=True, **kw)
        assert t == j
        key = TD._manifest_cache_key(path, min_duration=kw.get("min_duration"), max_duration=None, max_text_length=None,
                                     max_data=kw.get("max_data"), choose_data_with_max_duration=False, shuffle=False,
                                     sort_by_len=kw.get("sort_by_len", 0), weights=1.0, seed=kw.get("seed", 69))
        tp = TD._manifest_cache_path(key)
        jp = JD._manifest_cache_path(key)
        assert tp.startswith(str(corpus / "torch_cache")) and jp.startswith(str(corpus / "jax_cache"))
        assert os.path.basename(tp) == os.path.basename(jp)
        assert open(tp, "rb").read() == open(jp, "rb").read()
        mtime = os.stat(tp).st_mtime_ns
        assert TD.kaldi_folder_to_manifest(path, use_cache=True, **kw) == t
        assert os.stat(tp).st_mtime_ns == mtime
    n = len(os.listdir(corpus / "torch_cache" / "manifests"))
    os.utime(os.path.join(src, "text"), ns=(1, 1))
    TD.kaldi_folder_to_manifest(src, use_cache=True, min_duration=0.6)
    assert len(os.listdir(corpus / "torch_cache" / "manifests")) == n + 1


def test_cache_dirs_of_the_two_packages_differ(tmp_path, monkeypatch):
    from ssak_tpu.utils.misc import get_cache_dir as j_cache
    from ssak_tpu_torch.utils.misc import get_cache_dir, walk_files

    for var in ("SSAK_TPU_CACHE", "SSAK_TPU_TORCH_CACHE", "XDG_CACHE_HOME"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert get_cache_dir() == str(tmp_path / ".cache" / "ssak_tpu_torch") != j_cache()
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert get_cache_dir() == str(tmp_path / "xdg" / "ssak_tpu_torch") != j_cache()
    monkeypatch.setenv("SSAK_TPU_CACHE", str(tmp_path / "shared"))
    assert get_cache_dir() != j_cache() == str(tmp_path / "shared")
    from ssak_tpu.utils.misc import walk_files as j_walk

    assert list(walk_files(str(tmp_path), ignore_extensions=(".x",))) == list(j_walk(str(tmp_path), ignore_extensions=(".x",)))


# --- the train CLI: --config, --set, --use_manifest_cache ----------------------------------

CONFIG = """# a sak-train config
batch_size: 4
learning_rate: 3.0e-3
warmup_steps: 1
max_steps: 6
eval_steps: 2
max_duration: 21
use_manifest_cache: true
seed: ${base.seed}
base:
  seed: 5
"""


def _cli_args(mod, argv):
    """The arguments ssak_tpu's sak-train main settles on: its parser, its
    config merge (ssak_tpu/train/cli.py:69-78), run before any JAX work."""
    parser = mod.build_parser()
    args = parser.parse_args(argv)
    from ssak_tpu.utils.config import flatten_config, load_config

    tree = load_config(args.config, overrides=args.overrides)
    defaults = {k: parser.get_default(k) for k in vars(args)}
    for key, val in flatten_config(tree).items():
        name = key.replace(".", "_")
        if hasattr(args, name) and getattr(args, name) == defaults.get(name):
            setattr(args, name, val)
    return vars(args)


def test_train_cli_merges_config_and_overrides_as_jax(tmp_path):
    from ssak_tpu.train import cli as jcli
    from ssak_tpu_torch.train import cli

    cfg = tmp_path / "c.yaml"
    cfg.write_text(CONFIG)
    argv = ["tr", "va", "--config", str(cfg), "--set", "max_steps=2", "--set", "base.seed=7", "--set",
            "optimizer=adadelta", "--batch_size", "3", "--set", "learning_rate=1e-4"]
    got = vars(cli.parse_args(argv + ["--device", "cpu"]))
    ref = _cli_args(jcli, argv)
    assert {k: v for k, v in got.items() if k != "device"} == ref
    assert got["batch_size"] == 3 and got["max_steps"] == 2 and got["seed"] == 7 and got["use_manifest_cache"] is True
    assert got["learning_rate"] == "1e-4"  # PyYAML reads 1e-4 (no dot) as a string, and so does the port
    assert cli.args_to_run_name(cli.parse_args(argv)) == cli.args_to_run_name(cli.parse_args(argv))


def test_train_cli_with_config_set_and_manifest_cache_on_cpu(tmp_path, monkeypatch, capsys):
    """python -m ssak_tpu_torch.train.cli TRAIN VALID --config c.yaml --set ...
    --use_manifest_cache --device cpu: 2 steps and evaluations on a dir of
    FLAC, MP3-free WAV and pipe rows; the manifests are cached, and the same
    command run again resumes at step 2 and reads them back from the cache
    (the same files, not rewritten, the same rows)."""
    from ssak_tpu_torch.train import cli

    monkeypatch.setenv("SSAK_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("SCR_D", str(tmp_path / "audio"))
    (tmp_path / "audio").mkdir()
    rng = np.random.RandomState(1)
    scp, text = [], []
    for i in range(6):
        n = 8000 + 1600 * i
        t = np.arange(n) / 16000
        save_audio(str(tmp_path / "audio" / f"w{i}.wav"), (0.2 * np.sin(2 * np.pi * (200 + 40 * i) * t)
                                                           + 0.02 * rng.randn(n)).astype(np.float32), 16000)
        scp.append(f"u{i} sox $SCR_D/w{i}.wav -t wav -r 16k -c 1 - |" if i % 2 else f"u{i} {tmp_path / 'audio'}/w{i}.wav")
        text.append(f"u{i} {TEXTS[i]}")
    shutil.copy(os.path.join(DATA, "mono_16k_24bit.flac"), tmp_path / "audio" / "f.flac")
    scp.append(f"u6 {tmp_path / 'audio' / 'f.flac'}")
    text.append(f"u6 {TEXTS[0]}")
    d = _write(tmp_path / "data", {"wav.scp": scp, "text": text})
    cfg = tmp_path / "c.yaml"
    cfg.write_text(CONFIG)
    argv = [d, d, "--config", str(cfg), "--set", "max_steps=2", "--output_dir", str(tmp_path / "runs"), "--device", "cpu"]
    cli.main(argv)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cache = tmp_path / "cache" / "manifests"
    files = sorted(os.listdir(cache))
    assert len(files) == 2  # the train manifest (min_duration 0.1) and the valid one
    stamp = {f: os.stat(cache / f).st_mtime_ns for f in files}
    rows = sorted((TD.load_manifest(str(cache / f)) for f in files), key=len)
    with open(os.path.join(out["run_dir"], "trainer_state.json")) as f:
        assert json.load(f)["global_step"] == 2
    cli.main(argv)
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again["run_dir"] == out["run_dir"]
    assert sorted(os.listdir(cache)) == files and {f: os.stat(cache / f).st_mtime_ns for f in files} == stamp
    want = [TD.kaldi_folder_to_manifest(d, **kw)[1] for kw in (dict(max_duration=21, min_duration=0.1, seed=5),
                                                                 dict(max_duration=21, seed=5))]
    assert sorted(want, key=len) == rows and len(rows[0]) == 7


# --- the ingest CLIs -----------------------------------------------------------------------


def test_kaldi2manifest_cli_matches_jax(corpus, capsys):
    from ssak_tpu_torch.tools import kaldi2manifest as T

    J = _tool("kaldi2manifest")
    src = _plain_dir(corpus / "src", str(corpus / "audio"))
    JK.check_kaldi_dir(src)
    root = corpus / "names"
    for name, sub in (("cv", "nocasepunc"), ("eval_set", None), ("multi", "nocasepunc")):
        base = root / name / (sub or "")
        if name == "multi":
            for s in ("x_train", "x_dev", "x_test"):
                _write(base / s, {"wav.scp": ["a b"]})
        else:
            _write(base, {"wav.scp": ["a b"]})
    (corpus / "names.txt").write_text("cv\neval_set\nmulti\n")
    outs = {}
    for tag, mod in (("t", T), ("j", J)):
        o = corpus / f"out_{tag}"
        o.mkdir()
        mod.main(["manifest", src, str(o / "m.jsonl"), "--language", "fr"])
        mod.main(["manifest", src, str(o / "raw.jsonl")])
        mod.main(["merge", str(o / "all.jsonl"), str(o / "m.jsonl"), str(o / "raw.jsonl")])
        mod.main(["split", str(o / "all.jsonl"), str(o / "split"), "--ratios", "0.5", "0.25", "0.25", "--seed", "1"])
        mod.main(["clean", str(o / "raw.jsonl"), str(o / "clean.jsonl")])
        mod.main(["tar", src, str(o / "tar"), "--shard_size", "3"])
        mod.main(["tokenizer", str(o / "bpe"), "--manifest", f"{o / 'm.jsonl'},{o / 'raw.jsonl'}", "--vocab_size", "40"])
        mod.main(["tokenizer", str(o / "char"), "--manifest", str(o / "m.jsonl"), "--type", "char"])
        for mode in ("train", "dev", "test"):
            mod.main(["listfiles", str(corpus / "names.txt"), str(root), str(o / f"list_{mode}.txt"), "--mode", mode,
                      "--subset", "nocasepunc"])
        outs[tag] = capsys.readouterr().out
    assert outs["t"].replace("out_t", "out_j") == outs["j"]
    t, j = corpus / "out_t", corpus / "out_j"
    for dirpath, _dirs, files in os.walk(j):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), j)
            a, b = (t / rel).read_bytes(), (j / rel).read_bytes()
            if f == "tokenizer.json":
                assert json.loads(a) == json.loads(b), rel
            elif f.endswith(".tar"):
                with tarfile.open(t / rel) as x, tarfile.open(j / rel) as y:
                    assert [(m.name, x.extractfile(m).read()) for m in x] == [(m.name, y.extractfile(m).read()) for m in y]
            else:
                assert a.replace(b"out_t", b"out_j") == b, rel


def test_kaldi_tools_cli_matches_jax(corpus, capsys):
    from ssak_tpu_torch.tools import kaldi_tools as T

    J = _tool("kaldi_tools")
    outs = {}
    for tag, mod in (("t", T), ("j", J)):
        base = corpus / tag
        src = _plain_dir(base / "src", str(corpus / "audio"))
        seg = _segment_dir(base / "seg")
        mod.main(["fix", src, "--language", "fr"])
        mod.main(["fix", seg])
        mod.main(["stats", src, seg])
        mod.main(["split", src, str(base / "sp"), "--seed", "2", "--ratios", "0.4", "0.4", "0.2"])
        mod.main(["split", seg, str(base / "spu"), "--by_utterance", "--ratios", "0.5", "0.25", "0.25"])
        for m in ("head", "random", "spread"):
            mod.main(["subsample", src, str(base / f"sub_{m}"), "--n", "3", "--mode", m])
        mod.main(["glue", seg, str(base / "glued"), "--mode", "all", "--max_silence", "0.5"])
        mod.main(["rename", seg, str(base / "renamed"), "--char", "a", "--replacement", "A"])
        mod.main(["duration", str(corpus / "audio"), "--verbose"])
        mod.main(["duration", "sox $SCR_D/s8.wav -t wav -r 16k -b 16 -c 1 - |"])
        moved = base / "ds"
        _write(moved / "kaldi", {"wav.scp": [f"u1 {moved}/a.wav"]})
        mod.main(["move", str(moved), str(base / "ds2")])
        outs[tag] = capsys.readouterr().out.replace(str(corpus / tag), "BASE")
    assert outs["t"] == outs["j"]
    t, j = corpus / "t", corpus / "j"
    for dirpath, _dirs, files in os.walk(j):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), j)
            assert (t / rel).read_bytes().replace(bytes(t), b"BASE") == (j / rel).read_bytes().replace(bytes(j), b"BASE"), rel
    # spk2gender (utils.gender's pitch heuristic): the same votes and file; an existing file is kept without --force
    for tag, mod, extra in (("t", T, ["--device", "cpu"]), ("j", J, [])):
        src = str(corpus / tag / "src")
        mod.main(["spk2gender", src] + extra)
        mod.main(["spk2gender", src, "--force"] + extra)
        outs[tag] = capsys.readouterr().out.replace(str(corpus / tag), "BASE")
    assert outs["t"] == outs["j"] and "already exists" in outs["t"] and '"speakers": 3' in outs["t"]
    assert (t / "src" / "spk2gender").read_bytes() == (j / "src" / "spk2gender").read_bytes()


def test_ingest_clis_run_as_modules(corpus):
    """python -m ssak_tpu_torch.tools.kaldi2manifest / .kaldi_tools run on a
    host without a card, importing neither JAX nor ssak_tpu."""
    src = _plain_dir(corpus / "src", str(corpus / "audio"))
    guard = ("import sys, runpy; sys.modules['jax'] = None; sys.modules['ssak_tpu'] = None; "
             "sys.argv = sys.argv[1:]; runpy.run_module(sys.argv[0], run_name='__main__')")
    env = {**os.environ, "SCR_D": str(corpus / "audio")}
    for argv in (["ssak_tpu_torch.tools.kaldi_tools", "fix", src],
                 ["ssak_tpu_torch.tools.kaldi2manifest", "manifest", src, str(corpus / "m.jsonl")]):
        out = subprocess.run([sys.executable, "-c", guard, *argv], cwd=REPO, capture_output=True, text=True, timeout=300,
                             env=env)
        assert out.returncode == 0, out.stderr[-2000:]
    assert len(open(corpus / "m.jsonl").read().splitlines()) == 5  # the fix kept 5 of 7 utterances
