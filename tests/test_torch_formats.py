"""The port's transcription, diarization, Transcriber and LeVoiceLab formats
(ssak_tpu_torch.formats) and TextGrid2Kaldi against ssak_tpu's on the CPU.

All host Python: every reader and writer gives ssak_tpu's output exactly,
on fixtures written here (JSON in both layouts, text, CSV, a two-tier
TextGrid, SRT, WebVTT, RTTM, a latin-1 Transcriber file, a Kaldi dir with
audio exported to a LeVoiceLab database and back, and an augmented copy
of it, whose waveforms are ssak_tpu's bit for bit)."""

import json
import os

import numpy as np
import pytest

import ssak_tpu.formats as JF
import ssak_tpu_torch.formats as TF
from ssak_tpu.formats import diarization as JD
from ssak_tpu.formats import transcriber as JT
from ssak_tpu.formats import transcription as JX
from ssak_tpu_torch.audio import load_audio, save_audio
from ssak_tpu_torch.formats import diarization as TD
from ssak_tpu_torch.formats import transcriber as TT
from ssak_tpu_torch.formats import transcription as TX

CANONICAL = {
    "transcription_result": "bonjour à tous merci",
    "raw_transcription": "Bonjour à tous. Merci !",
    "confidence": 0.9,
    "segments": [
        {"spk_id": "A", "start": 0.0, "end": 1.5, "raw_segment": "Bonjour à tous.", "segment": "bonjour à tous",
         "words": [{"word": "bonjour", "start": 0.0, "end": 0.6, "conf": 0.9},
                   {"word": "à", "start": 0.6, "end": 0.8}, {"word": "tous", "start": 0.8, "end": 1.5, "conf": 0.7}]},
        {"spk_id": "B", "start": 2.0, "end": 2.8, "raw_segment": "Merci !", "segment": "merci",
         "words": [{"word": "merci", "start": 2.0, "end": 2.8, "conf": 1.0}]},
    ],
}
WHISPER = {"text": " Bonjour. Thank you for watching.", "segments": [
    {"start": 0.0, "end": 1.2, "text": " Bonjour à tous.",
     "words": [{"word": " Bonjour", "start": 0.0, "end": 0.5, "probability": 0.8},
               {"text": "à", "start": 0.5, "end": 0.7}, {"word": " tous.", "start": 0.7, "end": 1.2, "conf": 0.6}]},
    {"start": 1.2, "end": 3.0, "text": "Thank you for watching."}]}
CSV = "Text,Start,End,Speaker\n\"bonjour, à tous\",0.0,1.5,A\nmerci,2,2.8,B\n,3,3.5,\n"
SRT = """1
00:00:00,000 --> 00:00:01,500
<i>Bonjour</i>   à tous

2
00:00:02,000 --> 00:00:02,800
Merci
bien

3
pas de temps ici
"""
VTT = "WEBVTT\n\n00:00:01.250 --> 00:00:02.500\nsalut\n\n01:00:00.000 --> 01:00:01.000\n♪ la la ♪\n"
TEXTGRID = """File type = "ooTextFile"
Object class = "TextGrid"

xmin = 0
xmax = 3.5
tiers? <exists>
size = 2
item []:
    item [1]:
        class = "IntervalTier"
        name = "words"
        xmin = 0
        xmax = 3.5
        intervals: size = 3
        intervals [1]:
            xmin = 0
            xmax = 1.25
            text = "bonjour à tous"
        intervals [2]:
            xmin = 1.25
            xmax = 2.0
            text = ""
        intervals [3]:
            xmin = 2.0
            xmax = 3.5
            text = "merci"
    item [2]:
        class = "IntervalTier"
        name = "speaker"
        xmin = 0
        xmax = 3.5
        intervals: size = 1
        intervals [1]:
            xmin = 0
            xmax = 3.5
            text = "L1"
"""
RTTM = """SPEAKER f 1 0.50 2.00 <NA> <NA> spk2 <NA> <NA>
SPEAKER f 1 0.00 1.00 <NA> <NA> spk1 <NA> <NA>
;; a comment
SPEAKER f 1 2.20 0.30 <NA> <NA> spk1 <NA> <NA>
SPEAKER f 1 2.25 0.10 <NA> <NA> spk3 <NA> <NA>
"""
TRS = """<?xml version="1.0" encoding="ISO-8859-1"?>
<!DOCTYPE Trans SYSTEM "trans-14.dtd">
<Trans audio_filename="x" version="1">
<Speakers>
<Speaker id="spk1" name="Marie Dupont" type="female"/>
<Speaker id="spk2" name="Paul" dialect="M"/>
</Speakers>
<Episode><Section type="report" startTime="0" endTime="6">
<Turn speaker="spk1" startTime="0" endTime="3">
<Sync time="0"/>
bonjour <Event desc="rire" type="noise"/> à tous
<Sync time="1.5"/>
ça va très bien
</Turn>
<Turn speaker="spk1 spk2" startTime="3" endTime="4.5">
<Sync time="3"/>
<Who nb="1"/> oui <Who nb="2"/> non
</Turn>
<Turn speaker="spk2" startTime="4.5" endTime="6">
<Sync time="4.5"/>
</Turn>
</Section></Episode>
</Trans>
"""


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("formats")
    files = {"c.json": json.dumps(CANONICAL, ensure_ascii=False), "w.json": json.dumps(WHISPER),
             "t.txt": "  Un texte simple.  \n", "s.csv": CSV, "g.TextGrid": TEXTGRID, "s.srt": SRT, "v.vtt": VTT,
             "x.unknown": "autre chose"}
    for name, content in files.items():
        (d / name).write_text(content, encoding="utf-8")
    (d / "r.rttm").write_text(RTTM, encoding="utf-8")
    (d / "t.trs").write_bytes(TRS.encode("latin-1"))
    return d


@pytest.mark.parametrize("name", ["c.json", "w.json", "t.txt", "s.csv", "g.TextGrid", "s.srt", "v.vtt", "x.unknown"])
@pytest.mark.parametrize("remove", [False, True])
def test_to_transcription_from_files_matches_jax(fixtures, name, remove):
    path = str(fixtures / name)
    want = JX.to_transcription(path, remove_hallucination=remove)
    assert TX.to_transcription(path, remove_hallucination=remove) == want
    if not name.endswith(".json"):
        for fmt in ("text", "csv", "srt", "vtt", "textgrid"):
            content = (fixtures / name).read_text(encoding="utf-8")
            assert TX.to_transcription(content, format=fmt) == JX.to_transcription(content, format=fmt)


def test_to_transcription_from_objects_matches_jax():
    for data in (CANONICAL, WHISPER, {"text": "juste ça"}, "du texte"):
        for remove in (False, True):
            assert TX.to_transcription(data, remove_hallucination=remove) == JX.to_transcription(data, remove_hallucination=remove)
    with pytest.raises(ValueError):
        TX.to_transcription({"nothing": 1})


@pytest.mark.parametrize("fmt", ["text", "txt", "srt", "vtt", "csv", "textgrid"])
def test_transcription_to_matches_jax(fmt):
    for tr in (JX.to_transcription(CANONICAL), JX.to_transcription(WHISPER), {"text": "seul"},
               {"segments": [{"stime": 3661.5, "etime": 3662.25, "text": 'a "b"', "speaker": "S"}]}):
        assert TX.transcription_to(tr, fmt) == JX.transcription_to(tr, fmt)
    with pytest.raises(ValueError):
        TX.transcription_to(CANONICAL, "docx")


def test_textgrid_tiers_hallucinations_and_shortening_match_jax():
    assert TX.parse_textgrid_tiers(TEXTGRID) == JX.parse_textgrid_tiers(TEXTGRID)
    flat = 'intervals [1]:\n xmin = 0.5\n xmax = 1\n text = "seul"\n'
    assert TX.parse_textgrid_tiers(flat) == JX.parse_textgrid_tiers(flat)
    for text in ("Merci d'avoir regardé cette vidéo ♪ et au revoir", "THANK YOU FOR WATCHING", "rien"):
        assert TX.remove_hallucinations(text) == JX.remove_hallucinations(text)
    long = JX.to_transcription("mot " * 200)
    for n in (10, 5000):
        assert TX.shorten_transcription(long, n) == JX.shorten_transcription(long, n)


def test_set_diarization_matches_jax():
    turns = {"segments": [{"spk_id": "A", "seg_begin": 0.0, "seg_end": 0.7},
                          {"spk_id": "B", "seg_begin": 0.7, "seg_end": 3.0}]}
    for data in (CANONICAL, {"segments": [{"start": 0.0, "end": 1.0, "text": "sans mots"}]}):
        got = TX._from_json(data).set_diarization(turns).to_dict()
        want = JX._from_json(data).set_diarization(turns).to_dict()
        assert got == want
    got = TX._from_json(CANONICAL).set_diarization(turns["segments"]).to_dict()
    assert got == JX._from_json(CANONICAL).set_diarization(turns["segments"]).to_dict()


def test_diarization_matches_jax(fixtures, tmp_path):
    path = str(fixtures / "r.rttm")
    segs = TD.import_rttm(path)
    assert segs == JD.import_rttm(path) == TD.import_rttm(RTTM.splitlines())
    for remove in (True, False):
        d = TD.to_diarization(segs, remove_overlaps=remove)
        assert d == JD.to_diarization(segs, remove_overlaps=remove)
    d = TD.to_diarization(segs)
    assert TD.json2rttm(d, str(tmp_path / "t.rttm"), "f") == JD.json2rttm(d, str(tmp_path / "j.rttm"), "f")
    assert (tmp_path / "t.rttm").read_text() == (tmp_path / "j.rttm").read_text()
    plain = [{"start": 0.0, "end": 1.0, "speaker": "x"}, {"start": 1.0, "end": 2.0}]
    assert TD.json2rttm(plain) == JD.json2rttm(plain)


@pytest.mark.parametrize("kw", [{}, {"anonymize_speakers": True}, {"include_events": False}])
def test_read_transcriber_matches_jax(fixtures, kw):
    got = TT.read_transcriber(str(fixtures / "t.trs"), **kw)
    assert got == JT.read_transcriber(str(fixtures / "t.trs"), **kw) and len(got) >= 4


def test_textgrid2kaldi_matches_jax(fixtures, tmp_path):
    from ssak_tpu.data import kaldi_converter as JC
    from ssak_tpu_torch.data import kaldi_converter as TC

    (tmp_path / "tg" / "deep").mkdir(parents=True)
    (tmp_path / "tg" / "deep" / "rec.TextGrid").write_text(TEXTGRID, encoding="utf-8")
    for tiers in ((0,), (0, 1)):
        t = TC.Reader2Kaldi(str(tmp_path), [TC.TextGrid2Kaldi("tg", tiers=tiers)]).load(require=("text",))
        j = JC.Reader2Kaldi(str(tmp_path), [JC.TextGrid2Kaldi("tg", tiers=tiers)]).load(require=("text",))
        key = lambda ds: sorted((r.id, r.audio_id, r.start, r.end, r.text) for r in ds)  # noqa: E731
        assert key(t) == key(j) and len(t) == 2  # a later tier's interval n replaces the row <stem>_n


# --- LeVoiceLab ------------------------------------------------------------------------------

def _kaldi_db(root):
    """Two recordings (one at 8 kHz), four utterances of two speakers with
    genders, two of them overlapping."""
    rng = np.random.RandomState(0)
    os.makedirs(root, exist_ok=True)
    for name, sr, secs in (("Rec One", 16000, 3.0), ("rec-two", 8000, 2.0)):
        t = np.arange(int(sr * secs)) / sr
        save_audio(os.path.join(root, f"{name}.wav"), (0.2 * np.sin(2 * np.pi * 300 * t) + 0.01 * rng.randn(t.size))
                   .astype(np.float32), sr)
    files = {"wav.scp": [f"r1 {root}/Rec One.wav", f"r2 {root}/rec-two.wav"],
             "segments": ["u1 r1 0.00 1.20", "u2 r1 1.00 2.50", "u3 r1 1.10 1.90", "u4 r2 0.20 1.80"],
             "text": ["u1 Bonjour à tous", "u2 ça va", "u3 oui", "u4 très bien merci"],
             "utt2spk": ["u1 Élise", "u2 Paul", "u3 Paul", "u4 Élise"],
             "spk2gender": ["Élise f", "Paul m"]}
    with open(os.path.join(root, "wav.scp"), "w", encoding="utf-8") as f:  # a path with a space
        f.write("\n".join(files.pop("wav.scp")).replace(f"{root}/Rec One.wav", f"cat '{root}/Rec One.wav' |") + "\n")
    for name, lines in files.items():
        with open(os.path.join(root, name), "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    return str(root)


def _tree(d):
    out = {}
    for root, _dirs, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            rel = os.path.relpath(p, d)
            if f.endswith(".wav"):
                out[rel] = load_audio(p, sample_rate=None).tobytes()
            else:
                with open(p, encoding="utf-8") as fh:
                    out[rel] = fh.read().replace(d, "DIR")
    return out


def test_voicelab_export_import_and_augment_match_jax(tmp_path):
    kaldi = _kaldi_db(str(tmp_path / "kaldi"))
    kw = dict(name="Mon Corpus", description="test", date_created="2024-01-01", languages=("fr",))
    TF.kaldi_to_voicelab(kaldi, str(tmp_path / "t_db"), **kw)
    JF.kaldi_to_voicelab(kaldi, str(tmp_path / "j_db"), **kw)
    t_db, j_db = _tree(str(tmp_path / "t_db")), _tree(str(tmp_path / "j_db"))
    assert t_db == j_db and len(t_db) >= 7
    TF.kaldi_to_voicelab(kaldi, str(tmp_path / "t_db2"), ignore_speakers=True, **kw)
    JF.kaldi_to_voicelab(kaldi, str(tmp_path / "j_db2"), ignore_speakers=True, **kw)
    assert _tree(str(tmp_path / "t_db2")) == _tree(str(tmp_path / "j_db2"))

    db = str(tmp_path / "j_db")
    for kw in ({}, {"normalize": True, "name_genders": {"paul": "m"}}):
        TF.voicelab_to_kaldi(db, str(tmp_path / "t_k"), **kw)
        JF.voicelab_to_kaldi(db, str(tmp_path / "j_k"), **kw)
        assert _tree(str(tmp_path / "t_k")) == _tree(str(tmp_path / "j_k"))
    with pytest.raises(FileNotFoundError):
        TF.voicelab_to_kaldi(str(tmp_path / "kaldi"), str(tmp_path / "none"))

    TF.augment_database(db, str(tmp_path / "t_aug"), seed=3)
    JF.augment_database(db, str(tmp_path / "j_aug"), seed=3)
    t_aug, j_aug = _tree(str(tmp_path / "t_aug")), _tree(str(tmp_path / "j_aug"))
    assert t_aug == j_aug and t_aug != t_db
    assert json.loads(t_aug["meta.json"])["contains_augmented_speech"] is True
