"""The HTTP half of the port's remote client against ssak_tpu's, with a
local http.server standing in for a LinTO-style transcription service
(POST /transcribe, GET /job/<id>, GET /results/<id>, as the stub_server
fixture of tests/test_formats.py), and no network.

Exact (the same urllib code): build_transcription_config, the multipart
body under one boundary, the requests each package sends (method, path,
content type, body), the answers of http_get / http_post, and
remote_transcribe's results, raw and converted by formats.to_transcription,
its polling, and its failures (a failed job, a job not done in time)."""

import json
import threading
import uuid
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

import ssak_tpu.remote as JR
import ssak_tpu.remote.client as JC
import ssak_tpu_torch.remote as TR
import ssak_tpu_torch.remote.client as TC
from ssak_tpu_torch.audio import save_audio

RESULTS = {
    "canonical": {"transcription_result": "bonjour à tous", "raw_transcription": "bonjour à tous", "confidence": 0.9,
                  "segments": []},
    "segments": {"text": " bonjour tout le monde", "segments": [
        {"start": 0.0, "end": 1.5, "text": " bonjour tout", "words": [
            {"word": "bonjour", "start": 0.0, "end": 0.7, "probability": 0.9},
            {"word": "tout", "start": 0.8, "end": 1.5, "probability": 0.8}]},
        {"start": 1.6, "end": 2.4, "text": " le monde"}]},
}


@pytest.fixture()
def linto_server():
    """A job is 'started' for its first `polls` GETs, then done (or
    'failed' for the job id 'jobfail'). Every request is recorded."""
    seen = []
    state = {"polls": 0, "need": 2, "result": "canonical", "job": "job42"}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            seen.append(("POST", self.path, self.headers.get("Content-Type"), body))
            if self.path == "/echo":
                self._json({"echo": json.loads(body)})
            else:
                self._json({"jobid": state["job"]})

        def do_GET(self):
            seen.append(("GET", self.path, self.headers.get("X-Token"), b""))
            if self.path.startswith("/job/"):
                state["polls"] += 1
                if self.path.endswith("jobfail"):
                    self._json({"state": "failed", "reason": "no audio"})
                elif state["polls"] < state["need"]:
                    self._json({"state": "started"})
                else:
                    self._json({"state": "done", "result_id": "res7"})
            elif self.path.startswith("/results/"):
                self._json(RESULTS[state["result"]])
            else:
                self.send_error(404)

        def _json(self, obj):
            data = json.dumps(obj).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    srv = HTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_port}", seen, state
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


@pytest.fixture()
def fixed_boundary(monkeypatch):
    """One multipart boundary for both packages' uuid4 calls."""
    fixed = uuid.UUID("12345678123456781234567812345678")
    for mod in (TC, JC):
        monkeypatch.setattr(mod.uuid, "uuid4", lambda: fixed)


def _wav(tmp_path):
    path = tmp_path / "a.wav"
    save_audio(str(path), (0.1 * np.random.RandomState(0).randn(8000)).astype(np.float32), 16000)
    return str(path)


def test_exports_and_config_match_jax():
    assert TR.__all__ == JR.__all__
    for kw in ({}, dict(language="en", diarization=True, n_speakers=3, punctuation=True, vad=False),
               dict(diarization=True)):
        assert TC.build_transcription_config(**kw) == JC.build_transcription_config(**kw)


def test_multipart_matches_jax(fixed_boundary):
    fields = {"transcriptionConfig": json.dumps({"a": 1}), "n": 3}
    files = {"file": ("x.wav", b"\x00\x01RIFF", "audio/wav"), "extra": ("é.txt", "é".encode(), "text/plain")}
    assert TC._multipart(fields, files) == JC._multipart(fields, files)
    assert TC._multipart({}, {}) == JC._multipart({}, {})


def test_http_helpers_match_jax(linto_server, fixed_boundary):
    url, seen, _state = linto_server
    outs = []
    for mod in (TC, JC):
        seen.clear()
        got = [mod.http_post(url + "/echo", json_body={"k": [1, "é"]}),
               mod.http_post(url + "/transcribe", fields={"f": "v"}, files={"file": ("a.wav", b"abc", "audio/wav")},
                             headers={"X-Extra": "1"}),
               mod.http_get(url + "/results/r1", headers={"X-Token": "t"})]
        outs.append((got, list(seen)))
    assert outs[0] == outs[1]
    assert outs[0][0][0] == (200, json.dumps({"echo": {"k": [1, "é"]}}).encode())


@pytest.mark.parametrize("result", sorted(RESULTS))
def test_remote_transcribe_matches_jax(linto_server, fixed_boundary, tmp_path, result):
    url, seen, state = linto_server
    state["result"] = result
    audio = _wav(tmp_path)
    cfg = TC.build_transcription_config(language="en", diarization=True)
    outs = []
    for mod in (TC, JC):
        seen.clear()
        state["polls"] = 0
        got = [mod.remote_transcribe(url + "/", audio, ping_interval=0.01),
               mod.remote_transcribe(url, audio, transcription_config=cfg, ping_interval=0.01, return_raw=True)]
        outs.append((got, list(seen)))
    assert outs[0] == outs[1]
    (converted, raw), requests = outs[0]
    assert raw == RESULTS[result] and converted["transcription_result"].strip()
    assert [r[:2] for r in requests[:4]] == [("POST", "/transcribe"), ("GET", "/job/job42"), ("GET", "/job/job42"),
                                             ("GET", "/results/res7?convert_numbers=no")]
    assert b'filename="a.wav"' in requests[0][3] and b'"language": "en"' in requests[4][3]


def test_remote_transcribe_failures_match_jax(linto_server, tmp_path):
    url, _seen, state = linto_server
    audio = _wav(tmp_path)
    for mod in (TC, JC):
        state.update(job="jobfail", polls=0)
        with pytest.raises(RuntimeError, match="remote job failed"):
            mod.remote_transcribe(url, audio, ping_interval=0.01)
        state.update(job="job42", polls=0, need=10**6)
        with pytest.raises(TimeoutError, match="job42"):
            mod.remote_transcribe(url, audio, timeout=0.05, ping_interval=0.01)
