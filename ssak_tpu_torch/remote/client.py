"""Remote transcription client (counterpart of ssak_tpu.remote.client).

HTTP half, on urllib as in ssak_tpu: a LinTO-style transcription service
takes a multipart upload (POST /transcribe), is polled (GET /job/<id>) and
gives the result (GET /results/<id>), which `remote_transcribe` turns into
a TranscriptionResult (formats.to_transcription).

Streaming half: int16 PCM to a LinTO / Vosk streaming server
(infer.streaming, or ssak_tpu's) over the port's own WebSocket code
(infer.websocket): a JSON config, binary chunks, {"eof": 1}; the server's
{"partial": ...} and {"text": ...} messages go to the callbacks.
"""

import asyncio
import io
import json
import time
import urllib.request
import uuid

import numpy as np


def _multipart(fields: dict, files: dict):
    """Build a multipart/form-data body. files: name -> (filename, bytes,
    content_type)."""
    boundary = uuid.uuid4().hex
    body = io.BytesIO()
    for name, value in fields.items():
        body.write(f"--{boundary}\r\nContent-Disposition: form-data; name=\"{name}\"\r\n\r\n".encode())
        body.write(str(value).encode() + b"\r\n")
    for name, (fn, data, ctype) in files.items():
        body.write(
            f"--{boundary}\r\nContent-Disposition: form-data; name=\"{name}\"; filename=\"{fn}\"\r\n"
            f"Content-Type: {ctype}\r\n\r\n".encode()
        )
        body.write(data + b"\r\n")
    body.write(f"--{boundary}--\r\n".encode())
    return body.getvalue(), f"multipart/form-data; boundary={boundary}"


def http_post(url, fields=None, files=None, json_body=None, headers=None, timeout=300):
    headers = dict(headers or {})
    if json_body is not None:
        data = json.dumps(json_body).encode()
        headers["Content-Type"] = "application/json"
    else:
        data, ctype = _multipart(fields or {}, files or {})
        headers["Content-Type"] = ctype
    req = urllib.request.Request(url, data=data, headers=headers, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read()


def http_get(url, headers=None, timeout=300):
    req = urllib.request.Request(url, headers=dict(headers or {}), method="GET")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read()


def build_transcription_config(
    language: str = "fr",
    diarization: bool = False,
    n_speakers: int = None,
    punctuation: bool = False,
    vad: bool = True,
):
    """Request config matching the reference's transcriptionConfig
    (linstt.py:107-130)."""
    return {
        "language": language,
        "punctuationConfig": {"enablePunctuation": punctuation, "serviceName": None},
        "diarizationConfig": {
            "enableDiarization": diarization,
            "numberOfSpeaker": n_speakers,
            "maxNumberOfSpeaker": 50 if n_speakers is None else n_speakers,
            "serviceName": None,
        },
        "vadConfig": {"enableVad": vad, "methodName": "WebRTC", "minDuration": 0.0},
        "enableNormalization": False,
    }


def remote_transcribe(
    server_url: str,
    audio_path: str,
    transcription_config: dict = None,
    timeout: float = 3600,
    ping_interval: float = 2.0,
    return_raw: bool = False,
    verbose: bool = False,
):
    """Upload audio, poll the job, fetch the final result (reference
    linstt_transcribe:22 flow: POST /transcribe -> GET /job/<id> ->
    GET /results/<result_id>)."""
    with open(audio_path, "rb") as f:
        audio = f.read()
    cfg = transcription_config or build_transcription_config()
    status, body = http_post(
        server_url.rstrip("/") + "/transcribe",
        fields={"transcriptionConfig": json.dumps(cfg)},
        files={"file": (audio_path.split("/")[-1], audio, "audio/wav")},
    )
    if status not in (200, 201):
        raise RuntimeError(f"transcribe request failed: {status} {body[:200]}")
    jobid = json.loads(body)["jobid"]

    t0 = time.time()
    result_id = None
    while time.time() - t0 < timeout:
        status, body = http_get(server_url.rstrip("/") + f"/job/{jobid}")
        state = json.loads(body)
        if state.get("state") == "done":
            result_id = state["result_id"]
            break
        if state.get("state") == "failed":
            raise RuntimeError(f"remote job failed: {state}")
        time.sleep(ping_interval)
    if result_id is None:
        raise TimeoutError(f"job {jobid} not finished after {timeout}s")
    status, body = http_get(server_url.rstrip("/") + f"/results/{result_id}?convert_numbers=no")
    result = json.loads(body)
    if return_raw:
        return result
    from ssak_tpu_torch.formats import to_transcription

    return to_transcription(result)


def array_to_bytes(audio) -> bytes:
    """f32 samples in [-1, 1] -> int16 little-endian PCM bytes (ssak_tpu's
    audio.array_to_bytes)."""
    return np.clip(np.round(np.asarray(audio, np.float32) * 32768.0), -32768, 32767).astype("<i2").tobytes()


async def remote_streaming(ws_url: str, audio, sample_rate: int = 16000, chunk_samples: int = 2048, on_partial=None,
                           on_final=None, config: dict = None):
    """Stream `audio` (f32 samples) to `ws_url` in chunks of
    `chunk_samples`; returns the final texts joined. Replies that arrive
    while the chunks go out are read without waiting for them; the rest
    are read after {"eof": 1} until the server closes."""
    from ssak_tpu_torch.infer.websocket import connect

    audio = np.asarray(audio, np.float32)
    final_text = []
    async with connect(ws_url) as ws:
        await ws.send(json.dumps({"config": {"sample_rate": sample_rate, **(config or {})}}))
        for i in range(0, len(audio), chunk_samples):
            await ws.send(array_to_bytes(audio[i : i + chunk_samples]))
            try:
                msg = await _recv_nowait(ws)
                _dispatch(msg, on_partial, on_final, final_text)
            except asyncio.TimeoutError:
                pass
        await ws.send(json.dumps({"eof": 1}))
        async for msg in ws:
            _dispatch(msg, on_partial, on_final, final_text)
    return " ".join(final_text).strip()


async def _recv_nowait(ws):
    return await asyncio.wait_for(ws.recv(), timeout=0.001)


def _dispatch(msg, on_partial, on_final, final_text):
    if isinstance(msg, (bytes, bytearray)):
        return
    data = json.loads(msg)
    if "partial" in data and on_partial:
        on_partial(data["partial"])
    if "text" in data:
        final_text.append(data["text"])
        if on_final:
            on_final(data["text"])
