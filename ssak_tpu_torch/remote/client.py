"""Remote transcription client, streaming half (counterpart of
ssak_tpu.remote.client's `remote_streaming` and its helpers).

Streams int16 PCM to a LinTO / Vosk streaming server (infer.streaming, or
ssak_tpu's) over the port's own WebSocket code (infer.websocket): a JSON
config, binary chunks, {"eof": 1}; the server's {"partial": ...} and
{"text": ...} messages go to the callbacks. The HTTP half of ssak_tpu's
client (`remote_transcribe`) is not ported.
"""

import asyncio
import json

import numpy as np


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
