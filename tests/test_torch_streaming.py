"""The port's streaming recognition (ssak_tpu_torch.infer.streaming), its
WebSocket code (infer.websocket) and its streaming client
(remote.client.remote_streaming) against ssak_tpu's on the CPU.

One tiny wav2vec2 (tiny_test widths) in f32 takes ssak_tpu's seeded
parameters, converted; each package serves its own copy. Partials and
final texts are greedy argmaxes of log-probs that agree to 5e-5 in f32
(tests/test_torch_ctc_infer.py), so they are compared for equality. The
servers are driven by the `websockets` package's client, which this host
has (the port's code does not import it), and by the port's own client;
every connection is to 127.0.0.1."""

import asyncio
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import ssak_tpu.infer.general as JG
import ssak_tpu.infer.streaming as JS
import ssak_tpu_torch.infer.general as TG
import ssak_tpu_torch.infer.streaming as TS
from ssak_tpu.models import wav2vec2 as JW
from ssak_tpu.models.tokenizer import CTCTokenizer as JTokenizer
from ssak_tpu_torch.infer import websocket as WS
from ssak_tpu_torch.models import wav2vec2 as TW
from ssak_tpu_torch.remote.client import array_to_bytes, remote_streaming

websockets = pytest.importorskip("websockets")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 2048


@pytest.fixture(scope="module")
def models():
    """(ssak_tpu LoadedModel, port LoadedModel on the CPU), same f32 weights."""
    jcfg = JW.make_config("tiny_test", dtype="float32")
    params = JW.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    tok = TG.seeded_ctc_tokenizer(jcfg.vocab_size)
    jm = JG.LoadedModel(JG.ModelType.WAV2VEC2_CTC, params, jcfg, JTokenizer(dict(tok.vocab)))
    tm = TG.from_tree(tree, TW.make_config("tiny_test", dtype="float32"), device="cpu")
    return jm, tm


def _audio(seconds=5.3, seed=0):
    rng = np.random.RandomState(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000.0
    a = 0.3 * np.sin(2 * np.pi * 300 * t) * (np.sin(2 * np.pi * 0.7 * t) > 0) + 0.05 * rng.randn(n)
    return np.clip(a, -1, 1).astype(np.float32)


def _chunks(audio, size=CHUNK):
    return [array_to_bytes(audio[i : i + size]) for i in range(0, len(audio), size)]


def _decode(decoder_cls, model, chunks, **kw):
    dec = decoder_cls(model, **kw)
    partials = []
    for c in chunks:
        if dec.accept_waveform(c):
            partials.append(dec.partial_result())
    return partials, dec.finalize()


@pytest.mark.parametrize("kw", [{}, dict(block_seconds=0.5, context_seconds=0.25)])
def test_decoder_partials_and_final_match_jax(models, kw):
    jm, tm = models
    chunks = _chunks(_audio())
    want = _decode(JS.StreamingCTCDecoder, jm, chunks, **kw)
    got = _decode(TS.StreamingCTCDecoder, tm, chunks, **kw)
    assert got == want
    assert len(got[0]) >= 2 and got[1]


async def _lockstep(url, chunks, connect):
    """The LinTO reference client: config, then each chunk followed by a
    blocking recv, then eof, the final reply and the close."""
    replies, closed_ok = [], False
    async with connect(url) as ws:
        await ws.send(json.dumps({"config": {"sample_rate": 16000}}))
        for c in chunks:
            await ws.send(c)
            replies.append(json.loads(await asyncio.wait_for(ws.recv(), timeout=30.0)))
        await ws.send(json.dumps({"eof": 1}))
        replies.append(json.loads(await asyncio.wait_for(ws.recv(), timeout=30.0)))
        try:
            await asyncio.wait_for(ws.recv(), timeout=10.0)
        except (websockets.ConnectionClosedOK, WS.ConnectionClosedOK):
            closed_ok = True
    return replies, closed_ok


def _serve_and(serve, model, client):
    async def run():
        server = await serve(model, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        try:
            return await client(f"ws://127.0.0.1:{port}")
        finally:
            server.close()
            await server.wait_closed()

    return asyncio.run(run())


def test_server_messages_match_jax_server(models):
    """The same chunks through each package's server, driven by the
    websockets client in lockstep: the same replies, message for message."""
    jm, tm = models
    chunks = _chunks(_audio(seed=1))
    want = _serve_and(JS.serve_streaming, jm, lambda url: _lockstep(url, chunks, websockets.connect))
    got = _serve_and(TS.serve_streaming, tm, lambda url: _lockstep(url, chunks, websockets.connect))
    assert got == want
    replies, closed_ok = got
    assert closed_ok and len(replies) == len(chunks) + 1 and replies[-1]["text"]


def test_protocol_schema_golden(models):
    """tests/expected/streaming_protocol.json on the port's server, driven
    by the websockets client and by the port's own, as the reference client
    drives it (a blocking recv after every chunk)."""
    with open(os.path.join(REPO, "tests", "expected", "streaming_protocol.json")) as f:
        schema = json.load(f)
    _jm, tm = models
    chunks = _chunks(_audio(seconds=2.7, seed=2))
    for connect in (websockets.connect, WS.connect):
        replies, closed_ok = _serve_and(TS.serve_streaming, tm, lambda url: _lockstep(url, chunks, connect))
        allowed = set(schema["per_chunk_reply"]["exactly_one_key_of"])
        assert len(replies) == len(chunks) + 1
        for r in replies[:-1]:
            assert isinstance(r, dict) and len(r) == 1
            (key,) = r.keys()
            assert key in allowed and key == "partial" and isinstance(r[key], str)
        assert set(replies[-1]) == {schema["final_reply"]["key"]} and isinstance(replies[-1]["text"], str)
        assert closed_ok, schema["after_final"]


@pytest.mark.parametrize("server", ["jax", "port"])
def test_remote_streaming(models, server):
    """The port's remote_streaming against ssak_tpu's server and the
    port's: the final text is the in-process decoder's, and one partial
    arrives per chunk, all before the text."""
    jm, tm = models
    audio = _audio(seconds=4.1, seed=3)
    events = []
    serve, model = (JS.serve_streaming, jm) if server == "jax" else (TS.serve_streaming, tm)
    text = _serve_and(serve, model, lambda url: remote_streaming(
        url, audio, chunk_samples=CHUNK, on_partial=lambda p: events.append("partial"),
        on_final=lambda t: events.append("text")))
    _partials, final = _decode(TS.StreamingCTCDecoder, tm, _chunks(audio))
    assert text == final and final
    n_chunks = -(-len(audio) // CHUNK)
    assert events == ["partial"] * n_chunks + ["text"]


def test_streaming_cli_serves_on_the_cpu_when_asked():
    """python -m ssak_tpu_torch.infer.streaming --seeded_test_config
    wav2vec2 --device cpu --port 0 listens and serves a client."""
    cmd = [sys.executable, "-m", "ssak_tpu_torch.infer.streaming", "--seeded_test_config", "wav2vec2", "--device",
           "cpu", "--port", "0"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        line = proc.stdout.readline()
        assert line.startswith("streaming ASR listening on ws://127.0.0.1:"), (line, proc.stderr.read())
        url = line.split()[-1]
        text = asyncio.run(remote_streaming(url, _audio(seconds=2.5, seed=4), chunk_samples=4096))
        assert isinstance(text, str)
    finally:
        proc.kill()
        proc.wait(timeout=30)


# --- the WebSocket code ------------------------------------------------------------


def test_accept_key_of_rfc_6455_example():
    assert WS.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


def _read_all(data: bytes):
    async def run():
        reader = asyncio.StreamReader()
        reader.feed_data(data)
        reader.feed_eof()
        out = []
        while not reader.at_eof():
            out.append(await WS.read_frame(reader))
        return out

    return asyncio.run(run())


@pytest.mark.parametrize("n,header", [(0, 2), (125, 2), (126, 4), (65535, 4), (65536, 10)])
@pytest.mark.parametrize("mask", [False, True])
def test_frame_lengths_round_trip(n, header, mask):
    """Payloads of 125 bytes (7-bit length), 126 and 65,535 (16-bit) and
    65,536 (64-bit), masked and not."""
    payload = np.random.RandomState(n).randint(0, 256, n).astype(np.uint8).tobytes()
    frame = WS.encode_frame(WS.OP_BINARY, payload, mask=mask)
    assert len(frame) == header + (4 if mask else 0) + n
    assert frame[0] == 0x80 | WS.OP_BINARY and bool(frame[1] & 0x80) == mask
    [(fin, op, got, masked)] = _read_all(frame)
    assert (fin, op, got, masked) == (True, WS.OP_BINARY, payload, mask)
    if mask and n:
        assert frame[header + 4:] != payload  # masked on the wire


def test_fragmented_frames_on_the_wire():
    frames = (WS.encode_frame(WS.OP_TEXT, "héllo ".encode(), mask=True, fin=False)
              + WS.encode_frame(WS.OP_PING, b"p", mask=True)
              + WS.encode_frame(WS.OP_CONT, b"world", mask=True, fin=True))
    got = _read_all(frames)
    assert [(f, o) for f, o, _p, _m in got] == [(False, WS.OP_TEXT), (True, WS.OP_PING), (True, WS.OP_CONT)]
    assert b"".join(p for _f, o, p, _m in got if o != WS.OP_PING).decode() == "héllo world"


async def _echo(ws):
    async for msg in ws:
        await ws.send(msg)


def test_port_server_with_websockets_client():
    """Handshake, text and binary of every length class, fragmented
    messages from the client (text and binary), ping / pong and the close
    code."""
    async def client(url):
        out = []
        async with websockets.connect(url, max_size=None) as ws:
            for msg in ("hé", b"\x00" * 125, b"\x01" * 126, b"\x02" * 65536, "x" * 70000):
                await ws.send(msg)
                out.append(await ws.recv() == msg)
            await ws.send(["frag", "mented"])  # a fragmented text message
            out.append(await ws.recv() == "fragmented")
            await ws.send([b"ab", b"cd", b"ef"])
            out.append(await ws.recv() == b"abcdef")
            pong = await ws.ping(b"are you there")
            await asyncio.wait_for(pong, timeout=10)
            out.append(True)
        out.append(ws.close_code == 1000)
        return out

    async def run():
        server = await WS.serve(_echo, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        try:
            return await client(f"ws://127.0.0.1:{port}")
        finally:
            server.close()
            await server.wait_closed()

    assert all(asyncio.run(run()))


def test_port_client_with_websockets_server():
    """The port's client against the websockets server: echoes of every
    length class, and the server's close code and reason."""
    async def handler(ws):
        async for msg in ws:
            await ws.send(msg)
            if msg == "bye":
                await ws.close(1000, "done")

    async def run():
        server = await websockets.serve(handler, "127.0.0.1", 0, max_size=None)
        port = server.sockets[0].getsockname()[1]
        out = []
        try:
            async with WS.connect(f"ws://127.0.0.1:{port}") as ws:
                for msg in ("hé", b"\x00" * 125, b"\x01" * 126, b"\x02" * 65536):
                    await ws.send(msg)
                    out.append(await ws.recv() == msg)
                await ws.send("bye")
                out.append(await ws.recv() == "bye")
                with pytest.raises(WS.ConnectionClosedOK) as e:
                    await ws.recv()
                out.append(e.value.code == 1000 and e.value.reason == "done")
        finally:
            server.close()
            await server.wait_closed()
        return out

    assert all(asyncio.run(run()))


def test_server_refuses_a_plain_http_request():
    async def run():
        server = await WS.serve(_echo, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
            await writer.drain()
            status = await reader.readline()
            writer.close()
            return status
        finally:
            server.close()
            await server.wait_closed()

    assert asyncio.run(run()).startswith(b"HTTP/1.1 400")


def _frame_head(opcode, n, fin=True):
    """A masked client frame's header (length and masking key) for `n`
    payload bytes, without the payload."""
    frame = WS.encode_frame(opcode, bytes(n), mask=True, fin=fin)
    return frame[: len(frame) - n]


HALF = WS.MAX_SIZE // 2


@pytest.mark.parametrize("wire, close_code", [
    # one frame announcing a byte more than MAX_SIZE: refused before its payload is read
    (_frame_head(WS.OP_BINARY, WS.MAX_SIZE + 1), 1009),
    # a fragmented message whose running total passes MAX_SIZE at its second frame
    (WS.encode_frame(WS.OP_BINARY, bytes(HALF + 1), mask=True, fin=False) + _frame_head(WS.OP_CONT, HALF), 1009),
    # a control frame longer than 125 bytes
    (_frame_head(WS.OP_PING, 126), 1002),
], ids=["frame", "fragmented", "control"])
def test_server_closes_on_an_oversized_frame_or_message(wire, close_code):
    """The server's reply to a peer that announces more than MAX_SIZE
    bytes (1 MiB, `websockets`' default): a close frame with 1009 (1002
    for a control frame over 125 bytes), then the end of the connection;
    the payload is never buffered."""
    async def run():
        server = await WS.serve(_echo, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            key = "dGhlIHNhbXBsZSBub25jZQ=="
            writer.write((f"GET / HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
                          f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n").encode("ascii"))
            await writer.drain()
            assert (await reader.readuntil(b"\r\n\r\n")).startswith(b"HTTP/1.1 101")
            writer.write(wire)
            await writer.drain()
            fin, op, payload, masked = await asyncio.wait_for(WS.read_frame(reader), 10)
            rest = await asyncio.wait_for(reader.read(), 10)
            writer.close()
            return op, int.from_bytes(payload[:2], "big"), masked, rest
        finally:
            server.close()
            await server.wait_closed()

    op, code, masked, rest = asyncio.run(run())
    assert (op, code, masked, rest) == (WS.OP_CLOSE, close_code, False, b"")


def test_a_message_of_max_size_passes_and_the_client_refuses_more():
    """A fragmented message of exactly MAX_SIZE reaches the handler
    (websockets client against the port's server); the port's client
    closes with 1009 when the server sends a byte more."""
    async def oversend(ws):
        async for _ in ws:
            await ws.send(bytes(WS.MAX_SIZE + 1))

    async def run():
        echo = await WS.serve(_echo, "127.0.0.1", 0)
        over = await WS.serve(oversend, "127.0.0.1", 0)
        try:
            async with websockets.connect(f"ws://127.0.0.1:{echo.sockets[0].getsockname()[1]}", max_size=None) as ws:
                await ws.send([bytes(HALF), b"\x01" * HALF])
                echoed = await ws.recv() == bytes(HALF) + b"\x01" * HALF
            async with WS.connect(f"ws://127.0.0.1:{over.sockets[0].getsockname()[1]}") as ws:
                await ws.send(b"go")
                try:
                    await asyncio.wait_for(ws.recv(), 10)
                    code = None
                except WS.ConnectionClosed as e:
                    code = e.code
            return echoed, code
        finally:
            for server in (echo, over):
                server.close()
                await server.wait_closed()

    assert asyncio.run(run()) == (True, 1009)
