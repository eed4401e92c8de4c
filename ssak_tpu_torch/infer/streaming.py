"""Streaming CTC recognition: a block-wise decoder and its WebSocket server
(counterpart of ssak_tpu.infer.streaming, `sak-stream`).

    python -m ssak_tpu_torch.infer.streaming --model DIR [--load_in_8bit | --load_in_4bit] [--port 2700] [--device cpu]

* `StreamingCTCDecoder`: feed waveform chunks of any size; each block of
  `block_seconds` runs through the model (compute_log_probas, on the
  model's device) with `context_seconds` of left context recomputed;
  greedy tokens collapse across blocks; a partial result after every
  block, the final one from `finalize()`. The block, context, padding and
  skipped-frame arithmetic are ssak_tpu's.
* `serve_streaming`: the LinTO / Vosk protocol over WebSocket (the port's
  own RFC 6455 code, infer.websocket): a JSON config, binary int16 chunks,
  one {"partial": ...} reply per chunk, {"eof": 1} -> one {"text": ...},
  then the server closes the connection.
"""

import asyncio
import json

import numpy as np


class StreamingCTCDecoder:
    def __init__(self, model, sample_rate: int = 16000, block_seconds: float = 2.0, context_seconds: float = 0.64):
        self.model = model
        self.sample_rate = sample_rate
        self.block = int(block_seconds * sample_rate)
        self.context = int(context_seconds * sample_rate)
        self.reset()

    def reset(self):
        self._buffer = np.zeros(0, np.float32)
        self._tokens = []

    def accept_waveform(self, chunk) -> bool:
        """Feed f32 samples (or int16 little-endian bytes). Returns True when
        a new block was decoded (a new partial result)."""
        if isinstance(chunk, (bytes, bytearray)):
            chunk = np.frombuffer(chunk, "<i2").astype(np.float32) / 32768.0
        self._buffer = np.concatenate([self._buffer, np.asarray(chunk, np.float32)])
        decoded = False
        while len(self._buffer) >= self.block + self.context:
            self._decode_block(self._buffer[: self.block + self.context], emit=self.block)
            self._buffer = self._buffer[self.block:]
            decoded = True
        return decoded

    def _decode_block(self, audio, emit: int):
        """Run the model on [left context + block] and keep the tokens of
        the frames that fall in the last `emit` samples."""
        import torch

        from ssak_tpu_torch.infer.general import compute_log_probas

        pad = int(np.ceil(len(audio) / self.block)) * self.block + self.context
        x = np.zeros((1, pad), np.float32)
        x[0, : len(audio)] = audio
        lp, fl = compute_log_probas(self.model, x, [len(audio)])
        total_frames = int(fl[0])
        # frames of audio emitted before (all but the last `emit` samples)
        skip_frames = int(round(total_frames * (len(audio) - emit) / max(1, len(audio))))
        best = torch.argmax(lp[0, :total_frames], dim=-1).cpu().numpy()
        blank = self.model.cfg.blank_id
        prev = self._tokens[-1] if self._tokens else blank
        for t in range(skip_frames, total_frames):
            tok = int(best[t])
            if tok != blank and tok != prev:
                self._tokens.append(tok)
            prev = tok

    def partial_result(self) -> str:
        return self.model.tokenizer.decode(self._tokens)

    def finalize(self) -> str:
        if len(self._buffer) > self.sample_rate // 50:
            self._decode_block(self._buffer, emit=len(self._buffer))
        self._buffer = np.zeros(0, np.float32)
        return self.partial_result()


async def _handle_connection(ws, model):
    """One client: a decoder per stream, one reply per binary chunk (the
    LinTO / Vosk client waits for it after every send), the final text on
    {"eof": 1}."""
    decoder = None
    async for msg in ws:
        if isinstance(msg, (bytes, bytearray)):
            if decoder is None:
                decoder = StreamingCTCDecoder(model)
            decoder.accept_waveform(msg)
            await ws.send(json.dumps({"partial": decoder.partial_result()}, ensure_ascii=False))
        else:
            data = json.loads(msg)
            if "config" in data:
                decoder = StreamingCTCDecoder(model, sample_rate=data["config"].get("sample_rate", 16000))
            elif data.get("eof"):
                if decoder is None:
                    decoder = StreamingCTCDecoder(model)
                await ws.send(json.dumps({"text": decoder.finalize()}, ensure_ascii=False))
                return


async def serve_streaming(model, host: str = "127.0.0.1", port: int = 0):
    """Start the streaming ASR server; returns the asyncio.Server
    (server.sockets[0].getsockname() for the bound port)."""
    from ssak_tpu_torch.infer.websocket import serve

    return await serve(lambda ws: _handle_connection(ws, model), host, port)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Streaming CTC ASR server over WebSocket (PyTorch/CUDA port)")
    p.add_argument("--model", default=None, help="CTC model directory (HF wav2vec2, NeMo archive or an export)")
    p.add_argument("--seeded_test_config", default=None, help=argparse.SUPPRESS)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=2700)
    p.add_argument("--load_in_8bit", action="store_true", help="int8 weight-only quantized model")
    p.add_argument("--load_in_4bit", action="store_true", help="int4 weight-only quantized model")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ssak_tpu_torch.infer.general import load_model

    model = load_model(args.model, seeded_test_config=args.seeded_test_config, device=args.device,
                       quantize_bits=4 if args.load_in_4bit else (8 if args.load_in_8bit else 0))

    async def run():
        server = await serve_streaming(model, args.host, args.port)
        addr = server.sockets[0].getsockname()
        print(f"streaming ASR listening on ws://{addr[0]}:{addr[1]}", flush=True)
        await asyncio.Future()

    asyncio.run(run())


if __name__ == "__main__":
    main()
