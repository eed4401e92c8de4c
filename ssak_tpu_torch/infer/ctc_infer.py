"""CTC inference (wav2vec2 or Conformer) over files and Kaldi folders, with
long-audio chunking (counterpart of ssak_tpu.infer.ctc_infer).

Inputs are padded to duration buckets (up to the 140 s chunk,
MAX_CHUNK_SAMPLES); rows are packed under a samples budget
(auto_pack_batches) and padded to a power of two (padded_batch_shape);
longer files are cut into 140 s chunks, each padded to its bucket, and
their log-probs concatenated. Decoding is greedy on the device, the device
beam (optionally with a lexicon, and a word n-gram LM of order <= 3 fused
on the device), or the host prefix beam (char/word LM without lexicon
tables, and chunked files under an LM, a lexicon or a beam), in process or
over a pool of worker processes (`num_workers` > 1, decode.pool). LMs load
through decode.native_lm.load_lm (the C++ scorer; ArpaLM for `.gz`).
Models may be quantized on load (`quantize_bits`, `--load_in_8bit` /
`--load_in_4bit`): an encoder pass has more rows than K2 and K3 take, so
each quantized dense dequantizes its weight, as in ssak_tpu.

At the 140 s bucket a wav2vec2 encoder runs 7,001 frames, and its
self-attention goes through the fused kernel L1 (models.layers._can_flash);
a Conformer's 3,501 frames stay on its unfused rel-pos attention, as in
ssak_tpu.

Tensor parallelism (`tensor_parallel=N`, `--tensor_parallel N`): one
process per rank, started by torchrun (`python -m torch.distributed.run
--nproc_per_node N -m ssak_tpu_torch.infer.ctc_infer ...`); each rank loads
the model, keeps its slice of the weights (infer.general.shard_model) and
reads the same batches, and rank 0 yields (the CLI: writes) the
transcripts. `dist_backend` picks the process groups' backend (nccl on
cards by default, gloo on the CPU).
"""

import os
import sys

import numpy as np

MAX_CHUNK_SAMPLES = 2_240_400  # ~140 s

_BUCKETS_SAMPLES = (16000, 32000, 64000, 160000, 320000, 480000, MAX_CHUNK_SAMPLES)

# Auto batch budget: about 960 audio-seconds of padded samples per batch
# (32 x 30 s, 6 x 140 s), at most 96 rows; ssak_tpu's values, kept.
AUTO_BATCH_SECONDS = 960.0
AUTO_MAX_ROWS = 96


def _bucket_len(n: int) -> int:
    for b in _BUCKETS_SAMPLES:
        if n <= b:
            return b
    return MAX_CHUNK_SAMPLES


def _next_pow2(n: int) -> int:
    w = 1
    while w < n:
        w *= 2
    return w


def auto_pack_batches(rows, max_samples: int = None, max_rows: int = AUTO_MAX_ROWS):
    """Greedy samples-budget packing of consecutive rows.

    rows: iterable of (audio_array, id). Batches keep their PADDED cost
    (rows x bucket of the longest row) under `max_samples`, at most
    `max_rows` rows. Utterances longer than one chunk go out alone (they
    take the chunked path). Yields (list_of_audio, list_of_ids)."""
    if max_samples is None:
        max_samples = int(AUTO_BATCH_SECONDS * 16000)
    batch, ids = [], []
    cur_max = 0
    for a, i in rows:
        if len(a) > MAX_CHUNK_SAMPLES:
            if batch:
                yield batch, ids
                batch, ids, cur_max = [], [], 0
            yield [a], [i]
            continue
        nb = _bucket_len(max(len(a), cur_max))
        cap = max(1, min(max_rows, max_samples // nb))
        if batch and len(batch) + 1 > cap:
            yield batch, ids
            batch, ids, cur_max = [], [], 0
            nb = _bucket_len(len(a))
            cap = max(1, min(max_rows, max_samples // nb))
        batch.append(a)
        ids.append(i)
        cur_max = max(cur_max, len(a))
        if len(batch) >= cap:
            yield batch, ids
            batch, ids, cur_max = [], [], 0
    if batch:
        yield batch, ids


def padded_batch_shape(lens, batch_size: int = 0, sample_rate: int = 16000):
    """(rows W, columns pad_to) of the device batch for `lens`: columns pad
    to the duration bucket, rows to the next power of 2 capped at the batch
    ceiling (an explicit batch_size, or the auto samples budget)."""
    pad_to = _bucket_len(max(lens))
    if batch_size and batch_size > 0:
        cap = batch_size
    else:
        cap = max(1, min(AUTO_MAX_ROWS, int(AUTO_BATCH_SECONDS * sample_rate) // pad_to))
    W = max(len(lens), min(_next_pow2(len(lens)), cap))
    return W, pad_to


def chunk_lengths(n: int):
    """Sample counts of the MAX_CHUNK_SAMPLES chunks a file of n samples is cut into."""
    return [min(MAX_CHUNK_SAMPLES, n - i) for i in range(0, max(1, n), MAX_CHUNK_SAMPLES)]


def _padded(batch, pad_to: int):
    x = np.zeros((len(batch), pad_to), np.float32)
    for i, a in enumerate(batch):
        x[i, : len(a)] = a
    return x


def ctc_compute_logits_chunked(model, audio: np.ndarray) -> np.ndarray:
    """Log-probs (F, V) of one (possibly long) utterance: chunks of
    MAX_CHUNK_SAMPLES, each padded to its bucket, log-probs concatenated."""
    from ssak_tpu_torch.infer.general import compute_log_probas

    outs, start = [], 0
    for n in chunk_lengths(len(audio)):
        ch = audio[start : start + n]
        start += n
        lp, fl = compute_log_probas(model, _padded([ch], _bucket_len(n)), [n])
        outs.append(lp[0, : int(fl[0])].cpu().numpy())
    return np.concatenate(outs, axis=0)


def ctc_transcribe_batch(model, batch):
    """batch: list of 1-D float32 arrays -> list of greedy transcripts."""
    from ssak_tpu_torch.infer.general import compute_log_probas, decode_log_probas

    lens = [len(a) for a in batch]
    if max(lens) > MAX_CHUNK_SAMPLES:
        texts = []
        for a in batch:
            lp = ctc_compute_logits_chunked(model, a)
            texts.extend(decode_log_probas(model, lp[None], [lp.shape[0]]))
        return texts
    lp, fl = compute_log_probas(model, _padded(batch, _bucket_len(max(lens))), lens)
    return decode_log_probas(model, lp, fl)


def ctc_decode_with_lm(model, batch, lm, alpha: float = 0.5, beta: float = 1.5, beam_width: int = 25, lexicon=None):
    """Host prefix-beam decode with word n-gram shallow fusion and/or a
    word-lexicon constraint, one utterance at a time."""
    from ssak_tpu_torch.decode.ctc_beam import ctc_prefix_beam_search
    from ssak_tpu_torch.infer.general import compute_log_probas

    lens = [len(a) for a in batch]
    lp, fl = compute_log_probas(model, _padded(batch, _bucket_len(max(lens))), lens)
    lp, fl = lp.cpu().numpy(), fl.cpu().numpy()
    vocab = model.vocab()
    texts = []
    for b in range(len(batch)):
        res = ctc_prefix_beam_search(lp[b, : fl[b]], vocab, blank_id=model.cfg.blank_id, beam_width=beam_width,
                                     lm=lm, alpha=alpha, beta=beta, lexicon=lexicon)
        texts.append(res[0][0] if res else "")
    return texts


def ctc_decode_beam_device(model, batch, beam_width: int = 16, lm_table=None, lm_alpha: float = 0.5,
                           lexicon_tables=None, word_lm=None, lm_beta: float = 1.5):
    """Batched beam search on the device: optionally char-LM fused,
    lexicon-constrained (trie tables), and/or word-n-gram fused at word
    boundaries (hashed ARPA tables). Pass tables built once per model."""
    from ssak_tpu_torch.decode.ctc_beam import ctc_beam_search_device
    from ssak_tpu_torch.infer.general import compute_log_probas

    lens = [len(a) for a in batch]
    lp, fl = compute_log_probas(model, _padded(batch, _bucket_len(max(lens))), lens)
    tokens, lengths = ctc_beam_search_device(
        lp, fl, beam_width=beam_width, blank_id=model.cfg.blank_id, lm_table=lm_table, lm_alpha=lm_alpha,
        lexicon_tables=lexicon_tables, word_lm=word_lm, lm_beta=lm_beta)
    return [model.tokenizer.decode(tokens[b, : lengths[b]]) for b in range(len(batch))]


def ctc_infer(
    model_dir,
    audios,
    batch_size: int = 0,
    sort_by_len: bool = False,
    output_ids: bool = False,
    log_memtime: bool = False,
    seeded_test_config: str = None,
    lm_path: str = None,
    lm_alpha: float = 0.5,
    lm_beta: float = 1.5,
    beam_width: int = 0,
    lexicon_path: str = None,
    tensor_parallel: int = 0,
    quantize_bits: int = 0,
    num_workers: int = 0,
    device=None,
    dist_backend: str = None,
):
    """Iterator over transcripts (or (id, text) with output_ids) of any
    audio source to_audio_batches takes, on `device` (default cuda; raises
    here, at the call, when there is none). lm_path: ARPA n-gram for shallow fusion;
    lexicon_path: word list constraining the beam; beam_width > 1 uses the
    device beam (which also takes a lexicon, and an LM of order <= 3 with a
    lexicon); other LM / lexicon decodes take the host prefix beam, which
    num_workers > 1 fans over a process pool (decode.pool, one beam width
    for pooled and in-process runs). quantize_bits: 8 or 4 quantizes the
    model on load.
    tensor_parallel=N shards the model over the N ranks of a process group
    (torchrun's; raises ValueError without one), on the backend
    `dist_backend`; only rank 0 yields transcripts.

    batch_size=0 auto-packs batches under the samples budget. Ingest runs in
    a prefetch thread, and each batch's device work (encoder, greedy or
    beam) is enqueued before the previous batch's host tail (fetch,
    backtrace, text, or the pool's decode of it) runs."""
    from ssak_tpu_torch.data.dataset import to_audio_batches
    from ssak_tpu_torch.infer.general import compute_log_probas, drain, join_tensor_parallel, load_model, shard_model

    rank0 = True
    if tensor_parallel:
        device, rank0 = join_tensor_parallel(tensor_parallel, device, dist_backend, "ctc_infer")
    model = load_model(model_dir, seeded_test_config=seeded_test_config, quantize_bits=quantize_bits, device=device)
    if tensor_parallel:
        shard_model(model, model_axis=tensor_parallel)
    lm = None
    if lm_path:
        from ssak_tpu_torch.decode.native_lm import load_lm

        lm = load_lm(lm_path)
    lexicon = None
    if lexicon_path:
        from ssak_tpu_torch.decode.lexicon import Lexicon

        lexicon = Lexicon.from_file(lexicon_path)

    # device tables, built once per run (disk-cached on the source files):
    # trie tables, and with an LM of order <= 3 the hashed word-LM tables,
    # so that LM + lexicon + beam decoding runs on the device
    lex_tables = word_lm_tables = None
    if lexicon is not None and beam_width > 1:
        from ssak_tpu_torch.decode.table_cache import lexicon_tables_cached, word_lm_tables_cached

        trans, accept, node_word_ids = lexicon_tables_cached(
            lexicon, lexicon_path, model.vocab(), word_delimiter=model.tokenizer.word_delimiter)
        lex_tables = (trans, accept)
        if lm is not None:
            from ssak_tpu_torch.decode.lm import ArpaLM, arpa_order

            order = lm.order if isinstance(lm, ArpaLM) else arpa_order(lm_path)
            if order <= 3:  # the device context carries order-1 word ids
                # the tables come from an ArpaLM, parsed only on a cache miss
                word_lm_tables = word_lm_tables_cached(lambda: lm if isinstance(lm, ArpaLM) else ArpaLM(lm_path),
                                                       lm_path, lexicon.word_list())
                lex_tables = (trans, accept, node_word_ids)
    # one width for every host-beam route, pooled or in process
    host_beam = beam_width if beam_width > 1 else 25
    pool = None
    host_beam_route = word_lm_tables is None and (lm is not None or (lexicon is not None and lex_tables is None))
    if num_workers and num_workers > 1 and host_beam_route:
        from ssak_tpu_torch.decode.pool import HostBeamPool

        pool = HostBeamPool(num_workers, lm_path=lm_path, lexicon_path=lexicon_path, vocab=model.vocab(),
                            blank_id=model.cfg.blank_id, beam_width=host_beam, alpha=lm_alpha, beta=lm_beta)
    from ssak_tpu_torch.ops.ctc import ctc_greedy_decode

    def _encode_padded(batch):
        """Columns padded to the duration bucket and rows to the next power
        of 2 under the batch ceiling, in the int16 wire format (decoded to
        f32 on the device). Returns (lp, fl) of the padded batch."""
        from ssak_tpu_torch.audio.wire import encode_rows

        lens = [len(a) for a in batch]
        W, pad_to = padded_batch_shape(lens, batch_size=batch_size, sample_rate=model.sample_rate)
        return compute_log_probas(model, encode_rows(batch, W, pad_to), lens + [0] * (W - len(batch)))

    def host_beam_texts(rows):
        from ssak_tpu_torch.decode.ctc_beam import ctc_prefix_beam_search

        vocab, texts = model.vocab(), []
        for row in rows:
            res = ctc_prefix_beam_search(row, vocab, blank_id=model.cfg.blank_id, beam_width=host_beam, lm=lm,
                                         alpha=lm_alpha, beta=lm_beta, lexicon=lexicon)
            texts.append(res[0][0] if res else "")
        return texts

    def submit(batch):
        """Enqueue the device work of one batch; returns resolve(), which
        does the host tail."""
        n = len(batch)
        long_rows = [i for i, a in enumerate(batch) if len(a) > MAX_CHUNK_SAMPLES]
        if long_rows:
            # long rows take the chunked path; short rows of the same batch
            # keep their own route, so a transcript never depends on its batch
            long_set = set(long_rows)
            short_rows = [i for i in range(n) if i not in long_set]
            long_batch = [batch[i] for i in long_rows]
            if lm is None and lexicon is None and beam_width <= 1:
                resolve_long = lambda: ctc_transcribe_batch(model, long_batch)  # noqa: E731
            else:
                # chunked log-probs concatenated, then one host prefix beam
                # over the whole utterance
                width = host_beam if (lm is not None or lexicon is not None) else beam_width
                from ssak_tpu_torch.decode.ctc_beam import ctc_prefix_beam_search

                def resolve_long():
                    texts, vocab = [], model.vocab()
                    for a in long_batch:
                        res = ctc_prefix_beam_search(ctc_compute_logits_chunked(model, a), vocab,
                                                     blank_id=model.cfg.blank_id, beam_width=width, lm=lm,
                                                     alpha=lm_alpha, beta=lm_beta, lexicon=lexicon)
                        texts.append(res[0][0] if res else "")
                    return texts

            resolve_short = submit([batch[i] for i in short_rows]) if short_rows else None

            def resolve_mixed():
                texts = [None] * n
                if resolve_short is not None:
                    for i, t in zip(short_rows, resolve_short()):
                        texts[i] = t
                for i, t in zip(long_rows, resolve_long()):
                    texts[i] = t
                return texts

            return resolve_mixed
        device_beam = word_lm_tables is not None or (lm is None and lex_tables is not None) or (
            beam_width > 1 and lm is None and lexicon is None)
        if device_beam:
            from ssak_tpu_torch.decode.ctc_beam import ctc_beam_search_device

            lp, fl = _encode_padded(batch)
            kw = {}
            if word_lm_tables is not None:
                kw = dict(lexicon_tables=lex_tables, word_lm=word_lm_tables, lm_alpha=lm_alpha, lm_beta=lm_beta)
            elif lex_tables is not None:
                kw = dict(lexicon_tables=lex_tables)
            handle = ctc_beam_search_device(lp, fl, beam_width=beam_width, blank_id=model.cfg.blank_id,
                                            return_async=True, **kw)

            def resolve():
                tokens, lengths = handle.result()
                return [model.tokenizer.decode(tokens[b, : lengths[b]]) for b in range(n)]

            return resolve
        if lm is not None or lexicon is not None:
            # host prefix beam: fetch the log-probs now
            lp, fl = _encode_padded(batch)
            lp_h, fl_h = lp.cpu().numpy(), fl.cpu().numpy()
            rows = [lp_h[b, : fl_h[b]] for b in range(n)]
            if pool is not None:
                return pool.decode_async(rows).get
            return lambda: host_beam_texts(rows)
        # greedy: argmax and collapse on the device; resolve only fetches
        lp, fl = _encode_padded(batch)
        tokens, lengths = ctc_greedy_decode(lp, fl, blank_id=model.cfg.blank_id)

        def resolve():
            tk, ln = tokens.cpu().numpy(), lengths.cpu().numpy()
            return [model.tokenizer.decode(tk[b, : ln[b]]) for b in range(n)]

        return resolve

    io_threads = min(4, os.cpu_count() or 2)
    if batch_size and batch_size > 0:
        batches = to_audio_batches(audios, batch_size=batch_size, sample_rate=model.sample_rate, output_ids=True,
                                   sort_by_len=sort_by_len, io_threads=io_threads)
    else:
        rows = to_audio_batches(audios, batch_size=1, sample_rate=model.sample_rate, output_ids=True,
                                sort_by_len=sort_by_len, io_threads=io_threads)
        batches = auto_pack_batches(((a, i) for b, ids in rows for a, i in zip(b, ids)),
                                    max_samples=int(AUTO_BATCH_SECONDS * model.sample_rate))
    items = _pipelined(batches, submit, model.sample_rate, output_ids, log_memtime, pool)
    return items if rank0 else drain(items)


def _pipelined(batches, submit, sample_rate, output_ids, log_memtime, pool=None):
    """Submit batch n+1's device work before resolving batch n; close the
    pool, if any, at the end."""
    from ssak_tpu_torch.data.prefetch import prefetch_iterator
    from ssak_tpu_torch.utils.monitoring import ThroughputMeter, logger

    meter = ThroughputMeter()
    pending = None  # (resolve, ids, audio seconds)
    try:
        for batch, ids in prefetch_iterator(batches, depth=2):
            resolve = submit(batch)
            if pending is not None:
                texts = pending[0]()
                meter.update(pending[2])
                for i, t in zip(pending[1], texts):
                    yield (i, t) if output_ids else t
            pending = (resolve, ids, sum(len(a) for a in batch) / sample_rate)
        if pending is not None:
            texts = pending[0]()
            meter.update(pending[2])
            for i, t in zip(pending[1], texts):
                yield (i, t) if output_ids else t
    finally:
        if pool is not None:
            pool.close()
    if log_memtime:
        logger.info(f"ctc_infer throughput: {meter.summary()}")


def cli(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="Transcribe audio with a CTC model, wav2vec2 or Conformer (PyTorch/CUDA port)")
    parser.add_argument("data", help="audio file, Kaldi dir, or list file")
    parser.add_argument("model", help="model directory: an HF wav2vec2-CTC checkpoint (config.json, *.safetensors or "
                                          "*.bin, vocab.json), a NeMo Conformer-CTC archive (.nemo, or its extracted "
                                          "directory) or an export of train.finalize")
    parser.add_argument("--output", default=None, help="output file (default stdout)")
    parser.add_argument("--batch_size", type=int, default=0,
                        help="0 (default) = auto: pack batches to ~960 audio-s of padded samples")
    parser.add_argument("--sort_by_len", action="store_true")
    parser.add_argument("--use_ids", action="store_true", default=True)
    parser.add_argument("--no-use_ids", dest="use_ids", action="store_false")
    parser.add_argument("--log_memtime", action="store_true")
    parser.add_argument("--lm", default=None, help="ARPA n-gram LM for shallow-fusion beam decoding")
    parser.add_argument("--lexicon", default=None, help="word list / Kaldi lexicon.txt: constrain beam decode to in-lexicon words")
    parser.add_argument("--lm_alpha", type=float, default=0.5)
    parser.add_argument("--lm_beta", type=float, default=1.5)
    parser.add_argument("--beam_width", type=int, default=0, help=">1 enables the device beam search")
    parser.add_argument("--num_workers", type=int, default=0, help=">1 fans host-beam word-LM decoding over a process pool")
    parser.add_argument("--tensor_parallel", "--tp", type=int, default=0, dest="tensor_parallel",
                        help="shard the model's weights over N ranks (megatron TP rules); run under torchrun "
                             "--nproc_per_node N")
    parser.add_argument("--dist_backend", default=None, choices=("nccl", "gloo"),
                        help="backend of the tensor-parallel process group (default nccl on cards, gloo on the CPU)")
    parser.add_argument("--load_in_8bit", action="store_true", help="int8 weight-only quantized decode")
    parser.add_argument("--load_in_4bit", action="store_true", help="int4 weight-only quantized decode")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--seeded_test_config", default=None, help=argparse.SUPPRESS)  # test hook: random model
    args = parser.parse_args(argv)

    items = ctc_infer(
        args.model, args.data, batch_size=args.batch_size, sort_by_len=args.sort_by_len, output_ids=args.use_ids,
        log_memtime=args.log_memtime, lm_path=args.lm, lm_alpha=args.lm_alpha, lm_beta=args.lm_beta,
        beam_width=args.beam_width, lexicon_path=args.lexicon, num_workers=args.num_workers,
        tensor_parallel=args.tensor_parallel, quantize_bits=4 if args.load_in_4bit else (8 if args.load_in_8bit else 0),
        seeded_test_config=args.seeded_test_config, device=args.device, dist_backend=args.dist_backend,
    )
    import torch.distributed as dist

    to_file = args.output and (not dist.is_initialized() or dist.get_rank() == 0)  # rank 0 writes the transcripts
    out = open(args.output, "w", encoding="utf-8") if to_file else sys.stdout
    try:
        for item in items:  # none on the other ranks
            out.write(f"{item[0]} {item[1]}\n" if args.use_ids else f"{item}\n")
            out.flush()
    finally:
        if to_file:
            out.close()
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    cli()
