"""Host prefix-beam decoding over a process pool (counterpart of
ssak_tpu.decode.pool).

The host prefix beam (decode/ctc_beam.ctc_prefix_beam_search) is the route
for word LMs of order > 3 and for decoding that lets words outside the
lexicon through, and it runs in Python, one utterance at a time. The pool
spreads utterances over worker processes:

* workers are spawned, never forked: the parent holds a CUDA context, which
  does not survive a fork;
* each worker hides the card (CUDA_VISIBLE_DEVICES="" before anything
  imports torch's CUDA runtime) and never initialises CUDA; this module and
  the decode modules it loads touch no device;
* a worker loads the LM (through native_lm.load_lm) and the lexicon once,
  from their paths; only the (T, V) log-prob arrays cross the pipe.
"""

import os

_WORKER = {}
STATE_TIMEOUT = 60.0  # seconds a worker_states task waits for the other workers


def _init_worker(lm_path, lexicon_path, vocab, blank_id, beam_width, alpha, beta, barrier):
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    lm = None
    if lm_path:
        from ssak_tpu_torch.decode.native_lm import load_lm

        lm = load_lm(lm_path)
    lexicon = None
    if lexicon_path:
        from ssak_tpu_torch.decode.lexicon import Lexicon

        lexicon = Lexicon.from_file(lexicon_path)
    _WORKER.update(lm=lm, lexicon=lexicon, vocab=list(vocab), blank_id=blank_id, beam_width=beam_width, alpha=alpha,
                   beta=beta, barrier=barrier)


def _decode_one(lp):
    from ssak_tpu_torch.decode.ctc_beam import ctc_prefix_beam_search

    w = _WORKER
    res = ctc_prefix_beam_search(lp, w["vocab"], blank_id=w["blank_id"], beam_width=w["beam_width"], lm=w["lm"],
                                 alpha=w["alpha"], beta=w["beta"], lexicon=w["lexicon"])
    return res[0][0] if res else ""


def _worker_state(_=None):
    """What the tests and the on-card check read of a worker: its pid, the
    type of its LM, whether its torch has initialised CUDA, and
    CUDA_VISIBLE_DEVICES. The task waits at the pool's barrier until every
    worker holds one such task, so one task per worker reads each worker
    once."""
    import sys

    _WORKER["barrier"].wait(STATE_TIMEOUT)
    torch = sys.modules.get("torch")
    return dict(pid=os.getpid(), lm=type(_WORKER.get("lm")).__name__,
                cuda_initialized=bool(torch is not None and torch.cuda.is_initialized()),
                cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"))


class HostBeamPool:
    """Decode (T, V) log-prob arrays to text across worker processes.
    Create it once per run (a worker's start is an LM load), feed it every
    batch, close it at the end."""

    def __init__(self, n_workers, lm_path=None, lexicon_path=None, vocab=(), blank_id: int = 0,
                 beam_width: int = 25, alpha: float = 0.5, beta: float = 1.5):
        import multiprocessing as mp

        self.n_workers = max(1, n_workers)
        ctx = mp.get_context("spawn")
        barrier = ctx.Barrier(self.n_workers)
        self.pool = ctx.Pool(
            self.n_workers, initializer=_init_worker,
            initargs=(lm_path, lexicon_path, list(vocab), blank_id, beam_width, alpha, beta, barrier))

    def decode(self, log_probs_list):
        """log_probs_list: (T_b, V) f32 numpy arrays, trimmed to their
        frames. Returns the transcripts in order."""
        return self.pool.map(_decode_one, log_probs_list, chunksize=1)

    def decode_async(self, log_probs_list):
        """decode without blocking: a handle whose .get() gives the
        transcripts, so the caller can enqueue the next batch's device work
        while the workers decode this one."""
        return self.pool.map_async(_decode_one, log_probs_list, chunksize=1)

    def worker_states(self):
        """_worker_state of every worker, once each, in no fixed order (the
        tasks meet at a barrier, so no worker can take two)."""
        return self.pool.map(_worker_state, range(self.n_workers), chunksize=1)

    def close(self):
        self.pool.close()
        self.pool.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
