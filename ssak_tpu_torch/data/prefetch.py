"""Host-side input-pipeline overlap (counterpart of ssak_tpu.data.prefetch).

A small background-thread pipeline keeps `depth` batches ready so host
work (file decode, resample, padding) hides under device time.
"""

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

_END = object()


def prefetch_map(fn, items, workers: int = 2, depth: int = 8):
    """Ordered threaded map with a bounded in-flight window: yields
    fn(item) in input order while `workers` threads compute ahead (up to
    `depth` outstanding)."""
    ex = ThreadPoolExecutor(max_workers=max(1, workers))
    try:
        dq = collections.deque()
        for item in items:
            dq.append(ex.submit(fn, item))
            if len(dq) >= depth:
                yield dq.popleft().result()
        while dq:
            yield dq.popleft().result()
    finally:
        ex.shutdown(wait=False, cancel_futures=True)


def prefetch_iterator(iterator, depth: int = 2):
    """Wrap `iterator`, producing the same items in the same order, but
    computed ahead in a daemon thread with a `depth`-bounded queue.
    Exceptions in the producer re-raise at the consumption point."""
    q = queue.Queue(maxsize=max(1, depth))
    errors = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 - re-raised in consumer
            errors.append(e)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True, name="ssak-torch-prefetch")
    t.start()
    while True:
        item = q.get()
        if item is _END:
            if errors:
                raise errors[0]
            return
        yield item
