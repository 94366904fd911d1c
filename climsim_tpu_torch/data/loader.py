"""Batch iterators: the time-chunked autoregressive loader and device
prefetch (counterpart of ``climsim_tpu/data/loader.py``).

Chunks are CONTIGUOUS time steps (the memory threads through them in
order) while the chunk order is shuffled per epoch by
``np.random.default_rng(seed)``, exactly as the JAX package draws it, so
both packages visit the same chunks. A series held as tensors (the
training CLI's device cache) is chunked where it lives: on the card a
chunk is a view of the cached series, and only the previous-step channels
are gathered into a new tensor there; numpy series stay numpy.

``stream_keeplev_chunks`` reads chunks from a store in a background
thread through a bounded queue; ``prefetch_to_device`` copies host chunks
(pinned) to the card on a side stream, ahead of their use.
"""
from __future__ import annotations

import queue as _queue
import threading
from typing import Iterator

import numpy as np
import torch

from ..ops import resolve_device


def chunkize(n_steps: int, chunk_size: int, rng: np.random.Generator,
             shuffle: bool = True) -> list[np.ndarray]:
    """Split [0..n_steps) into contiguous chunks; shuffle chunk order
    only."""
    starts = np.arange(0, n_steps - chunk_size + 1, chunk_size)
    if shuffle:
        rng.shuffle(starts)
    return [np.arange(s, s + chunk_size) for s in starts]


def _cat(parts):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=-1)
    return np.concatenate(parts, axis=-1)


def keeplev_chunks(x_lev, x_sfc, y_lev, y_sfc, sp, chunk_size: int,
                   seed: int = 0, shuffle: bool = True,
                   include_prev_inputs: int = 0,
                   include_prev_outputs: int = 0) -> Iterator[dict]:
    """Yield time-contiguous chunk dicts from time-major arrays or tensors
    [T, B, ...].

    ``include_prev_inputs``/``include_prev_outputs`` concatenate the first
    N level channels of the PREVIOUS timestep's inputs/outputs onto each
    step's level inputs (outputs first). Chunks then start at t >= 1 so
    every step has a predecessor.
    """
    rng = np.random.default_rng(seed)
    offset = 1 if (include_prev_inputs or include_prev_outputs) else 0
    for idx in chunkize(x_lev.shape[0] - offset, chunk_size, rng, shuffle):
        lo = int(idx[0]) + offset
        cur, prev = slice(lo, lo + chunk_size), slice(lo - 1,
                                                      lo - 1 + chunk_size)
        xl = x_lev[cur]
        if include_prev_outputs:
            xl = _cat([xl, y_lev[prev][..., :include_prev_outputs]])
        if include_prev_inputs:
            xl = _cat([xl, x_lev[prev][..., :include_prev_inputs]])
        yield {"x_lev": xl, "x_sfc": x_sfc[cur], "y_lev": y_lev[cur],
               "y_sfc": y_sfc[cur], "sp": sp[cur]}


def _threaded(produce, maxsize: int) -> Iterator:
    """Yield what ``produce(put)`` puts, from a background thread through
    a queue of ``maxsize``; an error in the thread is raised here, and
    closing the generator stops the thread."""
    q: _queue.Queue = _queue.Queue(maxsize=max(1, maxsize))
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    def run():
        try:
            produce(put)
            put(done)
        except BaseException as e:     # handed to the consumer, raised there
            put(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    try:
        while True:
            item = q.get()
            if item is done:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        th.join()


def stream_keeplev_chunks(read_rows, n_steps: int, ncol: int,
                          chunk_size: int, *, seed: int = 0,
                          shuffle: bool = True,
                          include_prev_inputs: int = 0,
                          include_prev_outputs: int = 0,
                          transform=None, raw_transform=None,
                          prefetch: int = 2, to_device: bool = False,
                          device=None, t_start: int = 0,
                          t_stop: int | None = None) -> Iterator[dict]:
    """Out-of-core chunk stream with bounded host memory.

    ``read_rows(start_row, stop_row)`` fetches flattened (time x col) rows
    (``KeeplevReader.load_slice``) as the keeplev dict {input_lev,
    input_sca, output_lev, output_sca}. Chunks are time-contiguous in
    shuffled order; a background thread reads and transforms chunk k+1
    while chunk k trains, ``prefetch`` chunks at most ahead, and with
    ``to_device`` ``prefetch_to_device`` copies them to ``device``
    (None: the card) on a side stream.

    ``transform(x_lev, x_sfc, y_lev, y_sfc) -> dict`` applies the feature
    chain per chunk ([cs, B, ...] arrays, previous-step channels already
    attached); by default sp = x_sfc[..., 0]. ``raw_transform(xl, xs, yl,
    ys, offset) -> dict`` instead receives the full window [cs + offset,
    B, ...] and owns the whole assembly. ``t_start``/``t_stop`` restrict
    the stream to a step range.
    """
    rng = np.random.default_rng(seed)
    offset = 1 if (include_prev_inputs or include_prev_outputs) else 0
    t_stop = n_steps if t_stop is None else min(t_stop, n_steps)
    span = t_stop - t_start - offset
    starts = [int(i[0]) + t_start + offset
              for i in chunkize(span, chunk_size, rng, shuffle)]

    def default_transform(xl, xs, yl, ys):
        return {"x_lev": xl, "x_sfc": xs, "y_lev": yl, "y_sfc": ys,
                "sp": xs[..., 0]}

    tf = transform if transform is not None else default_transform

    def produce(put):
        for t0 in starts:
            d = read_rows((t0 - offset) * ncol, (t0 + chunk_size) * ncol)
            resh = lambda a: np.asarray(a).reshape(
                (chunk_size + offset, ncol) + a.shape[1:])
            xl, xs = resh(d["input_lev"]), resh(d["input_sca"])
            yl, ys = resh(d["output_lev"]), resh(d["output_sca"])
            if raw_transform is not None:
                out = raw_transform(xl, xs, yl, ys, offset)
            else:
                xl_c = xl[offset:]
                if include_prev_outputs:
                    xl_c = _cat([xl_c, yl[:-1][..., :include_prev_outputs]])
                if include_prev_inputs:
                    xl_c = _cat([xl_c, xl[:-1][..., :include_prev_inputs]])
                out = tf(xl_c, xs[offset:], yl[offset:], ys[offset:])
            if not put(out):
                return

    host = _threaded(produce, prefetch)
    if to_device:
        yield from prefetch_to_device(host, prefetch, device)
    else:
        yield from host


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def prefetch_to_device(iterator, size: int = 2, device=None):
    """Copy each item of ``iterator`` (a dict, tuple or list of numpy
    arrays or tensors) to ``device`` ahead of its use: a background thread
    pins the host arrays and starts ``non_blocking`` copies on a side
    stream, at most ``size`` items ahead; the consumer's stream waits on
    each item's copy before it is yielded. ``device=None`` means the card
    (and raises without one); on the CPU the items become tensors. An
    error in the thread (or the iterator) is raised in the consumer."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    side = torch.cuda.Stream(dev) if cuda else None

    def host_tensor(a):
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
        return t.pin_memory() if cuda and t.device.type == "cpu" else t

    def produce(put):
        for item in iterator:
            item = _map(host_tensor, item)
            if not cuda:
                if not put((item, None)):
                    return
                continue
            with torch.cuda.stream(side):
                moved = _map(lambda t: t.to(dev, non_blocking=True), item)
                ev = torch.cuda.Event()
                ev.record(side)
            if not put((moved, ev)):
                return

    for moved, ev in _threaded(produce, size):
        if ev is not None:
            cur = torch.cuda.current_stream(dev)
            cur.wait_event(ev)
            for t in _leaves(moved):
                # the side stream allocated it; the caller's uses it
                t.record_stream(cur)
        yield moved


def flat_batches(x, y, batch_size: int, seed: int = 0,
                 shuffle: bool = True, drop_remainder: bool = True):
    """Shuffled minibatch iterator over flat arrays or tensors (the
    offline baselines' path), the order drawn by
    ``np.random.default_rng(seed)`` as the JAX package draws it. Tensors
    are cut where they live: the permutation is copied to their device
    once, and each batch is gathered there; unshuffled batches are
    slices."""
    n = x.shape[0]
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
        if isinstance(x, torch.Tensor):
            idx = torch.as_tensor(idx, device=x.device)
    stop = n - batch_size + 1 if drop_remainder else n
    for i in range(0, stop, batch_size):
        j = idx[i:i + batch_size] if shuffle else slice(i, i + batch_size)
        yield x[j], y[j]
