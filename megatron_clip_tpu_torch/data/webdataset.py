"""WebDataset-style tar-shard streaming loader (no external deps).

Counterpart of `megatron_clip_tpu/data/webdataset.py` (open_CLIP's wds
pipeline, open_CLIP/src/training/data.py:327-431):
  - brace-expanded shard url lists ("{00000..00099}.tar", "{a,b}.tar");
  - deterministic epoch-seeded shard shuffle (detshuffle2, data.py:242-273)
    and resampling with per-source upsampling factors (ResampledShards2);
  - per-host and per-worker shard splitting (split_by_node/split_by_worker);
  - sample grouping by key inside each tar (basename before first dot),
    image (jpg/png/ppm/pgm/bmp through `data/decode.py`; webp raises,
    ROADMAP Queue A item 3) + caption (txt/json);
  - JPEGs decoded in PIL's draft mode at the transform's image size, the
    JAX loader's default (`WdsData.draft_size`; MCT_JPEG_DRAFT=0 decodes
    them whole, as it does there);
  - a sample shuffle buffer with the JAX worker's seeds and draws;
  - `with_epoch`-style num_batches/num_samples bookkeeping for resume;
  - decode worker processes, each owning a shard slice and shipping ready
    batches over a queue, drained round-robin in whole batches.

Where the port differs, and why:
  - The shuffle buffer holds the raw samples and an image is decoded when
    its sample leaves the buffer (open_CLIP's order: wds.shuffle before
    wds.decode); the JAX worker decodes first. Both draw the same buffer
    slots, so the batches are the same unless an image is corrupt (JAX
    drops it before the buffer, the port after).
  - `skip_batches` skips a worker's first emitted samples without decoding
    them, after the buffer, where the JAX worker skips raw samples before
    it, and the round-robin resumes at the worker whose turn it was, where
    the JAX loader starts again at worker 0; so a resumed epoch yields
    exactly the batches the uninterrupted one yielded from there on, in
    its order (with no corrupt image among the skipped).
  - Each sample's transform seed is (the worker's seed, its index among the
    worker's emitted samples) (`ImageTransform.__call__`): train crops do
    not depend on the process's `random` state.
  - Worker processes start from a forkserver that has imported this module:
    the trainer's process has CUDA and threads running, which a fork would
    copy mid-state. The workers run numpy and the standard library only.
    `stop_workers` ends the workers, the forkserver and multiprocessing's
    resource tracker and waits for them; it runs at exit, so the process
    leaves none of them behind.
  - A worker's exception is sent to the consumer and raised there, so a
    shard of images the port cannot decode stops the run.
"""
import atexit
import gc
import json
import multiprocessing as mp
import os
import queue
import random
import re
import tarfile
import threading
import traceback
import weakref
from typing import Callable, Iterator, List, Optional

import numpy as np

from megatron_clip_tpu_torch.data.decode import decode_image

_IMG_EXTS = ("jpg", "jpeg", "png", "webp", "ppm", "pgm", "bmp")
_TXT_EXTS = ("txt", "text", "caption")
SHUFFLE_BUFFER = 2000


def brace_expand(spec: str) -> List[str]:
    """Expand {000..099} ranges (zero-padded) and {a,b,c} alternatives."""
    m = re.search(r"\{(\d+)\.\.(\d+)\}", spec)
    if m:
        lo, hi = m.group(1), m.group(2)
        width = len(lo)
        out = []
        for i in range(int(lo), int(hi) + 1):
            out.extend(brace_expand(spec[:m.start()] + str(i).zfill(width)
                                    + spec[m.end():]))
        return out
    m = re.search(r"\{([^{}]*,[^{}]*)\}", spec)
    if m:
        out = []
        for alt in m.group(1).split(","):
            out.extend(brace_expand(spec[:m.start()] + alt + spec[m.end():]))
        return out
    return [spec]


def expand_urls(urls) -> List[str]:
    """'::'-separated multi-source spec, each brace-expanded (data.py:36-55)."""
    if isinstance(urls, str):
        urls = urls.split("::")
    out = []
    for u in urls:
        out.extend(brace_expand(u))
    return out


def expand_urls_with_weights(urls, weights):
    """Per-source sample weights for '::'-separated specs (open_CLIP
    --train-data-upsampling-factors, data.py expand_urls): each source's
    weight is repeated over its brace-expanded shards."""
    if isinstance(urls, str):
        urls = urls.split("::")
    if isinstance(weights, str):
        weights = [float(w) for w in weights.split("::")]
    if len(weights) != len(urls):
        raise ValueError(f"{len(weights)} upsampling factors for "
                         f"{len(urls)} '::'-separated sources")
    shards, shard_weights = [], []
    for u, w in zip(urls, weights):
        ex = brace_expand(u)
        shards.extend(ex)
        shard_weights.extend([float(w)] * len(ex))
    return shards, shard_weights


def iterate_tar_samples(path: str) -> Iterator[dict]:
    """Group tar members into samples keyed by basename-before-first-dot."""
    with tarfile.open(path, mode="r|*") as tf:
        current_key, sample = None, {}
        for member in tf:
            if not member.isfile():
                continue
            name = os.path.basename(member.name)
            if "." not in name:
                continue
            key, ext = name.split(".", 1)
            ext = ext.lower()
            if key != current_key:
                if sample:
                    yield sample
                current_key, sample = key, {"__key__": key}
            fobj = tf.extractfile(member)
            if fobj is not None:
                sample[ext] = fobj.read()
        if sample:
            yield sample


def sample_parts(sample: dict):
    """-> (image bytes, caption str), or None if the sample lacks either;
    the JAX `decode_sample`'s choice of entries, before the decode."""
    img_bytes = txt = None
    for ext, val in sample.items():
        if ext.startswith("__"):
            continue
        if ext in _IMG_EXTS:
            img_bytes = val
        elif ext in _TXT_EXTS:
            txt = val.decode("utf-8", errors="replace")
        elif ext == "json":
            try:
                j = json.loads(val)
            except ValueError:
                continue
            if isinstance(j, dict):
                txt = j.get("caption") or j.get("text") or txt
    if img_bytes is None or txt is None:
        return None
    return img_bytes, txt


def split_by_node(shards: List[str], rank: int, world_size: int) -> List[str]:
    """Per-host shard slice (open_CLIP data.py split_by_node semantics:
    node r takes shards[r::world_size])."""
    if world_size <= 1:
        return list(shards)
    return list(shards[rank::world_size])


def split_by_worker(shards: List[str], worker_id: int,
                    num_workers: int) -> List[str]:
    """Per-dataloader-worker shard slice within a host."""
    if num_workers <= 1:
        return list(shards)
    return list(shards[worker_id::num_workers])


def worker_context():
    """The multiprocessing context of the decode workers: a forkserver that
    imports this module before it forks a worker. Starts the server if it
    is not running (it then imports in the background), so a caller can
    start it early, beside other set-up work."""
    global _stop_registered
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])
    from multiprocessing import forkserver
    if not _stop_registered:
        atexit.register(stop_workers)
        _stop_registered = True
    forkserver.ensure_running()
    return ctx


_workers: "weakref.WeakSet" = weakref.WeakSet()
_stop_registered = False


def stop_workers() -> None:
    """Ends every decode worker still alive, then the forkserver and
    multiprocessing's resource tracker, and waits for each to exit. The
    tracker goes last: it exits when every holder of its pipe (the server
    and the workers forked from it) has gone. A later `worker_context`
    starts the server and the tracker again."""
    from multiprocessing import forkserver, resource_tracker
    for p in list(_workers):
        if p.is_alive():
            p.terminate()
        p.join()
    gc.collect()  # the queues' semaphores leave the tracker's books first
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


class _StopWorker(Exception):
    """Raised inside an inline (thread) worker when the consumer is gone."""


class _WorkerError:
    """A worker's exception, as it reaches the consumer."""

    def __init__(self, exc: BaseException):
        self.not_implemented = isinstance(exc, NotImplementedError)
        self.text = "".join(traceback.format_exception(exc))

    def raise_(self):
        kind = NotImplementedError if self.not_implemented else RuntimeError
        raise kind(f"decode worker failed:\n{self.text}")


def _qput(out_q, item, stop):
    """out_q.put that stays responsive to a consumer-side stop event —
    threads can't be terminated, so an inline worker blocked on a full
    queue would otherwise live (holding its shuffle buffer) forever."""
    if stop is None:
        out_q.put(item)
        return
    while True:
        if stop.is_set():
            raise _StopWorker
        try:
            out_q.put(item, timeout=0.5)
            return
        except queue.Full:
            continue


def _worker_loop(shards, seed, shuffle, shuffle_buffer, preprocess,
                 tokenizer, context_length, batch_size, out_q,
                 skip_samples: int = 0, stop=None, draft_size=None):
    """Decode worker: stream its shard slice through the shuffle buffer
    (raw samples), skip its first `skip_samples` emitted samples undecoded,
    decode (JPEGs at `draft_size`, see `decode_image`) and preprocess the
    rest (sample n with the transform seed (seed << 32) + n) and emit ready
    (images, texts) batches. Runs in a separate process or inline in a
    thread. `stop` (inline thread workers only): event the consumer sets
    when it exits early; every queue put watches it. Ends with None, after
    a `_WorkerError` if it failed."""
    rng = random.Random(seed)
    imgs, caps = [], []
    emitted = 0

    def emit(parts):
        nonlocal emitted, imgs, caps
        n, emitted = emitted, emitted + 1
        if n < skip_samples:
            return
        img = decode_image(parts[0], draft_size)
        if img is None:
            return
        imgs.append(preprocess(img, (seed << 32) + n))
        caps.append(parts[1])
        if len(imgs) == batch_size:
            _qput(out_q, (np.stack(imgs),
                          np.asarray(tokenizer(caps, context_length),
                                     np.int32)), stop)
            imgs, caps = [], []

    try:
        buf = []
        for shard in shards:
            for raw in iterate_tar_samples(shard):
                parts = sample_parts(raw)
                if parts is None:
                    continue
                if not shuffle:
                    emit(parts)
                    continue
                buf.append(parts)
                if len(buf) < shuffle_buffer:
                    continue
                i = rng.randrange(len(buf))
                buf[i], item = buf[-1], buf[i]
                buf.pop()
                emit(item)
        if shuffle:
            rng.shuffle(buf)
        for parts in buf:
            emit(parts)
    except _StopWorker:
        return
    except Exception as e:  # noqa: BLE001 — sent to the consumer, raised there
        try:
            _qput(out_q, _WorkerError(e), stop)
        except _StopWorker:
            return
    try:
        _qput(out_q, None, stop)
    except _StopWorker:
        pass


class WdsData:
    """Shard-streaming (image, caption) batch iterator.

    rank/world_size split shards per host (split_by_node); `workers` > 1
    starts decode processes each owning a worker shard slice. `preprocess`
    is called as preprocess(image, seed) (see the module's note)."""

    def __init__(self, urls, batch_size: int, preprocess: Callable,
                 tokenizer: Callable, *, num_samples: Optional[int] = None,
                 seed: int = 0, context_length: int = 77, workers: int = 2,
                 shuffle: bool = True, shuffle_buffer: int = SHUFFLE_BUFFER,
                 resampled: bool = False, rank: int = 0, world_size: int = 1,
                 upsampling_factors=None):
        if upsampling_factors is not None:
            if not resampled:
                raise ValueError("--train-data-upsampling-factors is only "
                                 "supported with --dataset-resampled "
                                 "(open_CLIP data.py has the same assert)")
            self.all_shards, self.shard_weights = expand_urls_with_weights(
                urls, upsampling_factors)
        else:
            self.all_shards = expand_urls(urls)
            self.shard_weights = None
        if resampled:
            # ResampledShards2 (data.py:274-326) does NOT split by node:
            # sampling WITH replacement from the full list is already
            # balanced
            self.shards = list(self.all_shards)
        else:
            self.shards = split_by_node(self.all_shards, rank, world_size)
        if not self.shards:
            raise ValueError(f"no shards from {urls!r} "
                             f"(rank {rank}/{world_size})")
        if num_samples is None:
            # open_CLIP requires --train-num-samples when metadata is absent
            # (data.py:344-352); estimate by counting one shard, scaled by
            # the full shard list (num_samples is the GLOBAL count)
            probe = sum(1 for _ in iterate_tar_samples(self.shards[0]))
            num_samples = probe * len(self.all_shards)
        self.num_samples = num_samples
        self.batch_size = batch_size
        # per-host batch count (open_CLIP data.py:386-398 round_fn over
        # world_size; num_samples is the global count)
        self.num_batches = max(1, num_samples // (batch_size
                                                  * max(world_size, 1)))
        self.preprocess = preprocess
        self.tokenizer = tokenizer
        self.context_length = context_length
        self.seed = seed
        self.epoch = 0
        self.rank = rank
        self.world_size = max(world_size, 1)
        self.shuffle = shuffle
        self.shuffle_buffer = shuffle_buffer
        self.workers = max(1, workers)
        self.resampled = resampled
        # the JAX loader's JPEG draft decode (webdataset.py:317-320): the
        # smallest libjpeg scale still covering the training resolution
        self.draft_size = (None if os.environ.get("MCT_JPEG_DRAFT", "1") == "0"
                           else getattr(preprocess, "image_size", None))
        self._skip_batches = 0

    def skip_batches(self, n: int) -> None:
        """Fast-forward the NEXT epoch iteration by n batches without
        decoding (mid-epoch resume); the epoch yields num_batches - n
        batches, the ones the uninterrupted epoch yielded after n."""
        self._skip_batches = max(0, int(n))

    def set_epoch(self, epoch: int) -> None:
        """Sync the shard-order/seed epoch on resume (detshuffle2's
        epoch-keyed determinism, data.py:242-273): a restart into epoch N
        must shuffle with seed+N, not seed+0."""
        self.epoch = int(epoch)

    def _epoch_shards(self) -> List[str]:
        if self.resampled:
            # ResampledShards2 semantics (data.py:274-326): each rank draws
            # its epoch's shards WITH replacement from the FULL list
            # (rank-keyed rng so ranks differ); per-source weights implement
            # --train-data-upsampling-factors
            rng = random.Random((self.seed + self.epoch) * 1000003
                                + self.rank)
            k = max(1, len(self.shards) // self.world_size)
            if self.shard_weights is not None:
                shards = rng.choices(self.shards,
                                     weights=self.shard_weights, k=k)
            else:
                shards = [rng.choice(self.shards) for _ in range(k)]
        else:
            # detshuffle2 semantics: shard order = f(seed, epoch), same on
            # every host (data.py:242-273)
            shards = list(self.shards)
            if self.shuffle:
                random.Random(self.seed + self.epoch).shuffle(shards)
        self.epoch += 1
        return shards

    def __iter__(self):
        shards = self._epoch_shards()
        n_workers = min(self.workers, len(shards))
        base_seed = self.seed * 100003 + self.epoch
        skip_b, self._skip_batches = self._skip_batches, 0
        # the consumer below drains workers round-robin in WHOLE batches,
        # so the original run consumed ceil((skip_b - w) / nw) batches from
        # worker w: skip exactly those samples per worker
        nw = max(n_workers, 1)
        skips = [self.batch_size * max(0, -(-(skip_b - w) // nw))
                 for w in range(nw)]
        common = (self.preprocess, self.tokenizer, self.context_length,
                  self.batch_size)

        stop_evt, procs = None, []
        if n_workers <= 1:
            # inline: one background thread keeps decode off the train loop
            q: "queue.Queue" = queue.Queue(maxsize=8)
            stop_evt = threading.Event()
            threading.Thread(
                target=_worker_loop,
                args=(shards, base_seed, self.shuffle, self.shuffle_buffer,
                      *common, q, skips[0], stop_evt, self.draft_size),
                daemon=True).start()
            queues = [q]
        else:
            ctx = worker_context()
            queues = []
            for w in range(n_workers):
                wq = ctx.Queue(maxsize=4)
                p = ctx.Process(
                    target=_worker_loop,
                    args=(split_by_worker(shards, w, n_workers),
                          base_seed + w, self.shuffle,
                          max(1, self.shuffle_buffer // n_workers),
                          *common, wq, skips[w], None, self.draft_size),
                    daemon=True)
                p.start()
                _workers.add(p)
                queues.append(wq)
                procs.append(p)

        # the uninterrupted epoch's next batch comes from worker skip_b % nw
        produced, w, live = 0, skip_b % len(queues), len(queues)
        target = max(0, self.num_batches - skip_b)
        alive = [True] * len(queues)
        try:
            while produced < target and live > 0:
                if not alive[w]:
                    w = (w + 1) % len(queues)
                    continue
                item = queues[w].get()
                if isinstance(item, _WorkerError):
                    item.raise_()
                if item is None:
                    alive[w] = False
                    live -= 1
                else:
                    produced += 1
                    yield item
                w = (w + 1) % len(queues)
        finally:
            # an early-exiting consumer (break at total_steps, exception,
            # or simply target reached while workers still stream) must not
            # leave decode processes blocked on queue.put
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=10)
            if stop_evt is not None:
                # inline thread worker: signal it and drain its queue so a
                # blocked put wakes promptly (threads can't be terminated)
                stop_evt.set()
                try:
                    while True:
                        queues[0].get_nowait()
                except queue.Empty:
                    pass
            for q_ in queues:
                if hasattr(q_, "cancel_join_thread"):
                    q_.cancel_join_thread()
