"""Deterministic, sharded, resumable data pipeline.

A copy of the JAX package's ``data/pipeline.py``, which is pure numpy:
its batches are the reference's bit for bit. The train step moves them
to the device.

Design rules for 1000+-node training:
  * **stateless addressing** — batch ``i`` for shard ``s`` is a pure
    function of (seed, i, s): any host can reproduce any batch, so restart
    = "set the cursor", and elastic re-sharding = "recompute your shard id"
    (no shared queue, no coordinator);
  * **skip-restore** — the cursor is part of the checkpoint;
  * the synthetic backend draws from numpy's Philox, keyed by the seed
    and addressed by the counter (index, shard) — collision-free and
    identical across hosts; a memmap-file backend covers real token
    corpora with the same addressing contract.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    seed: int = 0

    def batch(self, index: int, shard: int, num_shards: int,
              batch_size: int) -> Dict[str, np.ndarray]:
        """Per-shard slice of global batch ``index`` (tokens + LM labels)."""
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[0, 0, index, shard]))
        toks = rng.integers(0, self.vocab_size,
                            size=(batch_size, self.seq_len + 1),
                            dtype=np.int64).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclasses.dataclass
class FileLMDataset:
    """Memmap-backed token stream with the same (index, shard) addressing."""
    path: str
    vocab_size: int
    seq_len: int

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=np.int32, mode="r")

    def batch(self, index: int, shard: int, num_shards: int,
              batch_size: int) -> Dict[str, np.ndarray]:
        span = batch_size * (self.seq_len + 1)
        stride = num_shards * span
        start = (index * stride + shard * span) % max(
            len(self._data) - span, 1)
        chunk = np.asarray(self._data[start:start + span])
        chunk = chunk.reshape(batch_size, self.seq_len + 1)
        return {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}


class DataPipeline:
    """Cursor + sharding wrapper; checkpointable."""

    def __init__(self, dataset, global_batch: int, shard: int = 0,
                 num_shards: int = 1, start_index: int = 0):
        assert global_batch % num_shards == 0
        self.dataset = dataset
        self.global_batch = global_batch
        self.shard = shard
        self.num_shards = num_shards
        self.index = start_index

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.num_shards

    def next(self) -> Dict[str, np.ndarray]:
        b = self.dataset.batch(self.index, self.shard, self.num_shards,
                               self.local_batch)
        self.index += 1
        return b

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()

    def skip_to(self, index: int) -> None:
        self.index = index

    # -- checkpoint interface --
    def state_dict(self) -> Dict:
        return {"index": self.index, "global_batch": self.global_batch}

    def load_state_dict(self, state: Dict, *, shard: Optional[int] = None,
                        num_shards: Optional[int] = None) -> None:
        """Elastic restore: the cursor is global, so a different shard
        count just re-partitions future batches."""
        self.index = int(state["index"])
        assert state["global_batch"] == self.global_batch
        if shard is not None:
            self.shard = shard
        if num_shards is not None:
            assert self.global_batch % num_shards == 0
            self.num_shards = num_shards
