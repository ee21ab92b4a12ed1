"""Deterministic sharded token pipeline.

Production properties a 1000-node run needs, implemented without any
external dataset dependency (documents are synthesized from a seeded
PRNG; a real corpus plugs in by replacing ``_synth_document``):

- **host sharding**: host h of H reads only shard slices h, h+H, h+2H…
  so no two hosts ever touch the same document,
- **determinism + resumability**: the iterator state is a single
  ``(epoch, index)`` pair; restoring it replays the exact stream
  (checkpointed alongside model state for exactly-once semantics),
- **sequence packing**: documents are packed into fixed-length rows with
  EOS separators and loss masking across document boundaries — the
  standard trick that keeps MFU independent of document length,
- **WUKONG integration**: ``orchestrator.build_training_workflow``'s
  ``data_fn`` tasks call ``pipeline.batch(step)``; a failed/straggling
  load is retried by the engine like any other task.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    batch_per_host: int
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 0
    eos_id: int = 0
    mean_doc_len: int = 512


def _synth_document(rng: np.random.Generator, cfg: DataConfig) -> np.ndarray:
    n = max(8, int(rng.exponential(cfg.mean_doc_len)))
    # zipf-ish unigram stream, clipped into vocab (never emits EOS)
    toks = rng.zipf(1.3, size=n) % (cfg.vocab - 1) + 1
    return toks.astype(np.int32)


def pack_documents(
    docs: list[np.ndarray], seq_len: int, eos_id: int
) -> tuple[np.ndarray, np.ndarray, list[np.ndarray]]:
    """Pack documents into one row of ``seq_len`` tokens.

    Returns (tokens, loss_mask, leftover_docs). The mask zeroes the
    position after each EOS so loss never crosses a document boundary.
    """
    row = np.empty(seq_len, dtype=np.int32)
    mask = np.ones(seq_len, dtype=np.float32)
    pos = 0
    rest: list[np.ndarray] = []
    for i, doc in enumerate(docs):
        if pos >= seq_len:
            rest.extend(docs[i:])
            break
        take = min(len(doc), seq_len - pos - 1)
        row[pos:pos + take] = doc[:take]
        if take < len(doc):
            rest.append(doc[take:])
            pos += take
            continue
        row[pos + take] = eos_id
        if pos + take + 1 < seq_len:
            mask[pos + take + 1] = 0.0  # next doc's first target
        pos += take + 1
    if pos < seq_len:
        row[pos:] = eos_id
        mask[pos:] = 0.0
    return row, mask, rest


class TokenPipeline:
    """Deterministic, resumable, host-sharded batch stream."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._doc_index = 0
        self._carry: list[np.ndarray] = []

    # -- resumable state -------------------------------------------------
    def state(self) -> dict:
        return {
            "doc_index": self._doc_index,
            "carry": [c.copy() for c in self._carry],
        }

    def restore(self, state: dict) -> None:
        self._doc_index = int(state["doc_index"])
        self._carry = [np.asarray(c, dtype=np.int32)
                       for c in state.get("carry", [])]

    # -- stream ----------------------------------------------------------
    def _doc(self, global_idx: int) -> np.ndarray:
        rng = np.random.default_rng((self.cfg.seed, global_idx))
        return _synth_document(rng, self.cfg)

    def _next_doc(self) -> np.ndarray:
        # host h owns documents h, h+H, h+2H, ...
        gidx = self._doc_index * self.cfg.n_hosts + self.cfg.host_id
        self._doc_index += 1
        return self._doc(gidx)

    def batch(self, step: int | None = None) -> dict[str, np.ndarray]:
        """One (batch_per_host, seq_len) packed batch. If ``step`` is
        given the pipeline first seeks deterministically so workflow
        tasks are idempotent under WUKONG retries."""
        if step is not None:
            # idempotent: derive position purely from step
            self._doc_index = step * self.cfg.batch_per_host * 4
            self._carry = []
        rows, masks = [], []
        for _ in range(self.cfg.batch_per_host):
            while sum(len(d) for d in self._carry) < self.cfg.seq_len:
                self._carry.append(self._next_doc())
            row, mask, self._carry = pack_documents(
                self._carry, self.cfg.seq_len, self.cfg.eos_id)
            rows.append(row)
            masks.append(mask)
        tokens = np.stack(rows)
        labels = np.roll(tokens, -1, axis=1)
        return {
            "tokens": tokens,
            "labels": labels,
            "loss_mask": np.stack(masks),
        }

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        while True:
            yield self.batch()
