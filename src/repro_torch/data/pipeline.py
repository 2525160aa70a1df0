"""Token data pipeline: synthetic corpus + document packing + sharded
host loading (the port's own numpy copy of ``repro/data/pipeline.py``:
the same seed and step give byte-identical batches).

At 1000-node scale each host feeds only its addressable shard of the
global batch; the pipeline is deterministic in (seed, step) so a
restarted/elastically-rescaled job resumes mid-epoch byte-identically
(checkpoint stores only the step counter, not iterator state).

``SyntheticLM`` generates a stationary Zipf token stream with injected
n-gram structure so loss curves are meaningful (a learnable signal, not
uniform noise); ``SyntheticLM.batch`` packs variable-length documents into fixed
(seq_len+1) rows with EOS separators and a loss mask.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    eos_id: int = 2
    zipf_a: float = 1.2
    ngram_repeat: float = 0.5   # P(copy an earlier bigram continuation)


class SyntheticLM:
    """Deterministic synthetic corpus with learnable bigram structure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # fixed random bigram table: each token has a preferred successor
        self.successor = rng.integers(0, v, size=(v,), dtype=np.int64)

    def _doc(self, rng: np.random.Generator, length: int) -> np.ndarray:
        v = self.cfg.vocab_size
        toks = np.empty((length,), np.int64)
        toks[0] = rng.integers(0, v)
        flip = rng.random(length)
        rand = rng.integers(0, v, size=(length,))
        for t in range(1, length):
            if flip[t] < self.cfg.ngram_repeat:
                toks[t] = self.successor[toks[t - 1]]
            else:
                toks[t] = rand[t]
        return toks

    def batch(self, step: int, *, host_id: int = 0, num_hosts: int = 1
              ) -> dict[str, np.ndarray]:
        """Global batch row-sharded over hosts; deterministic in step."""
        cfg = self.cfg
        rows_total = cfg.global_batch
        rows_local = rows_total // num_hosts
        out_tok = np.empty((rows_local, cfg.seq_len), np.int32)
        out_lbl = np.empty((rows_local, cfg.seq_len), np.int32)
        out_mask = np.ones((rows_local, cfg.seq_len), np.float32)
        for r in range(rows_local):
            global_row = host_id * rows_local + r
            rng = np.random.default_rng(
                (cfg.seed, step, global_row))
            row = self._pack_row(rng)
            out_tok[r] = row[:-1]
            out_lbl[r] = row[1:]
            out_mask[r] = (row[1:] != cfg.eos_id).astype(np.float32)
        return {"tokens": out_tok, "labels": out_lbl, "mask": out_mask}

    def _pack_row(self, rng: np.random.Generator) -> np.ndarray:
        """Pack documents into seq_len+1 tokens with EOS separators."""
        cfg = self.cfg
        need = cfg.seq_len + 1
        chunks = []
        total = 0
        while total < need:
            doc_len = int(rng.integers(16, max(17, cfg.seq_len // 2)))
            doc = self._doc(rng, doc_len)
            chunks.append(doc)
            chunks.append(np.array([cfg.eos_id], np.int64))
            total += doc_len + 1
        row = np.concatenate(chunks)[:need]
        return row


def make_data_config(mcfg: ModelConfig, shape: ShapeConfig,
                     seed: int = 0) -> DataConfig:
    return DataConfig(vocab_size=mcfg.vocab_size, seq_len=shape.seq_len,
                      global_batch=shape.global_batch, seed=seed)


def data_iterator(ds: SyntheticLM, start_step: int = 0, *,
                  host_id: int = 0, num_hosts: int = 1
                  ) -> Iterator[dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield ds.batch(step, host_id=host_id, num_hosts=num_hosts)
        step += 1
