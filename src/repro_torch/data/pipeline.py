"""Deterministic synthetic LM data pipeline, per-host sharded and resumable
(a copy of ``repro.data.pipeline``: numpy only, its batches bit-equal to
the reference's).

A real deployment would plug a tokenized corpus reader here; the interface
is what matters: per-host sharding (each data-parallel host reads only its
slice), deterministic regeneration from (seed, step) so restarts resume
exactly, and state small enough to live in every checkpoint.  The
synthetic stream is a Zipf-ish unigram mixture with Markov structure so
the LM loss actually decreases during training.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    frontend: Optional[str] = None     # "vision"/"audio": adds stub embeds
    frontend_tokens: int = 0
    d_model: int = 0


@dataclasses.dataclass
class DataState:
    step: int = 0


class SyntheticLM:
    """Markov-chain token stream: next ~ P(.|cur) with banded transitions."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.local_batch = cfg.global_batch // cfg.n_hosts
        self.state = DataState()

    def _batch_rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, self.cfg.host_id]))

    def next_batch(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self._batch_rng(self.state.step)
        b, t, v = self.local_batch, cfg.seq_len, cfg.vocab
        # banded Markov structure: next token near 2*cur mod v, noised
        cur = rng.integers(0, v, size=(b,))
        toks = np.empty((b, t + 1), np.int32)
        toks[:, 0] = cur
        noise = rng.integers(-3, 4, size=(b, t))
        jump = rng.random((b, t)) < 0.1
        jumps = rng.integers(0, v, size=(b, t))
        for i in range(t):
            cur = (2 * cur + 1 + noise[:, i]) % v
            cur = np.where(jump[:, i], jumps[:, i], cur)
            toks[:, i + 1] = cur
        batch = {"tokens": toks}
        if cfg.frontend in ("vision", "audio") and cfg.frontend_tokens:
            batch["prefix_embeds" if cfg.frontend == "vision" else
                  "frames"] = rng.standard_normal(
                (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
        self.state.step += 1
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    # --- checkpointable state -------------------------------------------
    def state_dict(self) -> Dict:
        return {"step": self.state.step}

    def load_state_dict(self, d: Dict) -> None:
        self.state.step = int(d["step"])
