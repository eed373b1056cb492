"""``register_batch`` once a call of ``traffic['batch']`` requests: a
service that registers a fleet's scans together. Every request of a call
gets the call's latency."""

from __future__ import annotations

import torch

from benchmark.rows import pack


class Batched:
    def __init__(self, ft, config, batch, pool, spans) -> None:
        self.ft, self.config, self.pool, self.spans = ft, config, pool, spans
        self.per_call = batch

    def __call__(self, ids):
        idx = torch.from_numpy(ids).to(self.pool.sources.device)
        sources = self.pool.sources.index_select(0, idx)
        targets = self.pool.batch_targets(idx)
        with self.spans("entry"):
            result = self.ft.register_batch(sources, targets, self.config)
        with self.spans("result"):
            return pack(result)


def make(ft, config, traffic, pool, spans):
    return Batched(ft, config, traffic["batch"], pool, spans)
