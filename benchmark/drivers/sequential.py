"""``run_icp`` once a request, one request at a time: a caller that waits
for each pose before it sends the next scan (scan-to-scan odometry,
scan-to-map tracking).

Traced, the target's normals (point-to-plane) and the Morton tables (the
band matcher) are built here, each in a span of its own, by the calls that
``run_icp``'s set-up makes, and handed to ``run_icp``: the same work, the
same graphs, split so that it can be timed."""

from __future__ import annotations

from benchmark.rows import pack

NORMAL_METRICS = ("plane", "symmetric", "gicp")


class Sequential:
    per_call = 1

    def __init__(self, ft, config, pool, spans) -> None:
        from fpcr_tpu_torch.models.icp import build_matcher_state

        self.ft, self.config, self.pool, self.spans = ft, config, pool, spans
        self.build_matcher_state = build_matcher_state

    def __call__(self, ids):
        i = int(ids[0])
        cfg = self.config
        source, target = self.pool.sources[i], self.pool.target(i)
        kw = {}
        if self.spans.enabled and cfg.metric in NORMAL_METRICS:
            with self.spans("normals"):
                kw["target_normals"] = self.ft.estimate_normals(
                    target, k=cfg.k_neighbors, chunk=cfg.source_chunk,
                    tile=cfg.target_tile,
                    banded_threshold=cfg.normals_banded_threshold)
        if self.spans.enabled and cfg.matcher == "morton":
            with self.spans("table"):
                kw["matcher_state"] = self.build_matcher_state(
                    target, None, cfg, kw.get("target_normals"))
        with self.spans("entry"):
            result = self.ft.run_icp(source, target, cfg, **kw)
        with self.spans("result"):
            return pack(result)


def make(ft, config, traffic, pool, spans):
    return Sequential(ft, config, pool, spans)
