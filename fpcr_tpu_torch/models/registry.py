"""One front door: ``register(source, target, method=...)``.

Counterpart of ``fpcr_tpu/models/registry.py``, every method on the port's
own models, with the JAX package's validation messages and defaults:

    register(src, tgt)                           # exact ICP
    register(src, tgt, method="plane")           # point-to-plane
    register(src, tgt, method="gicp")            # Generalized-ICP
    register(src, tgt, method="ndt")             # NDT init + ICP refine
    register(src, tgt, method="global")          # FPFH+RANSAC init + refine
    register(src, tgt, method="coarse_to_fine")  # large-N pipeline
    register(src, tgt, method="aa")              # Anderson-accelerated
    register(src, tgt, method="sgd")             # stochastic mini-batch

Every method returns an ``ICPResult``-shaped object whose ``transform`` is
the full composed source → target estimate. Extra keyword arguments go into
``ICPConfig`` (e.g. ``matcher="morton"``, ``max_iterations=60``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .icp import ICPConfig, run_icp

METHODS = ("point", "plane", "symmetric", "gicp", "ndt", "global",
           "coarse_to_fine", "aa", "sgd")

_METRIC_METHODS = {"point", "plane", "symmetric", "gicp"}


def register(source, target, method: str = "point",
             config: Optional[ICPConfig] = None, **config_kw):
    """Register ``source`` onto ``target``; see the module docstring.

    ``config`` and ``config_kw`` are mutually exclusive ways to configure
    the underlying loop; the metric methods set ``metric`` themselves."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; one of {METHODS}")
    if config is not None and config_kw:
        raise ValueError("pass either config= or config keywords, not both")
    if "metric" in config_kw:
        raise ValueError(
            "pass the metric as method= (e.g. method='plane'), not metric=")

    if method in _METRIC_METHODS:
        cfg = config or ICPConfig(metric=method, **config_kw)
        if cfg.metric != method:
            cfg = dataclasses.replace(cfg, metric=method)
        return run_icp(source, target, cfg)

    if method == "sgd":
        from .sgd_icp import run_sgd_icp

        if config is not None:
            return run_sgd_icp(source, target, config)
        if config_kw:
            return run_sgd_icp(source, target, ICPConfig(**config_kw))
        # no config: run_sgd_icp's own defaults (200 steps, 1e-5 moving-
        # average tolerance); a plain ICPConfig()'s 40 / 1e-6 stops the
        # stochastic path far from the optimum
        return run_sgd_icp(source, target)

    cfg = config or ICPConfig(**config_kw)
    if method == "ndt":
        from .ndt import register_ndt

        return register_ndt(source, target, cfg)
    if method == "global":
        from .global_reg import register_global

        return register_global(source, target, cfg)
    if method == "coarse_to_fine":
        from .pipeline import icp_coarse_to_fine

        # the coarse stage is brute force on subsets by design; the fine
        # stage keeps an explicitly requested matcher, else the band one
        fine_matcher = (cfg.matcher if ("matcher" in config_kw
                                        or config is not None)
                        else "morton")
        c2f = icp_coarse_to_fine(
            source, target,
            coarse_config=dataclasses.replace(cfg, matcher="xla"),
            fine_config=dataclasses.replace(cfg, matcher=fine_matcher))
        return c2f.fine._replace(transform=c2f.transform)
    from .anderson import run_aa_icp  # method == "aa"

    return run_aa_icp(source, target, cfg)
