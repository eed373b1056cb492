"""The readings that the limits of ``correct`` are set from.

    python3 -m benchmark.control --cells <cell,...> --seeds <n> \
        --control-seeds <k> [--first-seed <s>]

For each cell and each of ``n`` seeds the cell's pool is drawn and warmed
as a run's set-up does, its seeded sample of requests (``check_requests``;
``--every``: the whole pool) is registered by the program through the
cell's driver, and each number of ``reference/check.py`` is read against
the float64 reference: the lower readings. For the first ``k`` seeds the
control takes the program's place: the same reference in the step of
precision below the configuration's float32 (TF32 products,
``icp64.TF32``), read against the float64 one: the upper readings. One JSON
line a seed and cell on standard output, and a summary line a cell: each
number's largest program reading and smallest control reading. Nothing
here is run by a benchmark run; it needs the GPU.
"""

from __future__ import annotations

import argparse
import json
import sys


def readings(cell, seed: int, with_control: bool, device: str,
             every: bool = False) -> dict:
    import torch

    import fpcr_tpu_torch as ft

    from benchmark import scenes, traffic, tracing
    from benchmark.reference import check, icp64
    from benchmark.run import warm_up
    from benchmark.spec import load_module

    tr = cell.traffic
    pool = traffic.make_pool(scenes.make_cloud(cell.config["scene"]), tr,
                             device)
    config = ft.ICPConfig(metric=tr["metric"], **cell.config["icp"])
    driver = load_module(cell, "drivers", tr["driver"]).make(
        ft, config, tr, pool, tracing.Spans(False))
    rows = warm_up(driver, len(pool))
    iters = [int(rows[i][12]) for i in range(len(pool))]
    sample = (sorted(rows) if every else
              check.sample(rows, tr["check_requests"], seed))
    del driver
    per = check.each(cell, pool, rows, sample)
    out = {"cell": cell.name, "seed": seed, "pool_iterations": iters,
           "program": check.worst(per), "program_each": per}
    if with_control:
        ctl = {}
        for i in sample:
            reg = icp64.register(pool.sources[i], pool.target(i),
                                 cell.config["icp"], tr["metric"], icp64.TF32)
            ctl[i] = as_row(reg, cell.config["icp"]["max_iterations"])
        per = check.each(cell, pool, ctl, sample)
        out["control"], out["control_each"] = check.worst(per), per
    if device != "cpu":
        torch.cuda.synchronize()
    return out


def as_row(reg, max_iterations: int):
    """A reference registration as the program's host row
    (``benchmark/rows.py``)."""
    import torch

    errors = torch.full((max_iterations,), float("nan"), dtype=torch.float64)
    errors[:len(reg.errors)] = torch.tensor(reg.errors, dtype=torch.float64)
    return torch.cat([reg.rotation.reshape(9).cpu(),
                      reg.translation.reshape(3).cpu(),
                      torch.tensor([float(reg.iterations)],
                                   dtype=torch.float64), errors])


def summary(lines: list) -> dict:
    names = lines[0]["program"].keys()
    out = {"cell": lines[0]["cell"], "seeds": len(lines)}
    for name in names:
        prog = [ln["program"][name] for ln in lines]
        ctl = [ln["control"][name] for ln in lines if "control" in ln]
        out[name] = {"program_max": max(prog), "program_all": prog,
                     "control_min": min(ctl) if ctl else None,
                     "control_all": ctl}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2_400_000_001)
    ap.add_argument("--every", action="store_true",
                    help="read every request of the pool, not the sample")
    args = ap.parse_args(argv)
    import torch

    from benchmark.spec import load_cell

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for name in args.cells.split(","):
        cell = load_cell(name)
        lines = []
        for k in range(args.seeds):
            line = readings(cell, args.first_seed + 7919 * k,
                            k < args.control_seeds, "cuda", args.every)
            print(json.dumps(line), flush=True)
            lines.append(line)
        print(json.dumps({"summary": summary(lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
