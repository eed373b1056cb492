"""How often a ``torch.profiler`` session loses device events.

Sessions of ten Kernel S ``keep`` launches at N = M = 16,384 (E3's
operands), bare and between two ``torch.cuda._sleep`` spin kernels, are
taken in turns for a given time; for each kind the script prints how many
sessions reported every launch, fewer, or none. ``chip_smoke.py``'s
``device_events`` pads its sessions with spin kernels because of what this
counts.

Run on the card: ``python -m fpcr_tpu_torch.bench.profiler_sessions
[seconds]``.
"""
import json
import sys
import time

import torch

LAUNCHES = 10


def session(fn, pad_cycles):
    """(events of ``fn``, spin-kernel events) in one profiler session."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if pad_cycles:
            torch.cuda._sleep(pad_cycles)
        fn()
        if pad_cycles:
            torch.cuda._sleep(pad_cycles)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    spins = sum("spin_kernel" in s for s in names)
    return len(names) - spins, spins


def main(seconds: float = 60.0, pad_cycles: int = 100_000) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profiler_sessions needs a CUDA device")
    from ..ops.split import split_operands
    from ..ops.split_cuda import split_nn_cuda
    from .reduction2 import study_inputs

    src, tgt = study_inputs(torch.device("cuda"))
    n = m = src.shape[0]
    keep = (m // 8192 - 1) * 8192
    p_in, q_in = split_operands(src, tgt, 6, n, m)

    def fn():
        for _ in range(LAUNCHES):
            split_nn_cuda(p_in, q_in, n, m, "keep", keep=keep)

    fn()
    torch.cuda.synchronize()
    seen = {"bare": [], "padded": []}
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        seen["bare"].append(session(fn, 0)[0])
        seen["padded"].append(session(fn, pad_cycles)[0])
    # the events of a whole session: the most any session saw
    expected = max(max(v) for v in seen.values())
    out = {"kernel events a whole session": expected,
           "pad_cycles": pad_cycles,
           "device": torch.cuda.get_device_name(0)}
    for kind, counts in seen.items():
        out[kind] = {"sessions": len(counts),
                     "whole": sum(c >= expected for c in counts),
                     "short": sum(0 < c < expected for c in counts),
                     "empty": sum(c == 0 for c in counts),
                     "events": {str(c): counts.count(c)
                                for c in sorted(set(counts))}}
    return out


if __name__ == "__main__":
    print(json.dumps(main(*(float(a) for a in sys.argv[1:2]))))
