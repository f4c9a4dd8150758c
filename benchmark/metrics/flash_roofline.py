"""Flash attention's share of its roofline, %: the least time of each call's
work (benchmark/work.py `flash_work` under `bound`) over the device time of
the operations launched inside the flash entry, over the traced frame's
cascade."""

from benchmark import work


def read(t):
    s = t["cascade"]
    if s is None or not t["flash_calls"]:
        return None
    us = sum(d for _, d, span in s["ops"] if span == "bench.flash")
    if us <= 0:
        return None
    bound_ms = sum(work.bound(*work.flash_work(B, Sq, Sk, causal, H, Dh))
                   ["bound_ms"] for B, Sq, Sk, causal, H, Dh
                   in t["flash_calls"])
    return 100.0 * bound_ms / (us / 1e3)
