"""The decode step's share of its roofline, %: the least time of each
profiled step's work (benchmark/work.py `decode_work` at the step's batch,
rows and cache length, under `bound`) over the device time of every
operation launched inside `Rollout.oar_step`."""

from benchmark import work


def read(t):
    s = t["decode"]
    if s is None or not t["oar_calls"]:
        return None
    us = sum(d for _, d, span in s["ops"] if span == "bench.oar_step")
    if us <= 0:
        return None
    m, dw = t["model"], t["decode_work"]
    bound_ms = sum(work.bound(*work.decode_work(
        dw["name"], m["n_oar_layer"], m["n_embd"], m["n_head"], B, Q, cl,
        dw["kv"]))["bound_ms"] for B, Q, cl in t["oar_calls"])
    return 100.0 * bound_ms / (us / 1e3)
