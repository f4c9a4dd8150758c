"""The device's idle share of a frame step, %: 1 − the device's busy
seconds a frame over the frame's ego, TAR and OAR spans.  The busy seconds
are the union of the device operations' intervals in the profiled cascade
plus those of the profiled slice of decode steps scaled to the frame's
decode calls; the spans' device-clock milliseconds come from the unprofiled
window, so the profiler's own host time, which stretches each traced decode
step, counts in neither."""


def read(t):
    c, d, ms = t["cascade"], t["decode"], t["spans_ms"]
    if c is None or d is None or not t["decode_steps"] or not ms.get("oar"):
        return None
    wall = sum(sum(ms.get(n, ())) for n in ("ego", "tar", "oar")) \
        / len(ms["oar"]) / 1e3
    busy = c["busy_s"] + t["decode_calls"] / t["decode_steps"] * d["busy_s"]
    if wall <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / wall)
