"""Device milliseconds a frame step spends in the OAR decode
(`Rollout._finish_frame`), from the benchmark's CUDA-event spans over the
traced window's frames."""


def read(t):
    ms = t["spans_ms"].get("oar")
    if not t["frames"] or not ms:
        return None
    return sum(ms) / t["frames"]
