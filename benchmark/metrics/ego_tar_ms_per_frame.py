"""Device milliseconds a frame step spends in the ego net and the TAR
cascade (`UMGen.ego_logits*` + `UMGen.tar_priors*`), from the benchmark's
CUDA-event spans over the traced window's frames."""


def read(t):
    ms = t["spans_ms"]
    if not t["frames"] or not ms.get("ego") or not ms.get("tar"):
        return None
    return (sum(ms["ego"]) + sum(ms["tar"])) / t["frames"]
