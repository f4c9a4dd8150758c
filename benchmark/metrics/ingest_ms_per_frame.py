"""Device milliseconds the chunked ingest spends on one history frame: the
median of the program's `umgen.ingest` spans (CUDA events on its tracer)
over set-up's ingested frames, so that the first, which may build, does
not count."""

import statistics


def read(t):
    setup = t.get("setup") or {}
    ms = [s["device_ms"] for s in setup.get("spans", ())
          if s["name"] == "umgen.ingest" and s["device_ms"] is not None]
    if not ms:
        return None
    return statistics.median(ms)
