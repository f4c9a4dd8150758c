"""Host milliseconds a decode step spends in its glue (the program's
`umgen.glue` span: the head, the sampler, the agent rules and the next
input's embedding), summed over the traced frame's decode steps that ran
outside the profiler, over those steps: the frame's decode steps counted
by the program (`oar_steps.*`) less the profiled slice's."""


def read(t):
    prog = t.get("program")
    if not prog:
        return None
    steps = sum(n for c in prog["counters"].values() for k, n in c.items()
                if k.startswith("oar_steps."))
    steps -= sum(1 for _, Q, _ in t["oar_calls"] if Q == 1)
    ms = sum(s["end_ns"] - s["start_ns"] for s in prog["spans"]
             if s["name"] == "umgen.glue" and not s["profiled"]) / 1e6
    if steps <= 0 or ms <= 0:
        return None
    return ms / steps
