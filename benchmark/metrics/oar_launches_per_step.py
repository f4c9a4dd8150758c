"""Device operations launched a decode step (the step, its sampler, the
next input's embedding and the agent rules' glue), counted by the profiler
over the traced frame's slice of decode steps."""


def read(t):
    s = t["decode"]
    if s is None or not t["decode_steps"]:
        return None
    return len(s["ops"]) / t["decode_steps"]
