"""Device operations a decode step launches from its glue: the operations
of the traced frame's slice of decode steps whose launch lies inside the
program's `umgen.glue` span, over the slice's steps.  With those inside
`umgen.oar_step` and the rest (the segment ends' embeddings) they make up
`oar_launches_per_step`."""


def read(t):
    s = t["decode"]
    if s is None or not t["decode_steps"]:
        return None
    n = sum(1 for names in s["program"] if "umgen.glue" in names)
    if n == 0:
        return None
    return n / t["decode_steps"]
