"""Mean seconds per solve of its assembly (planes where the request
assembles them, load vector, Dirichlet fix), host clock ending in a
synchronise; traced run."""


def read(run):
    v = run.spans.get("assembly")
    return sum(v) / len(v) if v else None
