"""modes_per_s: converged eigenvalues delivered over the whole window's
wall.  Host clock."""


def read(run):
    return sum(r["modes"] for r in run.records if r["ok"]) / run.window_s
