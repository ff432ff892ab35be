"""setup_s: process start to the first measured request (imports, mesh,
the program's assembly, solver set-up, the warm request and any build or
compile it triggers).  Host clock."""


def read(run):
    return run.setup_s
