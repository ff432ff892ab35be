"""assembly_s: the program's host assembly at set-up — its mesh
constructor on the benchmark's arrays and ``models.helmholtz.discretize``
(the benchmark's own mesh generation is left out).  The harness's span,
host clock."""


def read(run):
    return run.assembly_s
