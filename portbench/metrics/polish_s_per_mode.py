"""polish_s_per_mode: seconds of the host complex128 polish (the
program's ``fused_local.polish_step`` phase: SuperLU factor and
shift-invert Arnoldi) over the window, per mode delivered.  Program
span."""


def read(run):
    row = run.report.get("fused_local.polish_step")
    modes = sum(r["modes"] for r in run.records if r["ok"])
    if not row or not modes:
        return None
    return row["total_s"] / modes
