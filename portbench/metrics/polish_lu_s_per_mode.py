"""polish_lu_s_per_mode: seconds of the host polish's SuperLU
factorization (the program's ``fused_local.polish_step.lu`` phase) over
the window, per mode delivered.  Program span."""


def read(run):
    row = run.report.get("fused_local.polish_step.lu")
    modes = sum(r["modes"] for r in run.records if r["ok"])
    if not row or not modes:
        return None
    return row["total_s"] / modes
