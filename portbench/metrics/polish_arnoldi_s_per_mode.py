"""polish_arnoldi_s_per_mode: seconds of the host polish's two
shift-invert Arnoldi runs a step (the program's
``fused_local.polish_step.arnoldi`` phase) over the window, per mode
delivered.  Program span."""


def read(run):
    row = run.report.get("fused_local.polish_step.arnoldi")
    modes = sum(r["modes"] for r in run.records if r["ok"])
    if not row or not modes:
        return None
    return row["total_s"] / modes
