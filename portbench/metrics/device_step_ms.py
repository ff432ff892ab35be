"""device_step_ms: mean wall of one device Newton step of the local
engine (the program's ``fused_local.device_step`` phase; the step ends
when dz reaches the host), over the window.  Program span."""


def read(run):
    row = run.report.get("fused_local.device_step")
    if not row or not row["calls"]:
        return None
    return row["total_s"] / row["calls"] * 1e3
