"""bj_refresh_s_per_mode: seconds of the dense engine's host block-Jacobi
refresh (every span of the program whose last path element is
``bj_refresh``: inside a step's ``coefficients`` or at request level) over
the window, per mode delivered.  Program span."""

SPAN = "bj_refresh"


def read(run):
    total = sum(row["total_s"] for path, row in run.report.items()
                if path.rsplit(".", 1)[-1] == SPAN)
    modes = sum(r["modes"] for r in run.records if r["ok"])
    if not total or not modes:
        return None
    return total / modes
