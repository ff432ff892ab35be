"""A run with the timed path broken underneath comes out not correct:
one test per fault each cell can have.  The runs skip the look for a
card and drive the rest of a run on the CPU at small sizes."""
from portbench.harness import run_cell

from .conftest import ROOT, small

SEED = 2 ** 31 + 3
MSLP = "rijke7259.mslp_map"


def _run(workload, **solver):
    cfg, mix = small(workload)
    mix["solver"].update(solver)
    return run_cell(workload, SEED, 0.1, False, device="cpu", root=ROOT,
                    cfg=cfg, mix=mix)


def test_sound_run_is_correct():
    r = _run(MSLP)
    assert r["correct"] is True
    assert r["checks"]["off_path"] == {"value": 0, "limit": 0}


def test_mslp_answer_altered(monkeypatch):
    """The eigenvalue altered by 1e-6 where the engine produces it."""
    from wavesandeigenvalues_jl_tpu_torch.nlevp import fused_local, solvers
    orig = fused_local.try_fused_local

    def altered(*a, **k):
        sol, n, flag = orig(*a, **k)
        sol.params[sol.eigval] *= 1 + 1e-6
        return sol, n, flag

    monkeypatch.setattr(solvers, "try_fused_local", altered)
    assert _run(MSLP)["correct"] is False


def test_mslp_step_returns_state_unchanged(monkeypatch):
    """Every Newton step of the device engine returns its state as it
    came: dz = 0 and the carried vectors unchanged."""
    from wavesandeigenvalues_jl_tpu_torch.nlevp import pencil
    orig = pencil.PencilSolver.step

    def unchanged(self, z, carries, sigma, refresh=False):
        _, lam, _, res = orig(self, z, carries, sigma, refresh=refresh)
        return 0.0, lam, carries, res

    monkeypatch.setattr(pencil.PencilSolver, "step", unchanged)
    assert _run(MSLP)["correct"] is False


def test_mslp_handed_to_the_general_engine(monkeypatch):
    """The fused engine hands every solve back, as after a non-finite
    device step: the general engine answers, off the cell's path."""
    from wavesandeigenvalues_jl_tpu_torch.nlevp import solvers
    monkeypatch.setattr(solvers, "try_fused_local", lambda *a, **k: None)
    r = _run(MSLP)
    assert r["checks"]["off_path"]["value"] == r["attempted"] >= 1
    assert r["failed"] == r["attempted"] and r["correct"] is False
