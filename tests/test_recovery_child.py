"""Recovery against a REAL killed render-client process (CPU backend).

The in-suite variant of tools/loop_recovery_smoke.py: the loop's recover
hook must heal from an actual SIGKILLed child process (worker death), not
just an injected exception — worker/distributed/main.go:160-185's
re-registration semantics. The on-hardware variant (killing a real
accelerator client) is the tool's __main__."""

from tools.loop_recovery_smoke import run_smoke


def test_child_kill_recovery_cpu():
    ok, detail = run_smoke(
        w=64, h=48, n_ticks=16, kill_at=4,
        env={"DRT_CHILD_PLATFORM": "cpu", "JAX_PLATFORMS": "cpu"},
        log=lambda *a: None)
    assert ok, detail
