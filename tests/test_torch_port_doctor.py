"""The port's `doctor` (`deep_staple_torch/doctor.py`), the counterpart of
`tests/test_cli.py::test_doctor_cli_cpu_environment`.

On a machine without a CUDA card (as the CPU test runs), the doctor exits 1
and says that only the `--device cpu` paths are usable; every device probe
runs in a subprocess with `--timeout`. Its exit status otherwise: 0 only
when the card, nvcc, the kernel build and the mesh probe (two gloo ranks on
the CPU) pass.
"""

import os
import subprocess
import sys

import pytest

from deep_staple_torch import doctor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKS = ("python", "torch / CUDA build", "numpy", "scipy", "CUDA card",
          "nvidia-smi name, power limit", "nvcc", "kernel build (sm_90a)",
          "2-rank gloo process group", "native C++ lib", "matplotlib / PIL (figures)")


def test_doctor_cli_without_a_card():
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-m", "deep_staple_torch.doctor", "--timeout", "120"],
                          env=env, cwd=REPO, capture_output=True, text=True, timeout=480)
    assert proc.returncode == 1, proc.stdout + proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert lines[0] == "deep_staple_torch doctor"
    for name in CHECKS:
        assert any(line.strip().startswith(name) for line in lines), (name, proc.stdout)
    assert "CUDA card" in proc.stdout and "[FAIL]" in proc.stdout
    assert lines[-1] == "summary: no CUDA card; only the --device cpu paths are usable"
    assert "jax" not in proc.stdout.lower()


@pytest.mark.parametrize("card, nvcc, build, rc, summary", [
    (True, True, True, 0, "summary: all checks passed"),
    (True, True, False, 1, "summary: FAILURES above"),
    (True, False, False, 1, "summary: FAILURES above"),
    (False, True, True, 1, "summary: no CUDA card; only the --device cpu paths are usable"),
])
def test_doctor_exit_status(monkeypatch, capsys, card, nvcc, build, rc, summary):
    """Exit 0 only when the card, nvcc and the kernel build pass (the probes
    stubbed; the optional checks only warn)."""
    def probe(name, ok):
        return lambda t: doctor._report(name, "ok" if ok else "FAIL")

    monkeypatch.setattr(doctor, "check_card", probe("CUDA card", card))
    monkeypatch.setattr(doctor, "check_power_limit", lambda t: True)
    monkeypatch.setattr(doctor, "check_nvcc", probe("nvcc", nvcc))
    monkeypatch.setattr(doctor, "check_kernel_build", probe("kernel build (sm_90a)", build))
    monkeypatch.setattr(doctor, "check_mesh", probe("2-rank gloo process group", True))
    monkeypatch.setattr(doctor, "check_native", lambda: True)
    assert doctor.main(["--timeout", "5"]) == rc
    assert capsys.readouterr().out.splitlines()[-1] == summary


def test_doctor_mesh_probe(capsys):
    """The mesh probe (the JAX doctor's virtual-mesh check,
    `deep_staple_tpu/doctor.py:147-167`): two gloo ranks on the CPU
    all-reduce 1 and 2 and both see 3."""
    assert doctor.check_mesh(120)
    out = capsys.readouterr().out
    assert "[ok]" in out and "all_reduce 1 + 2 = 3" in out


def test_doctor_fails_when_the_mesh_probe_fails(monkeypatch, capsys):
    monkeypatch.setattr(doctor, "check_card", lambda t: doctor._report("CUDA card", "ok"))
    monkeypatch.setattr(doctor, "check_power_limit", lambda t: True)
    monkeypatch.setattr(doctor, "check_nvcc", lambda t: doctor._report("nvcc", "ok"))
    monkeypatch.setattr(doctor, "check_kernel_build",
                        lambda t: doctor._report("kernel build (sm_90a)", "ok"))
    monkeypatch.setattr(doctor, "_subprocess_probe", lambda code, t: ("timeout", ""))
    monkeypatch.setattr(doctor, "check_native", lambda: True)
    assert doctor.main(["--timeout", "5"]) == 1
    out = capsys.readouterr().out
    assert "2-rank gloo process group" in out and "hung >5s" in out
    assert out.splitlines()[-1] == "summary: FAILURES above"
