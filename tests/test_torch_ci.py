"""The port's CI workflow (``.github/workflows/torch.yml``) parses and has
both lanes with their commands: the CPU lane runs the port's tests and the
4-rank gloo dry run; the GPU lane, gated like ci.yml's gpu-smoke, runs the
cuda cases and chip_smoke.py.  ci.yml itself is the JAX package's."""

from pathlib import Path

import pytest

yaml = pytest.importorskip("yaml")

WORKFLOW = Path(__file__).resolve().parents[1] / ".github" / "workflows" / "torch.yml"


@pytest.fixture(scope="module")
def jobs():
    return yaml.safe_load(WORKFLOW.read_text())["jobs"]


def commands(job: dict) -> str:
    return "\n".join(step.get("run", "") for step in job["steps"])


def test_cpu_lane_runs_the_port_tests_and_the_dry_run(jobs):
    run = commands(jobs["cpu"])
    assert "python -m pytest tests/test_torch_*.py" in run
    assert "dryrun_multichip(4, 'cpu')" in run
    assert jobs["cpu"]["runs-on"] == "ubuntu-latest"


def test_gpu_lane_is_gated_and_runs_the_card_checks(jobs):
    gpu = jobs["gpu"]
    assert gpu["if"] == "${{ vars.FDOCT_GPU_RUNNER == 'true' }}"
    assert gpu["runs-on"] == ["self-hosted", "gpu"]
    run = commands(gpu)
    assert "pytest --noconftest -m cuda tests/test_torch_*.py" in run
    assert "python3 chip_smoke.py" in run
