"""The port's card tools on the CPU: ``utils/selfcheck.py`` (the preflight)
and ``utils/op_profile.py`` (the kernel-level profile).  On the CPU the
preflight checks no kernel and says so, and runs the train step and the
wall-clock path (as the JAX tool on a host without a TPU); on the default
device without a card both tools raise; op_profile's dry run prints its
per-step line and a table."""

import pytest
import torch

from novel_vqa_torch.utils import op_profile, selfcheck


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads while a test of this file runs: the suite runs
    several test processes on one host, and full-width CPU work with a
    thread per core in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_selfcheck_on_the_cpu(capsys):
    assert selfcheck.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "the kernels are not checked" in out
    assert "loss" in out and "finite=True" in out
    assert "no device plane on the CPU" in out
    assert out.rstrip().endswith("SELFCHECK PASSED")


@pytest.mark.parametrize("tool", ["selfcheck", "op_profile"])
def test_tools_default_to_the_card(tool):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    main = {"selfcheck": selfcheck.main, "op_profile": op_profile.main}[tool]
    with pytest.raises(RuntimeError, match="cuda"):
        main([])


def test_op_profile_arch1_on_the_cpu(capsys, tmp_path):
    op_profile.main(["--workload", "arch1", "--device", "cpu", "--batch_size", "8",
                     "--scan_steps", "2", "--chunks", "1", "--top", "5",
                     "--trace_dir", str(tmp_path)])
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0].startswith("# per-step wall time:") and "(arch1, bs=8)" in lines[0]
    assert "device time" not in lines[0]  # a CPU run measures no device time
    table = [ln for ln in lines if ln.startswith("  ") and "us/step" in ln]
    assert 0 < len(table) <= 5 and any("aten::" in ln for ln in table)
    assert (tmp_path / "trace.json").exists()
