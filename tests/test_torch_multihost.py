"""The PyTorch/CUDA port's dry runs of the multi-device layer (the
counterparts of __graft_entry__.py's ``dryrun_multihost`` and
``dryrun_multichip``) on spawned gloo groups on the CPU, and the launcher's
limits: a group whose rank fails, or that hangs, fails in seconds instead of
waiting out its collectives."""

import time

import pytest

from m4ri_tpu_torch import dryrun
from m4ri_tpu_torch.parallel._spawn import RankFailed, launch


def test_dryrun_multihost_two_hosts_of_two():
    """make_multihost_mesh lays 2 hosts x 2 ranks out host-major and
    mul_dist / mul_dist_ksplit / dist_ple give the single-process words
    across it (each rank checks its own coordinates and results)."""
    logs = dryrun.dryrun_multihost(device="cpu", timeout_s=240)
    for r in range(4):
        assert f"MULTIHOST_OK rank={r} host={r // 2}" in logs


def test_dryrun_multichip_4():
    report = dryrun.dryrun_multichip(4, device="cpu", timeout_s=240)
    assert "dryrun mesh: {'x': 2, 'y': 2} on cpu, gloo" in report
    assert "dryrun_multichip OK: 4 ranks" in report


def test_a_failing_rank_fails_the_group_at_once(tmp_path):
    """Rank 2 raises while ranks 0, 1 and 3 wait for it in a collective
    (whose own timeout is minutes): the launch fails as soon as rank 2
    exits, and kills the others."""
    t0 = time.monotonic()
    with pytest.raises(RankFailed) as err:
        launch("m4ri_tpu_torch.parallel._spawn:fault_on_rank", 4, tmp_path,
               backend="gloo", device="cpu", args=[2], timeout_s=120)
    assert time.monotonic() - t0 < 60
    assert "--- rank 2" in str(err.value)
    assert "RuntimeError: rank 2 fails on purpose" in str(err.value)


def test_a_hung_group_fails_at_its_limit(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="passed its limit"):
        launch("time:sleep", 2, tmp_path, backend="gloo", device="cpu",
               args=[600], timeout_s=15)
    assert time.monotonic() - t0 < 40
