"""The port's serving launcher (``repro_torch.launch.server``) end to end
on the CPU at the reduced config with a few requests: the sync/async A/B
over one open-loop trace (the arrival rate probed, as by default), the
chaos demo of one fault class, and the refusal of every option whose
slice is not ported."""
import pytest

from repro_torch.launch.server import main

SMALL = ["--device", "cpu", "--requests", "12", "--batch", "4", "--seq",
         "16", "--calib-batches", "2", "--embed-steps", "10"]


def test_server_maintenance_both(capsys):
    res = main(SMALL + ["--maintenance", "both"])
    assert set(res) == {"sync", "async"}
    for r in res.values():
        assert r["n_requests"] == 12 and r["n_batches"] >= 3
        assert r["throughput_rps"] > 0 and r["p99_ms"] >= r["p50_ms"] > 0
        assert r["n_admitted"] > 0
    out = capsys.readouterr().out
    assert "async vs sync" in out and "device cpu" in out


def test_server_fault_demo_recovers(capsys):
    res = main(SMALL + ["--fault", "maint_crash", "--rate", "200"])
    assert res["completed"] == res["requests"] == 12
    assert res["health"] == "healthy"
    out = capsys.readouterr().out
    assert "-> degraded" in out and "recover():" in out


@pytest.mark.parametrize("flags, match", [
    (["--codec", "lowrank"], "lowrank-codec"),
    (["--index", "ivf"], "clustered/IVF index"),
    (["--device-index", "clustered"], "clustered/IVF index"),
    (["--shards", "2"], "sharded-store"),
    (["--prefill"], "prefill"),
    (["--capacity-dir", "unused"], "capacity-tier"),
    (["--fault", "disk_write_io"], "capacity-tier")])
def test_server_refuses_unported_options(flags, match):
    with pytest.raises(NotImplementedError, match=match):
        main(SMALL + ["--calib-batches", "1", "--embed-steps", "2"] + flags)
