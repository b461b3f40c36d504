"""The port's serving launcher (``repro_torch.launch.server``) end to end
on the CPU at the reduced config with a few requests: the sync/async A/B
over one open-loop trace (the arrival rate probed, as by default), the
chaos demo of one fault class, the disk chaos classes over a temporary
capacity tier (DISK_DEGRADED through ``recover()``; the directory
removed afterwards), the A/B with ``--capacity-dir`` (one reopenable
tier directory per session), the store's scale options (the lowrank
codec, the ivf host index, the clustered device index) served to the
end, ``--shards`` (the sharded store) in both launchers, memoized prefill,
which is ``launch/serve.py``'s leg, both launchers at a zoo arch, and
the training launcher (``repro_torch.launch.train``) whose checkpoint
``launch/serve.py`` then serves."""
import os
import tempfile

import pytest

from repro_torch.launch.server import main
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

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
    pytest.param(["--shards", "2"], "sharded-store",
                 id="flags3-sharded-store"),
    pytest.param(["--prefill"], None, id="flags4-prefill")])
def test_server_refuses_unported_options(flags, match, capsys):
    """Both options are ported now. ``--shards 2`` serves through the
    sharded store in both launchers (clamped to one shard on the CPU) and
    ``serve.py`` prints its ``[serve] shards`` line. Memoized prefill is
    ``launch/serve.py``'s leg, as in the reference: ``server.py`` has no
    ``--prefill`` (argparse refuses it) and ``serve.py --prefill`` serves
    a causal arch to the end."""
    from repro_torch.launch import serve
    if match is not None:
        res = main(SMALL + ["--calib-batches", "1", "--embed-steps", "2",
                            "--maintenance", "async"] + flags)
        assert res["async"]["n_requests"] == 12
        res = serve.main(["--device", "cpu", "--requests", "8", "--batch",
                          "4", "--seq", "16", "--calib-batches", "2",
                          "--threshold", "-1000000"] + flags)
        assert res["shards"]["n_shards"] == 1
        assert sum(res["shards"]["occupancy"]) > 0
        assert res["hits"] == res["attempts"] > 0
        out = capsys.readouterr().out
        assert "[serve] shards       1 x " in out
        return
    with pytest.raises(SystemExit):
        main(SMALL + flags)
    res = serve.main(["--device", "cpu", "--arch", "gpt2_small",
                      "--requests", "4", "--batch", "4", "--seq", "16",
                      "--calib-batches", "1", "--decode-steps", "2"]
                     + flags)
    r = res["prefill"]
    assert r["attempts"] > 0 and r["total"] == 8
    out = capsys.readouterr().out
    assert "[prefill] replay hits" in out and "[prefill] parity" in out


@pytest.mark.parametrize("flags, attr, kind", [
    (["--codec", "lowrank"], "codec", "LowRankCodec"),
    (["--index", "ivf"], "index", "IVFIndex"),
    (["--device-index", "clustered"], "device_index",
     "ClusteredDeviceIndex")])
def test_server_serves_scale_options(monkeypatch, flags, attr, kind):
    """The options that used to wait for the scale slice serve a whole
    async trace; the session's store holds the chosen layout."""
    import repro_torch.launch.server as server_mod
    seen = []
    real = server_mod.release_session

    def release(args, sess):
        seen.append(type(getattr(sess.store, attr)).__name__)
        real(args, sess)
    monkeypatch.setattr(server_mod, "release_session", release)
    res = main(SMALL + ["--calib-batches", "1", "--embed-steps", "2",
                        "--maintenance", "async", "--rate", "200"] + flags)
    r = res["async"]
    assert r["n_requests"] == 12 and r["n_admitted"] > 0
    assert r["p99_ms"] >= r["p50_ms"] > 0
    assert seen == [kind]


@pytest.mark.parametrize("launcher,arch", [
    pytest.param("serve_prefill", "qwen2_1_5b", id="serve_prefill"),
    pytest.param("server", "qwen2_1_5b", id="server"),
    pytest.param("serve_prefill", "recurrentgemma_2b",
                 id="serve_prefill-recurrentgemma_2b"),
    pytest.param("server", "recurrentgemma_2b",
                 id="server-recurrentgemma_2b")])
def test_launchers_serve_zoo_arch(monkeypatch, capsys, launcher, arch):
    """``--arch qwen2_1_5b`` through the registry on its reduced config
    (four query heads over two KV heads, QKV bias, a tied head), and
    ``--arch recurrentgemma_2b`` (the hybrid: its one attention layer
    memoized, the RG-LRU layers' state carried by prefill):
    ``serve.py --prefill`` replays a calibration batch with hits and
    decodes after it, and ``server.py`` serves a whole async trace.
    whisper_medium, whose batches need frames, is refused by both."""
    import repro_torch.launch.serve as serve_mod
    import repro_torch.launch.server as server_mod
    mod = serve_mod if launcher == "serve_prefill" else server_mod
    cfgs = []
    real = mod.build_model

    def build(cfg, **kw):
        cfgs.append(cfg)
        return real(cfg, **kw)
    monkeypatch.setattr(mod, "build_model", build)
    if launcher == "serve_prefill":
        res = serve_mod.main(["--device", "cpu", "--arch", arch,
                              "--requests", "4", "--batch", "4", "--seq",
                              "16", "--calib-batches", "1",
                              "--decode-steps", "2", "--prefill"])
        r = res["prefill"]
        assert r["attempts"] > 0 and r["hits"] > 0 and r["total"] == 8
        assert "[prefill] parity" in capsys.readouterr().out
    else:
        res = main(SMALL + ["--arch", arch, "--calib-batches", "1",
                            "--embed-steps", "2", "--maintenance", "async",
                            "--rate", "200"])
        r = res["async"]
        assert r["n_requests"] == 12 and r["p99_ms"] >= r["p50_ms"] > 0
    if arch == "qwen2_1_5b":
        assert cfgs and all(c.name == "qwen2-reduced" and c.n_kv_heads == 2
                            and c.n_heads == 4 and c.qkv_bias for c in cfgs)
    else:
        assert cfgs and all(c.name == "recurrentgemma-reduced"
                            and c.layer_pattern == ("rglru", "rglru", "attn")
                            for c in cfgs)
    with pytest.raises((SystemExit, ValueError), match="frames"):
        if launcher == "serve_prefill":
            serve_mod.main(["--device", "cpu", "--arch", "whisper_medium"])
        else:
            main(SMALL + ["--arch", "whisper_medium"])


@pytest.mark.parametrize("fault", ["disk_write_io", "checkpoint_crash",
                                   "journal_torn"])
def test_server_disk_fault_demo_recovers(capsys, fault):
    """A disk chaos class detaches the capacity tier mid-trace: health
    walks to DISK_DEGRADED while every request is still served, and
    ``recover()`` reattaches the tier. The temporary tier directory is
    gone afterwards."""
    before = set(os.listdir(tempfile.gettempdir()))
    res = main(SMALL + ["--fault", fault, "--rate", "200"])
    assert res["completed"] == res["requests"] == 12
    assert res["health"] == "healthy"
    assert res["capacity"]["capacity_ok"] is True
    assert res["capacity"]["disk_errors"] >= 1
    assert res["capacity"]["checkpoints"] > 0
    out = capsys.readouterr().out
    assert "-> disk_degraded" in out and "'capacity_ok': True" in out
    left = {d for d in set(os.listdir(tempfile.gettempdir())) - before
            if d.startswith("memo_fault_capacity_")}
    assert not left


def test_server_capacity_dir_reopens(tmp_path):
    """``--capacity-dir``: each served leg writes its own tier directory,
    checkpointed, which reopens as a session."""
    from repro_torch.memo import MemoSession
    root = str(tmp_path / "tiers")
    res = main(SMALL + ["--maintenance", "async", "--rate", "200",
                        "--capacity-dir", root])
    assert res["async"]["n_requests"] == 12
    assert sorted(os.listdir(root)) == ["async"]
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model
    cfg = get_reduced("bert_base").replace(n_classes=4)
    m = build_model(cfg, device="cpu")
    sess = MemoSession.load(os.path.join(root, "async"), m, m.init(0),
                            device="cpu")
    assert sess.store.capacity_ok
    assert sess.store.capacity.recovery["n_replayed"] == 0
    assert sess.store.live_count == sess.store.capacity.live_count > 0
    assert sess.store.verify_integrity() == []


def test_train_launcher_reduced(tmp_path, capsys):
    """``tests/test_launchers.py::test_train_launcher_reduced`` on the
    port, then its checkpoint served by ``repro_torch.launch.serve``."""
    import re
    from repro_torch.launch import serve, train
    ck = os.path.join(tmp_path, "ck.npz")
    train.main(["--arch", "gpt2_small", "--reduced", "--steps", "12",
                "--batch", "4", "--seq", "32", "--ckpt", ck,
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "done: loss" in out and "device cpu" in out
    assert os.path.exists(ck)
    m = re.search(r"loss (\d+\.\d+) -> (\d+\.\d+)", out)
    assert float(m.group(2)) < float(m.group(1))
    from repro.train.checkpoint import load_checkpoint as jax_load
    _, opt, meta = jax_load(ck)                  # the reference reads it
    assert meta == {"step": 12, "arch": "gpt2-reduced"} and opt is None
    res = serve.main(["--device", "cpu", "--arch", "gpt2_small", "--ckpt",
                      ck, "--requests", "8", "--batch", "4", "--seq", "16",
                      "--calib-batches", "2", "--prefill"])
    assert res["prefill"]
    assert "[prefill] parity" in capsys.readouterr().out
