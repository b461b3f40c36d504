"""The port's crash-consistent capacity tier: every case of
``tests/test_capacity.py`` on the port's objects, on the CPU, and the
cases that hold it to the JAX package across the file formats.

Ported cases cover: the page-aligned format-3 save layout (roundtrip incl. 0-d and
empty arrays, mmap reads, truncation/bit-flip rejection, atomic
publish), the CRC-framed write-ahead journal (replay order, torn-tail
stop), CapacityTier durability (reopen = manifest + replay + CRC sweep,
injected checkpoint crashes and torn journal frames, disk budget
demotion), a subprocess SIGKILL harness (tier-level and through
``MemoSession.load``), write-through admission / demotion / promotion
on ``MemoStore`` (bit-identical round-trips for all three codecs via a
hypothesis property test, corrupt-row quarantine through the retire
path, the stall watchdog), the DISK_DEGRADED health rung + bounded
``health_log`` ring, and fail-fast unknown chaos-preset names. The
SIGKILL children import ``repro_torch`` and never ``jax``. Where the
reference reaches what the port does not have (the chaos benchmark's
class check) the case runs the launcher's own check.
The property test makes its directories inside the test body with
``tempfile.TemporaryDirectory()`` (hypothesis refuses function-scoped
fixtures under ``@given``).

Cross-package cases: a format-3 and a format-2 file saved by the JAX
``MemoSession`` load in the port and serve with EQUAL store arrays, hit
masks and slots, and logits within ``LOGIT_ATOL`` (1e-4, the engine
parity tests' tolerance: f32 layers in two frameworks, ~1e-6 measured);
a file the port saves loads in the JAX package with equal arrays; the
same both ways for a session with the lowrank codec, an ivf host index
and the clustered device index (``nprobe``, ``n_clusters`` and
``n_lists`` survive each trip); a
capacity directory written by either package's ``CapacityTier``
(checkpointed rows, journal-only rows and a retire) recovers in the
other with equal rows and recovery report, and promotes there
bit-identically.
"""
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import textwrap
import time

import numpy as np
import pytest
from hypothesis import given, settings
import hypothesis.strategies as st

from repro_torch.configs import get_reduced
from repro_torch.data import TemplateCorpus
from repro_torch.core.capacity import (CapacityTier, Journal, is_format3,
                                       read_format3, write_format3)
from repro_torch.core.codec import get_codec
from repro_torch.core.database import AttentionDB
from repro_torch.core.faults import (CHAOS_PRESETS, FAULT_POINTS,
                                     FaultInjector, MemoStoreError)
from repro_torch.core.runtime import Health
from repro_torch.core.store import MemoStore
from repro_torch.memo import MemoSession, MemoSpec
from repro_torch.models import build_model
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO_ROOT, "src")

SEQ = 32
APM = (2, 4, 4)
EMB = 8


def _entries(rng, n):
    apms = rng.random((n, *APM)).astype(np.float16)
    embs = rng.normal(0, 0.01, (n, EMB)).astype(np.float32)
    embs[:, 0] += 10.0 * np.arange(1, n + 1)   # well separated
    return apms, embs


def _tier(root, **kw):
    kw.setdefault("codec", get_codec("f16", APM))
    kw.setdefault("embed_dim", EMB)
    return CapacityTier(str(root), **kw)


def _tier_rows(rng, codec, n):
    apms = rng.random((n, *APM)).astype(np.float16)
    parts = codec.encode(apms)
    embs = rng.normal(0, 1, (n, EMB)).astype(np.float32)
    return parts, embs, np.full(n, SEQ, np.int32)


# ------------------------------------------------------------- format 3

def test_format3_roundtrip_plain_and_mmap(tmp_path):
    path = str(tmp_path / "f.m3")
    arrays = {
        "scalar": np.asarray(7, np.int64),          # 0-d must stay 0-d
        "empty": np.zeros((0, 3), np.float32),
        "flags": np.asarray([True, False, True]),
        "apm": np.arange(24, dtype=np.float16).reshape(2, 3, 4),
        "big": np.arange(5000, dtype=np.int32),     # crosses a page
    }
    meta = {"format": 3, "nested": {"a": [1, 2]}, "name": "x"}
    assert write_format3(path, meta, arrays)
    assert is_format3(path)
    for mmap in (False, True):
        m, a = read_format3(path, mmap=mmap, verify=not mmap)
        assert m == meta
        assert set(a) == set(arrays)
        for k in arrays:
            assert a[k].shape == arrays[k].shape
            assert a[k].dtype == arrays[k].dtype
            np.testing.assert_array_equal(np.asarray(a[k]), arrays[k])
        if mmap:
            assert isinstance(a["big"], np.memmap)
            # every segment is page-aligned (the mmap contract)
            m2, _ = read_format3(path, verify=False)
            assert m2 == meta


def test_format3_rejects_truncation_and_bitflip(tmp_path):
    path = str(tmp_path / "f.m3")
    write_format3(path, {"k": 1}, {"x": np.arange(4096, dtype=np.int64)})
    torn = str(tmp_path / "torn.m3")
    shutil.copy(path, torn)
    with open(torn, "rb+") as f:
        f.truncate(os.path.getsize(torn) // 2)
    with pytest.raises(MemoStoreError, match="truncated or corrupt"):
        read_format3(torn)
    flip = str(tmp_path / "flip.m3")
    shutil.copy(path, flip)
    with open(flip, "rb+") as f:                  # flip a segment byte
        f.seek(os.path.getsize(flip) - 8)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(MemoStoreError, match="checksum mismatch"):
        read_format3(flip)
    assert not is_format3(str(tmp_path / "missing.m3"))


def test_format3_atomic_write_never_clobbers(tmp_path):
    """An injected crash between the temp write and the publish leaves
    the existing good file byte-identical."""
    path = str(tmp_path / "f.m3")
    write_format3(path, {"v": 1}, {"x": np.arange(8)})
    before = open(path, "rb").read()
    inj = FaultInjector()
    inj.arm("session.save_truncate", at=1, count=1)
    ok = write_format3(path, {"v": 2}, {"x": np.arange(9)},
                       faults=inj, fault_point="session.save_truncate")
    assert ok is False
    assert open(path, "rb").read() == before
    meta, _ = read_format3(path)
    assert meta == {"v": 1}
    # the raising flavor (CapacityTier.checkpoint's contract)
    inj2 = FaultInjector()
    inj2.arm("session.save_truncate", at=1, count=1)
    with pytest.raises(OSError, match="injected crash"):
        write_format3(path, {"v": 3}, {"x": np.arange(9)}, faults=inj2,
                      fault_point="session.save_truncate",
                      fault_raises=True)
    assert open(path, "rb").read() == before


# -------------------------------------------------------------- journal

def test_journal_append_replay_roundtrip(tmp_path):
    j = Journal(str(tmp_path / "j.wal"))
    a = {"slots": np.asarray([0, 1]), "embs": np.eye(2, dtype=np.float32)}
    j.append("append", a)
    j.append("retire", {"slots": np.asarray([1])})
    recs, torn = j.replay()
    assert not torn and [k for k, _ in recs] == ["append", "retire"]
    np.testing.assert_array_equal(recs[0][1]["embs"], a["embs"])
    j.truncate()
    assert j.replay() == ([], False) and j.nbytes == 0
    j.close()


def test_journal_torn_tail_stops_cleanly(tmp_path):
    path = str(tmp_path / "j.wal")
    j = Journal(path)
    j.append("append", {"slots": np.asarray([0])})
    j.append("append", {"slots": np.asarray([1])})
    with open(path, "rb+") as f:                  # crash mid-frame
        f.truncate(os.path.getsize(path) - 3)
    recs, torn = j.replay()
    assert torn and len(recs) == 1
    np.testing.assert_array_equal(recs[0][1]["slots"], [0])
    # the injected flavor: a torn frame hits the disk, the append fails
    inj = FaultInjector()
    inj.arm("capacity.journal_torn", at=2, count=1, frac=0.4)
    j2 = Journal(str(tmp_path / "j2.wal"), faults=inj)
    j2.append("append", {"slots": np.asarray([0])})
    with pytest.raises(OSError, match="torn journal frame"):
        j2.append("append", {"slots": np.asarray([1])})
    recs2, torn2 = j2.replay()
    assert torn2 and len(recs2) == 1
    j.close(), j2.close()


# -------------------------------------------------------- capacity tier

def test_tier_append_retire_verify(tmp_path):
    rng = np.random.default_rng(0)
    t = _tier(tmp_path / "t", capacity=4)
    parts, embs, lens = _tier_rows(rng, t.codec, 6)
    slots = t.append(parts, embs, lens)
    assert t.live_count == 6 and t.verify().size == 0
    got_parts, got_embs, got_lens, _ = t.rows_at(slots)
    for p, g in zip(parts, got_parts):
        assert np.asarray(g).tobytes() == np.asarray(p).tobytes()
    np.testing.assert_array_equal(np.asarray(got_embs), embs)
    retired = []
    t.on_retire = lambda s: retired.extend(int(x) for x in s)
    t.retire(slots[:2])
    assert t.live_count == 4 and retired == [int(s) for s in slots[:2]]
    d2, hits = t.search(embs[2:3], 1)
    assert int(hits[0, 0]) == int(slots[2]) and d2[0, 0] < 1e-6
    t.close()


def test_tier_budget_retires_coldest_first(tmp_path):
    rng = np.random.default_rng(1)
    codec = get_codec("f16", APM)
    t = _tier(tmp_path / "t", codec=codec, capacity=4,
              budget_bytes=4 * (codec.entry_nbytes + EMB * 4))
    parts, embs, lens = _tier_rows(rng, codec, 4)
    first = t.append(parts, embs, lens)
    t.note_reuse(first[:2])                       # rows 0,1 are hot
    parts2, embs2, lens2 = _tier_rows(rng, codec, 2)
    fresh = t.append(parts2, embs2, lens2)
    assert t.live_count == 4
    live = set(int(s) for s in t.live_slots)
    assert set(int(s) for s in first[:2]) <= live       # hot survived
    assert set(int(s) for s in fresh) <= live           # fresh excluded
    assert t.n_retired == 2
    t.close()


def test_tier_reopen_replays_journal(tmp_path):
    rng = np.random.default_rng(2)
    t = _tier(tmp_path / "t", capacity=4)
    t.append(*_tier_rows(rng, t.codec, 3))
    t.append(*_tier_rows(rng, t.codec, 2))
    t.retire(t.live_slots[:1])
    # no checkpoint, no close: the reopen below is the crash path
    t2 = _tier(tmp_path / "t")
    assert t2.recovery == {"n_replayed": 3, "torn_tail": False,
                           "n_quarantined": 0, "live_after": 4}
    assert t2.live_count == 4 and t2.verify().size == 0
    assert t2.journal.nbytes == 0                 # recovery checkpointed
    t2.close()


def test_tier_torn_journal_tail_loses_only_the_tail(tmp_path):
    rng = np.random.default_rng(3)
    t = _tier(tmp_path / "t", capacity=4)
    t.append(*_tier_rows(rng, t.codec, 2))
    t.append(*_tier_rows(rng, t.codec, 2))
    with open(os.path.join(str(tmp_path / "t"), CapacityTier.JOURNAL),
              "rb+") as f:
        f.truncate(os.path.getsize(f.name) - 5)   # tear the last frame
    t2 = _tier(tmp_path / "t")
    assert t2.recovery["torn_tail"] and t2.recovery["n_replayed"] == 1
    assert t2.live_count == 2 and t2.verify().size == 0
    t2.close()


def test_tier_recovery_quarantines_bitflipped_row(tmp_path):
    rng = np.random.default_rng(4)
    t = _tier(tmp_path / "t", capacity=4)
    slots = t.append(*_tier_rows(rng, t.codec, 3))
    t.checkpoint()
    t.close()
    part0 = t.codec.parts[0]
    with open(os.path.join(str(tmp_path / "t"),
                           f"part_{part0.name}.dat"), "rb+") as f:
        f.seek(int(slots[1]) * part0.entry_nbytes)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    t2 = _tier(tmp_path / "t")
    assert t2.recovery["n_quarantined"] == 1
    assert t2.recovery["live_after"] == 2
    assert not t2._live[int(slots[1])]
    assert t2.verify().size == 0
    t2.close()


def test_tier_checkpoint_crash_keeps_old_manifest(tmp_path):
    rng = np.random.default_rng(5)
    inj = FaultInjector()
    t = _tier(tmp_path / "t", capacity=4, faults=inj)
    t.append(*_tier_rows(rng, t.codec, 3))
    inj.arm("capacity.checkpoint_crash", at=1, count=1)
    with pytest.raises(OSError, match="injected crash"):
        t.checkpoint()
    # the old (empty) manifest + intact journal still recover everything
    t2 = _tier(tmp_path / "t")
    assert t2.recovery["n_replayed"] == 1 and t2.live_count == 3
    assert t2.verify().size == 0
    t2.close()


# --------------------------------------------- SIGKILL subprocess harness

_CHILD = textwrap.dedent("""\
    import json, sys
    import numpy as np
    from repro_torch.core.capacity import CapacityTier
    from repro_torch.core.codec import get_codec

    root, shape, emb, codec_name = (sys.argv[1],
                                    tuple(json.loads(sys.argv[2])),
                                    int(sys.argv[3]), sys.argv[4])
    codec = get_codec(codec_name, shape)
    t = CapacityTier(root, codec=codec, embed_dim=emb, capacity=8)
    rng = np.random.default_rng(int(sys.argv[5]))
    print("READY", flush=True)
    i = 0
    while True:
        apms = rng.random((2, *shape)).astype(np.float16)
        t.append(codec.encode(apms),
                 rng.normal(size=(2, emb)).astype(np.float32),
                 np.full(2, shape[-1], np.int32))
        print("A", flush=True)      # acked: the rows are journal-durable
        if i % 2 == 0:
            t.checkpoint()
        i += 1
""")


def _kill_round(root, shape, emb, codec_name, delay, seed):
    """Run the append/checkpoint child against ``root`` and SIGKILL it
    ``delay`` seconds after READY; returns the number of acked appends
    (each durably journaled before the ack)."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(root),
         str(list(shape)).replace("(", "[").replace(")", "]"),
         str(emb), codec_name, str(seed)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
    try:
        assert proc.stdout.readline().strip() == b"READY", \
            proc.stderr.read().decode()
        time.sleep(delay)
        proc.send_signal(signal.SIGKILL)
        out, _ = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
    return sum(1 for ln in out.splitlines() if ln.strip() == b"A")


def test_sigkill_at_random_points_recovers_clean(tmp_path):
    """SIGKILL the tier child at randomized instants across several
    crash→recover cycles: every reopen must verify clean and keep at
    least every acked (journal-durable) row."""
    root = str(tmp_path / "t")
    rng = np.random.default_rng(0)
    acked_rows = 0
    for trial in range(3):
        acked_rows += 2 * _kill_round(
            root, APM, EMB, "f16",
            float(rng.uniform(0.05, 0.35)), seed=trial)
        t = _tier(root)                           # recovery on open
        assert t.recovery is not None
        assert t.verify().size == 0
        assert t.live_count >= acked_rows
        acked_rows = t.live_count                 # next round builds on it
        t.close()
    assert acked_rows > 0


# ---------------------------------------------------- single-writer lock

def test_lockfile_refuses_live_second_writer(tmp_path):
    """Two processes must never journal one dir: a subprocess opening a
    dir we hold the lock on gets an actionable MemoStoreError naming the
    owning pid and the lockfile."""
    root = str(tmp_path / "t")
    t = _tier(root)
    code = textwrap.dedent(f"""\
        from repro_torch.core.capacity import CapacityTier
        from repro_torch.core.codec import get_codec
        from repro_torch.core.faults import MemoStoreError
        try:
            CapacityTier({root!r}, codec=get_codec("f16", {APM!r}),
                         embed_dim={EMB})
        except MemoStoreError as e:
            print("CONFLICT", e)
        else:
            print("NO-CONFLICT")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=dict(os.environ, PYTHONPATH=SRC))
    assert "CONFLICT" in r.stdout, r.stdout + r.stderr
    assert str(os.getpid()) in r.stdout          # names the owner
    assert "LOCK" in r.stdout                    # names the lockfile
    t.close()
    assert not os.path.exists(os.path.join(root, "LOCK"))


def test_lockfile_stale_and_same_pid_reclaimed(tmp_path):
    """A lock naming a dead pid (SIGKILL'd writer) or our own pid (a
    same-process reopen) is reclaimed, not refused; garbage content
    counts as stale."""
    root = str(tmp_path / "t")
    _tier(root).close()
    for content in ["999999999\n", "not-a-pid", ""]:
        with open(os.path.join(root, "LOCK"), "w") as f:
            f.write(content)
        t = _tier(root)
        with open(os.path.join(root, "LOCK")) as f:
            assert int(f.read()) == os.getpid()
        t.close()
    t = _tier(root)                  # same-pid double-open: takeover
    t2 = _tier(root)
    t2.close()


# --------------------------------------------------------- re-compaction

def test_compact_returns_bytes_and_preserves_rows(tmp_path):
    rng = np.random.default_rng(0)
    t = _tier(tmp_path / "t")
    parts, embs, lens = _tier_rows(rng, t.codec, 20)
    slots = t.append(parts, embs, lens)
    t.retire(slots[5:15])
    assert t.retired_fraction == pytest.approx(0.5)
    keep = np.asarray([0, 1, 2, 3, 4, 15, 16, 17, 18, 19])
    old_bytes = sum(os.path.getsize(p) for p in t._arena_paths())
    rep = t.compact()
    assert rep["epoch"] == 1 and rep["live"] == 10
    assert rep["slots_reclaimed"] == 10 and rep["bytes_returned"] > 0
    assert sum(os.path.getsize(p) for p in t._arena_paths()) < old_bytes
    # dense renumbering: old live_slots[i] -> i, bytes intact
    assert t.live_count == 10 and t._n == 10 and t.verify().size == 0
    got, gembs, glens, _ = t.rows_at(np.arange(10))
    for g, p in zip(got, parts):
        assert g.tobytes() == np.ascontiguousarray(p[keep]).tobytes()
    assert np.array_equal(gembs, embs[keep])
    # epoch-0 files gone, reopen sees the new epoch
    assert not os.path.exists(t._part_path(t.codec.parts[0], 0))
    t.close()
    t = _tier(tmp_path / "t")
    assert t.epoch == 1 and t.live_count == 10 and t.verify().size == 0
    t.close()


def test_compact_crash_keeps_old_epoch_and_gcs_strays(tmp_path):
    """``capacity.compact_crash`` fires after the new epoch is staged,
    before the manifest publish: the tier must roll back in-process, and
    a reopen must serve the OLD epoch and GC the stray files."""
    rng = np.random.default_rng(1)
    inj = FaultInjector()
    t = _tier(tmp_path / "t", faults=inj)
    parts, embs, lens = _tier_rows(rng, t.codec, 12)
    slots = t.append(parts, embs, lens)
    t.retire(slots[:6])
    inj.arm("capacity.compact_crash", count=1)
    with pytest.raises(OSError):
        t.compact()
    assert t.epoch == 0 and t.live_count == 6      # rolled back
    strays = [f for f in os.listdir(str(tmp_path / "t")) if ".e1." in f]
    assert strays                                  # staged files remain
    t.close()
    t = _tier(tmp_path / "t")
    assert t.epoch == 0 and t.live_count == 6 and t.verify().size == 0
    assert not [f for f in os.listdir(str(tmp_path / "t")) if ".e1." in f]
    rep = t.compact()                              # disarmed: succeeds
    assert rep["epoch"] == 1 and t.live_count == 6
    t.close()


def test_store_compact_capacity_remaps_disk_slots(tmp_path):
    """Store-level trigger: compaction renumbers disk slots, so the
    host↔disk write-through maps must be rewritten — demotion after a
    compaction must still be free (no re-append)."""
    rng = np.random.default_rng(2)
    s = MemoStore(APM, EMB, capacity=16, capacity_dir=str(tmp_path / "t"))
    apms, embs = _entries(rng, 8)
    s.admit(apms, embs)
    s.evict(4)                                     # demote 4 to disk
    s.capacity.retire(np.asarray(
        [s._host_to_disk[h] for h in list(s._host_to_disk)[:2]]))
    assert s.compact_capacity(min_retired=0.9) is None   # below threshold
    rep = s.compact_capacity(min_retired=0.1)
    assert rep is not None and rep["live"] == 6
    # maps now name the dense slots — and stay consistent both ways
    assert all(0 <= d < 6 for d in s._host_to_disk.values())
    for h, d in s._host_to_disk.items():
        assert s._disk_to_host[d] == h
    # demoting everything re-appends ONLY the two rows whose disk
    # copies were retired — the six remapped mirrors are still free
    before = s.capacity.n_appended
    s.evict(8)
    assert s.capacity.n_appended == before + 2
    assert s.capacity.verify().size == 0


def test_compact_ratio_spec_plumbing_and_idempotence(tmp_path):
    """``CapacitySpec.compact_ratio`` validates and round-trips through
    the flat view (the ``MemoServer._after_apply`` trigger reads it);
    compaction below the threshold — or right after one — is a no-op."""
    spec = MemoSpec.flat(capacity_compact_ratio=0.5)
    assert spec.capacity.compact_ratio == 0.5
    assert spec.capacity_compact_ratio == 0.5      # flat property
    with pytest.raises(ValueError):
        MemoSpec.flat(capacity_compact_ratio=1.5)
    s = MemoStore(APM, EMB, capacity=16, capacity_dir=str(tmp_path / "t"))
    rng = np.random.default_rng(3)
    apms, embs = _entries(rng, 8)
    s.admit(apms, embs)
    s.capacity.retire(s.capacity.live_slots[:4])
    assert s.capacity.retired_fraction >= 0.5
    rep = s.compact_capacity(0.5)
    assert rep is not None and s.capacity.n_compactions == 1
    assert s.compact_capacity(0.5) is None         # nothing left to do


_COMPACT_CHILD = textwrap.dedent("""\
    import json, sys
    import numpy as np
    from repro_torch.core.capacity import CapacityTier
    from repro_torch.core.codec import get_codec

    root, shape, emb = (sys.argv[1], tuple(json.loads(sys.argv[2])),
                        int(sys.argv[3]))
    codec = get_codec("f16", shape)
    t = CapacityTier(root, codec=codec, embed_dim=emb, capacity=8)
    rng = np.random.default_rng(int(sys.argv[4]))
    print("READY", flush=True)
    while True:
        apms = rng.random((4, *shape)).astype(np.float16)
        slots = t.append(codec.encode(apms),
                         rng.normal(size=(4, emb)).astype(np.float32),
                         np.full(4, shape[-1], np.int32))
        t.retire(slots[:2])
        print("A", flush=True)   # acked: +2 live rows journal-durable
        t.compact()              # SIGKILL may land anywhere in here
""")


def test_sigkill_mid_compaction_reopens_clean(tmp_path):
    """Kill-harness round for compaction: a child that compacts after
    every append/retire cycle is SIGKILL'd at random instants — every
    reopen must verify clean, keep every acked live row, and leave
    exactly one epoch's arena files on disk."""
    root = str(tmp_path / "t")
    rng = np.random.default_rng(0)
    env = dict(os.environ, PYTHONPATH=SRC)
    acked_live = 0
    for trial in range(3):
        proc = subprocess.Popen(
            [sys.executable, "-c", _COMPACT_CHILD, root,
             str(list(APM)), str(EMB), str(trial)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
        try:
            assert proc.stdout.readline().strip() == b"READY", \
                proc.stderr.read().decode()
            time.sleep(float(rng.uniform(0.05, 0.35)))
            proc.send_signal(signal.SIGKILL)
            out, _ = proc.communicate(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
        acked_live += 2 * sum(1 for ln in out.splitlines()
                              if ln.strip() == b"A")
        t = _tier(root)                           # recovery on open
        assert t.recovery is not None
        assert t.verify().size == 0
        assert t.live_count >= acked_live
        # exactly one epoch's files survive the GC
        suffixes = {f.split("part_apm")[-1]
                    for f in os.listdir(root) if f.startswith("part_apm")}
        assert len(suffixes) == 1
        acked_live = t.live_count
        t.close()
    assert acked_live > 0


# --------------------------------------- store: write-through / promotion

def test_write_through_then_demotion_is_free(tmp_path):
    rng = np.random.default_rng(0)
    s = MemoStore(APM, EMB, capacity=8, capacity_dir=str(tmp_path / "t"))
    apms, embs = _entries(rng, 6)
    slots = s.admit(apms, embs)
    assert s.capacity_ok and s.capacity.live_count == 6
    assert len(s._host_to_disk) == 6              # mirrored at admission
    before = s.capacity.n_appended
    demoted = s.evict(2)
    assert len(demoted) == 2 and s.stats.n_demoted == 2
    assert s.capacity.live_count == 6             # disk copies survive
    assert s.capacity.n_appended == before        # no re-append needed
    assert s.live_count == 4
    assert slots is not None


@settings(max_examples=6, deadline=None)
@given(codec_name=st.sampled_from(["f16", "int8", "lowrank"]),
       n=st.integers(2, 5), seed=st.integers(0, 10_000))
def test_demote_promote_roundtrip_bit_identical(codec_name, n, seed):
    """Property: demote → promote round-trips every codec part
    bit-identically, for every codec (lowrank: four parts)."""
    with tempfile.TemporaryDirectory() as d:
        rng = np.random.default_rng(seed)
        s = MemoStore(APM, EMB, capacity=16, codec=codec_name,
                      capacity_dir=os.path.join(d, "t"))
        apms, embs = _entries(rng, n)
        slots = s.admit(apms, embs)
        before = [np.asarray(p).copy() for p in s.db.parts_at(slots)]
        assert s.capacity_ok
        s.evict(n)
        assert s.live_count == 0 and s.stats.n_demoted == n
        satisfied = s.promote_for(embs, threshold=0.5)
        assert satisfied.all() and s.stats.n_promoted == n
        _, idx = s.lookup(embs, 1)
        after = s.db.parts_at(idx[:, 0])
        for b, a in zip(before, after):
            assert np.asarray(a).tobytes() == b.tobytes()
        s.capacity.close()


def test_promote_quarantines_corrupt_disk_rows(tmp_path):
    rng = np.random.default_rng(7)
    s = MemoStore(APM, EMB, capacity=8, capacity_dir=str(tmp_path / "t"))
    apms, embs = _entries(rng, 3)
    s.admit(apms, embs)
    s.evict(3)
    bad_disk = int(s.capacity.live_slots[1])
    row = np.asarray(s.capacity._parts[0][bad_disk]).copy()
    row.view(np.uint8).reshape(-1)[0] ^= 0xFF     # flip, checksum stale
    s.capacity._parts[0][bad_disk] = row
    satisfied = s.promote_for(embs, threshold=0.5)
    assert s.stats.n_disk_quarantined == 1
    assert int(satisfied.sum()) == 2              # the corrupt one missed
    assert s.capacity.live_count == 2             # retired on disk too
    assert s.capacity.verify().size == 0


def test_promotion_respects_length_gate(tmp_path):
    rng = np.random.default_rng(8)
    s = MemoStore(APM, EMB, capacity=8, capacity_dir=str(tmp_path / "t"))
    apms, embs = _entries(rng, 2)
    s.admit(apms, embs, lengths=np.asarray([SEQ, SEQ // 2]))
    s.evict(2)
    sat = s.promote_for(embs, lengths=np.asarray([SEQ, SEQ]),
                        threshold=0.5)
    assert bool(sat[0]) and not bool(sat[1])      # wrong length: no hit


def test_adopt_capacity_hottest_first_budget_capped(tmp_path):
    rng = np.random.default_rng(9)
    d = str(tmp_path / "t")
    a = MemoStore(APM, EMB, capacity=16, capacity_dir=d)
    apms, embs = _entries(rng, 8)
    a.admit(apms, embs)
    hot_disk = a.capacity.live_slots[:3]
    a.capacity.note_reuse(hot_disk)
    a.checkpoint()
    b = MemoStore(APM, EMB, capacity=16, capacity_dir=d,
                  budget_bytes=3 * a.entry_nbytes)
    assert b.capacity_ok and b.live_count == 0
    assert b.capacity.live_count == 8             # recovered, not wiped
    n = b.adopt_capacity()
    assert n == 3                                 # host budget caps it
    assert set(b._host_to_disk.values()) == set(int(s) for s in hot_disk)
    _, idx = b.lookup(b._embs_host[sorted(b._host_to_disk)], 1)
    assert (np.asarray(idx[:, 0]) >= 0).all()


def test_stall_watchdog_detaches_tier(tmp_path):
    inj = FaultInjector()
    inj.arm("capacity.disk_write_io", at=1, count=1, stall_s=0.2)
    s = MemoStore(APM, EMB, capacity=8, capacity_dir=str(tmp_path / "t"),
                  capacity_stall_s=0.05, faults=inj)
    rng = np.random.default_rng(10)
    apms, embs = _entries(rng, 2)
    slots = s.admit(apms, embs)                   # stalled write-through
    assert slots.size == 2                        # admission survived
    assert not s.capacity_ok
    assert "TimeoutError" in s.capacity_error
    assert s.stats.n_disk_errors == 1


def test_disk_write_error_detaches_then_reattach(tmp_path):
    inj = FaultInjector()
    s = MemoStore(APM, EMB, capacity=8, capacity_dir=str(tmp_path / "t"),
                  faults=inj)
    rng = np.random.default_rng(11)
    apms, embs = _entries(rng, 4)
    inj.arm("capacity.disk_write_io", at=1, count=1)
    s.admit(apms[:2], embs[:2])                   # write-through fails
    assert not s.capacity_ok and "OSError" in s.capacity_error
    s.admit(apms[2:], embs[2:])                   # RAM-only, no raise
    assert s.live_count == 4
    assert s.reattach_capacity()
    assert s.capacity_ok
    # the outage's admissions were re-mirrored on reattach
    assert s.capacity.live_count == 4
    assert len(s._host_to_disk) == 4
    assert s.verify_integrity() == []


# ------------------------------------------------- serving: health + ring

@pytest.fixture(scope="module")
def cap_sess(tmp_path_factory):
    tier_dir = str(tmp_path_factory.mktemp("captier") / "tier")
    cfg = get_reduced("bert_base").replace(n_classes=4, n_layers=2,
                                           d_model=128, d_ff=256,
                                           n_heads=4)
    m = build_model(cfg, device="cpu")
    params = m.init(0)
    corpus = TemplateCorpus(vocab=cfg.vocab, seq_len=SEQ, n_templates=6,
                            slot_fraction=0.2)
    spec = MemoSpec.flat(threshold=0.6, embed_steps=40, mode="bucket",
                         device_slack=8.0, admit=True, budget_mb=64.0,
                         faults={}, capacity_dir=tier_dir,
                         capacity_checkpoint_every=1)
    sess = MemoSession.build(
        m, params, spec,
        batches=[{"tokens": corpus.sample(16)[0]}
                 for _ in range(3)],
        seed=1, device="cpu")
    assert sess.store.capacity_ok
    assert os.path.exists(os.path.join(tier_dir, "session.m3"))
    return sess, corpus, m, params, tier_dir


def _serve_some(srv, corpus, n=4):
    comps = []
    for _ in range(n):
        toks = corpus.sample(8)[0]
        for r in range(8):
            srv.submit(np.asarray(toks[r], np.int32))
        comps.extend(srv.step(flush=True))
    return comps


def test_disk_fault_walks_ladder_and_recovers(cap_sess):
    """disk_write_io detaches the tier → DISK_DEGRADED; clean applies
    do NOT heal it (no silent un-detach); ``recover()`` reattaches,
    re-checkpoints and returns to HEALTHY."""
    sess, corpus, _, _, _ = cap_sess
    inj = sess.engine.faults
    inj.disarm(), inj.reset()
    srv = sess.serve(buckets=(SEQ,), max_batch=8, max_delay=1e-4)
    try:
        inj.arm("capacity.disk_write_io", p=1.0)
        comps = _serve_some(srv, corpus, n=3)
        srv.drain_maintenance(timeout=30, raise_errors=False)
        assert len(comps) == 24                   # zero dropped requests
        assert srv.health is Health.DISK_DEGRADED
        assert not sess.store.capacity_ok
        assert srv.n_health_transitions >= 1
        t, h, reason = srv.health_log[-1]
        assert h == "disk_degraded" and "capacity tier detached" in reason
        inj.disarm()
        _serve_some(srv, corpus, n=2)             # clean applies...
        srv.drain_maintenance(timeout=30, raise_errors=False)
        assert srv.health is Health.DISK_DEGRADED  # ...never auto-heal
        report = srv.recover()
        assert report["capacity_ok"] is True
        assert srv.health is Health.HEALTHY
        assert sess.store.capacity_ok
        # checkpoint cadence resumes post-recovery (checkpoint_every=1)
        before = srv.n_checkpoints
        _serve_some(srv, corpus, n=2)
        srv.drain_maintenance(timeout=30, raise_errors=False)
        assert srv.n_checkpoints > before
        assert srv.health is Health.HEALTHY
    finally:
        inj.disarm(), inj.reset()
        srv.close()
    assert sess.store.verify_integrity() == []


def test_health_log_ring_is_bounded(cap_sess):
    sess, _, _, _, _ = cap_sess
    srv = sess.serve(buckets=(SEQ,), max_batch=8, max_delay=1e-4,
                     async_maintenance=False, health_log_cap=4)
    try:
        for i in range(5):                        # 10 transitions
            srv._set_health(Health.DEGRADED, f"flap {i}")
            srv._set_health(Health.HEALTHY, f"heal {i}")
        assert len(srv.health_log) == 4           # ring holds the tail
        assert srv.n_health_transitions == 10     # total stays honest
        assert [e[2] for e in srv.health_log] == \
            ["flap 3", "heal 3", "flap 4", "heal 4"]
    finally:
        srv.close()


def test_session_dir_reopens_after_sigkill(cap_sess, tmp_path):
    """Kill a process mid-append/checkpoint on a copy of the session's
    capacity dir, then reopen through ``MemoSession.load``: integrity
    verifies clean and the recovered store serves hits again (reopen,
    verify_integrity, hit-rate recovery)."""
    sess, corpus, m, params, tier_dir = cap_sess
    sess.store.checkpoint()
    d2 = str(tmp_path / "tier_copy")
    shutil.copytree(tier_dir, d2)
    # the clone inherits the ORIGINAL owner's (live) lockfile — exactly
    # the "delete the lockfile if it is wrong" case the error names
    os.remove(os.path.join(d2, CapacityTier.LOCKFILE))
    shape = sess.store.apm_shape
    rng = np.random.default_rng(1)
    for trial in range(2):
        acked = _kill_round(d2, shape, sess.store.embed_dim,
                            sess.store.codec.name,
                            float(rng.uniform(0.05, 0.3)), seed=trial)
        assert acked >= 0
    sess2 = MemoSession.load(d2, m, params, device="cpu")
    assert sess2.store.capacity_ok
    assert sess2.store.capacity.recovery is not None
    assert sess2.store.verify_integrity() == []
    assert sess2.store.live_count > 0
    # hit-rate recovery: the adopted entries answer their own queries
    live = np.flatnonzero(sess2.store.db.live_mask)[:8]
    _, idx = sess2.store.lookup(sess2.store._embs_host[live], 1)
    np.testing.assert_array_equal(np.asarray(idx[:, 0]), live)
    srv = sess2.serve(buckets=(SEQ,), max_batch=8, max_delay=1e-4)
    try:
        comps = _serve_some(srv, corpus, n=2)
        srv.drain_maintenance(timeout=30, raise_errors=False)
        assert len(comps) == 16
        assert srv.health in (Health.HEALTHY, Health.DISK_DEGRADED)
        assert srv.health is Health.HEALTHY
    finally:
        srv.close()


# ------------------------------------------------ fail-fast chaos presets

def test_capacity_fault_points_and_presets_registered():
    for pt in ("capacity.disk_write_io", "capacity.journal_torn",
               "capacity.checkpoint_crash", "capacity.mmap_bitflip"):
        assert pt in FAULT_POINTS
    for cls in ("disk_write_io", "journal_torn", "checkpoint_crash",
                "mmap_bitflip"):
        assert cls in CHAOS_PRESETS


def test_serve_faults_rejects_unknown_class():
    """The port has no chaos benchmark; its launcher's chaos demo is the
    entry point that takes a class name, and it must refuse an unknown
    one listing every choice."""
    from repro_torch.launch import server as launch_server
    args = launch_server.parse_args(["--device", "cpu"])
    args.fault = "bogus"
    with pytest.raises(SystemExit, match="unknown chaos class") as ei:
        launch_server.run_fault_demo(args)
    msg = str(ei.value)
    for cls in sorted(CHAOS_PRESETS):
        assert cls in msg                         # lists every choice


def test_launch_server_rejects_unknown_fault(monkeypatch, capsys):
    from repro_torch.launch import server as launch_server
    monkeypatch.setattr(sys, "argv", ["server", "--fault", "bogus"])
    with pytest.raises(SystemExit) as ei:
        launch_server.main()
    assert ei.value.code == 2
    err = capsys.readouterr().err
    assert "invalid choice" in err and "disk_write_io" in err


# ------------------------------------------------------ read-only opener

def _rows_digest(tier):
    """Order-stable CRC over every live row's parts + embs + lens —
    computed identically by writer and reader to prove byte parity."""
    import zlib
    parts, embs, lens, _ = tier.rows_at(tier.live_slots)
    crc = 0
    for p in parts:
        crc = zlib.crc32(np.ascontiguousarray(p).tobytes(), crc)
    crc = zlib.crc32(np.ascontiguousarray(embs).tobytes(), crc)
    return zlib.crc32(np.ascontiguousarray(lens).tobytes(), crc)


def test_read_only_open_against_live_writer(tmp_path):
    """Cross-process read sharing: while THIS process
    holds the writer open (LOCK held, journal live), a subprocess opens
    the same directory with ``read_only=True`` — bypassing the pidfile,
    mapping the arenas ``mode='r'``, and replaying the writer's
    un-checkpointed WAL tail into the overlay. The reader sees every
    row byte-identically (checkpointed AND journal-only), verifies
    clean, searches, and every mutator raises MemoStoreError; the
    writer keeps working afterwards."""
    rng = np.random.default_rng(11)
    root = str(tmp_path / "tier")
    t = _tier(root, capacity=4)
    parts, embs, lens = _tier_rows(rng, t.codec, 6)
    t.append(parts, embs, lens)
    t.checkpoint()
    p2, e2, l2 = _tier_rows(rng, t.codec, 2)
    t.append(p2, e2, l2)          # journal-only: overlay rows for readers
    code = textwrap.dedent(f"""\
        import os, sys, zlib
        import numpy as np
        from repro_torch.core.capacity import CapacityTier
        from repro_torch.core.codec import get_codec
        from repro_torch.core.faults import MemoStoreError

        root = {root!r}
        assert os.path.exists(os.path.join(root, "LOCK"))  # writer alive
        t = CapacityTier.open(root, codec=get_codec("f16", (2, 4, 4)),
                              embed_dim=8, read_only=True)
        assert t.read_only and t.recovery["read_only"]
        assert t.journal is None                 # no WAL handle, ever
        bad = t.verify()
        assert bad.size == 0, bad
        sl = t.live_slots
        parts, embs, lens, _ = t.rows_at(sl)
        crc = 0
        for p in parts:
            crc = zlib.crc32(np.ascontiguousarray(p).tobytes(), crc)
        crc = zlib.crc32(np.ascontiguousarray(embs).tobytes(), crc)
        crc = zlib.crc32(np.ascontiguousarray(lens).tobytes(), crc)
        _, got = t.search(embs, k=1)             # overlay rows searchable
        assert (got[:, 0] == sl).all(), got[:, 0]
        for op in (lambda: t.append(parts, embs, lens),
                   lambda: t.retire([int(sl[0])]),
                   lambda: t.checkpoint(),
                   lambda: t.compact()):
            try:
                op()
            except MemoStoreError as e:
                assert "read_only" in str(e), e
            else:
                sys.exit("mutator did not raise on a read-only tier")
        t.close()
        print("RO-OK", t.live_count, t.recovery["overlay_rows"], crc)
        """)
    out = subprocess.run([sys.executable, "-c", code],
                         capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=SRC), timeout=120)
    assert "RO-OK" in out.stdout, out.stderr[-3000:]
    _, live, overlay, crc = out.stdout.split()
    assert int(live) == 8
    assert int(overlay) == 2      # exactly the un-checkpointed appends
    assert int(crc) == _rows_digest(t)           # byte parity with writer
    # the reader changed nothing: the writer's lock, journal and arenas
    # all still work
    p3, e3, l3 = _tier_rows(rng, t.codec, 1)
    t.append(p3, e3, l3)
    t.checkpoint()
    assert t.live_count == 9
    assert t.verify().size == 0
    t.close()


def test_read_only_open_requires_manifest(tmp_path):
    """A directory that was never checkpointed has nothing to map."""
    with pytest.raises(MemoStoreError, match="read-only"):
        CapacityTier.open(str(tmp_path / "nope"),
                          codec=get_codec("f16", APM), embed_dim=EMB,
                          read_only=True)


# ------------------------------------------------------------ spec plumbing

def test_capacity_spec_flat_roundtrip_and_validation(tmp_path):
    spec = MemoSpec.flat(capacity_dir=str(tmp_path / "t"),
                         capacity_budget_mb=8.0,
                         capacity_checkpoint_every=4)
    assert spec.capacity.dir == str(tmp_path / "t")
    assert spec.capacity.checkpoint_every == 4
    spec2 = MemoSpec.from_dict(spec.to_dict())
    assert spec2.capacity == spec.capacity
    with pytest.raises(ValueError):
        MemoSpec.flat(capacity_checkpoint_every=0)
    with pytest.raises(ValueError):
        MemoSpec.flat(capacity_stall_s=-1.0)


# ------------------------------------------- across packages (JAX ↔ port)

LOGIT_ATOL = 1e-4
MARGIN = 1e-3


@pytest.fixture(scope="module")
def ref_sess():
    """A JAX ``MemoSession`` (reduced bert_base: 2 layers, d 128, 4
    heads, seq 32; kernel mode, int8) and the port model with its
    weights."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced as jax_reduced
    from repro.data import TemplateCorpus as JaxCorpus
    from repro.memo import MemoSession as JaxSession, MemoSpec as JaxSpec
    from repro.models import build_model as jax_build_model
    from repro_torch.bridge import tree_to_torch
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model

    kw = dict(n_classes=4, n_layers=2, d_model=128, d_ff=256, n_heads=4)
    jm = jax_build_model(jax_reduced("bert_base").replace(**kw),
                         layer_loop="unroll")
    jparams = jm.init(jax.random.PRNGKey(0))
    corpus = JaxCorpus(vocab=jm.cfg.vocab, seq_len=SEQ, n_templates=6,
                       slot_fraction=0.2)
    jsess = JaxSession.build(
        jm, jparams, JaxSpec.flat(threshold=0.6, embed_steps=40,
                                  mode="kernel", apm_codec="int8"),
        batches=[{"tokens": jnp.asarray(corpus.sample(16)[0])}
                 for _ in range(3)], key=jax.random.PRNGKey(1))
    tm = build_model(get_reduced("bert_base").replace(**kw), device="cpu")
    queries = [corpus.sample(8)[0] for _ in range(2)] + [
        np.asarray(corpus.sample(16)[0][:8])]
    return jsess, jm, jparams, tm, tree_to_torch(jparams, "cpu"), queries


def _states_equal(a, b):
    assert set(a) == set(b), set(a) ^ set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def _serve(eng, tokens, thr):
    """One fast-path batch → (logits, per-layer (sims, hits, slots))."""
    prep = eng.prepare_batch({"tokens": tokens}, threshold=thr)
    eng.run_layers(prep)
    pend = [tuple(np.asarray(x) for x in p[1:4]) for p in prep.pend]
    out, _, _ = eng.finalize(prep)
    return np.asarray(out), pend


def _thresholds(jeng, tokens):
    """All-hit, all-miss and a threshold in a gap of the predicted sims
    at least MARGIN from every sim (an ulp cannot flip a decision)."""
    _, pend = _serve(jeng, tokens, 1e9)
    sims = np.sort(np.concatenate([p[0] for p in pend]))
    gaps = [(sims[i] + sims[i + 1]) / 2 for i in range(len(sims) - 1)
            if sims[i + 1] - sims[i] >= 2 * MARGIN]
    mid = min(gaps, key=lambda m: abs(m - np.median(sims)))
    return [-1e9, 1e9, float(mid)]


def _hold_serving(jeng, teng, queries):
    """Both engines serve every query at every threshold with EQUAL
    hits and slots and logits within LOGIT_ATOL; returns the hit count."""
    import jax.numpy as jnp
    n_hits = 0
    for mode in ("kernel", "bucket"):
        jeng.mc.mode = teng.mc.mode = mode
        for toks in queries:
            for thr in _thresholds(jeng, jnp.asarray(toks)):
                jl, jp = _serve(jeng, jnp.asarray(toks), thr)
                tl, tp = _serve(teng, toks, thr)
                for (js, jh, ji), (ts, th, ti) in zip(jp, tp):
                    np.testing.assert_array_equal(th, jh)
                    np.testing.assert_array_equal(ti, ji)
                    np.testing.assert_allclose(ts, js, atol=1e-5)
                    n_hits += int(th.sum())
                np.testing.assert_allclose(tl, jl, rtol=0, atol=LOGIT_ATOL)
    jeng.mc.mode = teng.mc.mode = "kernel"
    return n_hits


@pytest.mark.parametrize("fmt,mmap", [(3, False), (3, True), (2, False)])
def test_reference_save_loads_in_port(ref_sess, tmp_path, fmt, mmap):
    """A file the JAX session saved (format 3, read or mapped; format 2)
    loads in the port with equal store arrays and ``sim_cal``, and both
    serve the same queries with equal hits and slots."""
    jsess, _, _, tm, tparams, queries = ref_sess
    path = str(tmp_path / f"ref.f{fmt}")
    jsess.save(path, save_format=fmt)
    sess = MemoSession.load(path, tm, tparams, mmap=mmap, device="cpu")
    _states_equal(sess.store.state_dict(), jsess.store.state_dict())
    assert sess.store.sim_cal == tuple(jsess.store.sim_cal)
    if mmap:
        assert all(isinstance(a, np.memmap) for a in sess.store.db._arenas)
    assert _hold_serving(jsess.engine, sess.engine, queries) > 0


@pytest.mark.parametrize("fmt", [3, 2])
def test_port_save_loads_in_reference(ref_sess, tmp_path, fmt):
    """A file the port saved loads in the JAX package: equal store
    arrays, ``sim_cal``, spec fields and embedder, and the two serve the
    same queries with equal hits and slots."""
    from repro.memo import MemoSession as JaxSession
    jsess, jm, jparams, tm, tparams, queries = ref_sess
    src = str(tmp_path / "ref.m3")
    jsess.save(src)
    sess = MemoSession.load(src, tm, tparams, device="cpu")
    path = str(tmp_path / f"port.f{fmt}")
    sess.save(path, save_format=fmt)
    back = JaxSession.load(path, jm, jparams)
    _states_equal(back.store.state_dict(), sess.store.state_dict())
    assert tuple(back.store.sim_cal) == sess.store.sim_cal
    assert back.spec.capacity == jsess.spec.capacity
    assert back.spec.runtime.threshold == sess.spec.runtime.threshold
    for k, v in back.engine.embedder.params.items():
        assert np.asarray(v).tobytes() == \
            sess.engine.embedder.params[k].numpy().tobytes(), k
    assert _hold_serving(back.engine, sess.engine, queries) > 0


@pytest.fixture(scope="module")
def ref_scale_sess(ref_sess):
    """A JAX session on ``ref_sess``'s weights with the store's scale
    options: the lowrank codec, an ivf host index and the clustered
    device index (nprobe 8, 12 clusters)."""
    import jax
    import jax.numpy as jnp
    from repro.data import TemplateCorpus as JaxCorpus
    from repro.memo import MemoSession as JaxSession, MemoSpec as JaxSpec
    _, jm, jparams, _, _, _ = ref_sess
    corpus = JaxCorpus(vocab=jm.cfg.vocab, seq_len=SEQ, n_templates=6,
                       slot_fraction=0.2)
    return JaxSession.build(
        jm, jparams, JaxSpec.flat(
            threshold=0.6, embed_steps=40, mode="kernel",
            apm_codec="lowrank", index_kind="ivf",
            device_index="clustered", nprobe=8, n_clusters=12),
        batches=[{"tokens": jnp.asarray(corpus.sample(16)[0])}
                 for _ in range(3)], key=jax.random.PRNGKey(1))


def _same_scale_session(a, b, queries):
    """Two sessions (either package) with the scale options: equal spec
    index and codec fields, equal ``n_lists``, equal host-index lookups
    and equal fast-path serving (the JAX one first)."""
    for sess in (a, b):
        assert sess.spec.index.nprobe == 8 and sess.spec.index.n_clusters \
            == 12 and sess.spec.index.host == "ivf"
        assert sess.spec.codec.name == "lowrank"
        assert type(sess.store.device_index).__name__ == \
            "ClusteredDeviceIndex"
        assert sess.store.device_index.nprobe == 8
    assert a.store.index.n_lists == b.store.index.n_lists
    n = len(a.store)
    q = a.store._embs_host[:n:5] + 0.01
    np.testing.assert_array_equal(np.asarray(a.store.lookup(q)[1]),
                                  np.asarray(b.store.lookup(q)[1]))
    return _hold_serving(a.engine, b.engine, queries)


@pytest.mark.parametrize("fmt,mmap", [(3, True), (2, False)])
def test_reference_scale_save_loads_in_port(ref_sess, ref_scale_sess,
                                            tmp_path, fmt, mmap):
    """The JAX-saved scale session loads in the port (four lowrank parts
    mapped from format 3, or read from format 2) with equal store
    arrays and serves with equal hits and slots over its own clustered
    rebuild."""
    _, _, _, tm, tparams, queries = ref_sess
    path = str(tmp_path / f"ref.f{fmt}")
    ref_scale_sess.save(path, save_format=fmt)
    sess = MemoSession.load(path, tm, tparams, mmap=mmap, device="cpu")
    _states_equal(sess.store.state_dict(), ref_scale_sess.store.state_dict())
    assert len(sess.store.db._arenas) == 4
    assert _same_scale_session(ref_scale_sess, sess, queries) > 0


def test_port_scale_save_loads_in_reference(ref_sess, ref_scale_sess,
                                            tmp_path):
    """The port's save of the scale session loads in the JAX package:
    equal arrays, spec fields and ``n_lists``, equal serving."""
    from repro.memo import MemoSession as JaxSession
    _, jm, jparams, tm, tparams, queries = ref_sess
    src = str(tmp_path / "ref.m3")
    ref_scale_sess.save(src)
    sess = MemoSession.load(src, tm, tparams, device="cpu")
    path = str(tmp_path / "port.m3")
    sess.save(path)
    back = JaxSession.load(path, jm, jparams)
    _states_equal(back.store.state_dict(), sess.store.state_dict())
    assert back.spec.to_dict()["index"] == ref_scale_sess.spec.to_dict()[
        "index"]
    assert _same_scale_session(back, sess, queries) > 0


def _pkg(name):
    """(CapacityTier, get_codec, MemoStore) of one package."""
    if name == "jax":
        from repro.core.capacity import CapacityTier as T
        from repro.core.codec import get_codec as g
        from repro.core.store import MemoStore as S
        return T, g, S
    return CapacityTier, get_codec, MemoStore


def _rows(tier):
    parts, embs, lens, csums = tier.rows_at(tier.live_slots)
    return [np.asarray(x).tobytes() for x in (*parts, embs, lens, *csums)]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_capacity_dir_crosses_packages(tmp_path, writer, reader):
    """A tier directory written by one package — checkpointed rows,
    journal-only rows and a journaled retire, closed without a final
    checkpoint — recovers in the other exactly as in its writer's own
    package (rows, recovery report, manifest arrays), and promotes there
    bit-identically."""
    WT, wcodec, _ = _pkg(writer)
    RT, rcodec, RS = _pkg(reader)
    rng = np.random.default_rng(5)
    root = str(tmp_path / "w")
    w = WT(root, codec=wcodec("int8", APM), embed_dim=EMB, capacity=4)
    apms, embs = _entries(rng, 9)
    lens = np.full(9, APM[-1], np.int32)     # the store's default length
    w.append(w.codec.encode(apms[:6]), embs[:6], lens[:6])
    w.checkpoint()
    w.append(w.codec.encode(apms[6:]), embs[6:], lens[6:])
    w.retire(w.live_slots[[1, 7]])
    expect, live = _rows(w), w.live_slots.copy()
    w.close()                           # no checkpoint: 2 journal records
    twin = str(tmp_path / "twin")
    shutil.copytree(root, twin)
    r = RT(root, codec=rcodec("int8", APM), embed_dim=EMB)
    w2 = WT(twin, codec=wcodec("int8", APM), embed_dim=EMB)
    assert r.recovery == w2.recovery == {
        "n_replayed": 2, "torn_tail": False, "n_quarantined": 0,
        "live_after": 7}
    np.testing.assert_array_equal(r.live_slots, live)
    assert _rows(r) == _rows(w2) == expect
    mr = read_format3(os.path.join(root, CapacityTier.MANIFEST))
    mw = read_format3(os.path.join(twin, CapacityTier.MANIFEST))
    assert mr[0] == mw[0]
    _states_equal(mr[1], mw[1])
    r.close(), w2.close()
    # the reader's store promotes the writer's rows bit-identically
    s = RS(APM, EMB, capacity=16, codec="int8", capacity_dir=root)
    keep = np.isin(np.arange(9), [1, 7], invert=True)
    sat = s.promote_for(embs[keep], threshold=0.5)
    assert sat.all() and s.stats.n_promoted == 7
    _, idx = s.lookup(embs[keep], 1)
    got = [np.asarray(p).tobytes() for p in s.db.parts_at(idx[:, 0])]
    want = [np.asarray(p).tobytes()
            for p in s.codec.encode(apms[keep])]
    assert got == want
    s.capacity.close()


def test_capacity_spec_crosses_packages(tmp_path):
    """Every ``CapacitySpec`` field of the reference is the port's: a
    spec dict crosses in both directions unchanged, and the flat names
    are the same."""
    from repro.memo import MemoSpec as JaxSpec
    from repro.memo.specs import FLAT_FIELDS as JAX_FLAT
    from repro_torch.memo.specs import FLAT_FIELDS
    kw = dict(capacity_dir=str(tmp_path), capacity_budget_mb=8.0,
              capacity_promote=False, capacity_promote_max=3,
              capacity_checkpoint_every=2, capacity_stall_s=0.5,
              capacity_fsync=False, capacity_compact_ratio=0.25)
    ref = JaxSpec.flat(**kw)
    port = MemoSpec.flat(**kw)
    assert port.to_dict()["capacity"] == ref.to_dict()["capacity"]
    assert MemoSpec.from_dict(ref.to_dict()).capacity == port.capacity
    assert JaxSpec.from_dict(port.to_dict()).capacity == ref.capacity
    assert {k: v for k, v in JAX_FLAT.items() if k.startswith("capacity")} \
        == {k: v for k, v in FLAT_FIELDS.items() if k.startswith("capacity")}


def test_promotion_under_async_worker(tmp_path):
    """Promotion runs on ``MemoServer``'s worker: a replayed batch whose
    entries were demoted to disk misses, the worker promotes their disk
    rows (bit-identical on the device after its delta sync, each row's
    CRC intact) while the snapshot a batch held stays unchanged, and the
    next replay hits them."""
    _promotion_under_worker(tmp_path)


def test_promotion_under_async_worker_lowrank_clustered(tmp_path):
    """The same over a lowrank store (four parts on disk and device) and
    the clustered device index: promoted rows reach the index through
    its overflow buffer, and the held snapshot's search tuple stays
    unchanged."""
    sess = _promotion_under_worker(tmp_path, apm_codec="lowrank",
                                   device_index="clustered")
    di = sess.store.device_index
    assert type(di).__name__ == "ClusteredDeviceIndex"
    assert len(di._overflow) > di._overflow_base or di.n_rebuilds > 1


def _promotion_under_worker(tmp_path, **spec_kw):
    import torch
    cfg = get_reduced("bert_base").replace(n_classes=4, n_layers=2,
                                           d_model=128, d_ff=256, n_heads=4)
    m = build_model(cfg, device="cpu")
    corpus = TemplateCorpus(vocab=cfg.vocab, seq_len=SEQ, n_templates=6,
                            slot_fraction=0.2)
    calib = [{"tokens": corpus.sample(16)[0]} for _ in range(3)]
    spec = MemoSpec.flat(embed_steps=40, mode="bucket", device_slack=8.0,
                         admit=True, capacity_dir=str(tmp_path / "t"),
                         capacity_checkpoint_every=1, **spec_kw)
    sess = MemoSession.build(m, m.init(0), spec, batches=calib, seed=1,
                             device="cpu")
    store = sess.store
    assert store.capacity.live_count == store.live_count == 96
    store.budget_bytes = 32 * store.entry_nbytes
    assert len(store.demote_to_budget()) == 64
    assert store.capacity.live_count == 96 and store.stats.n_demoted == 64
    store.sync()
    # only a near-exact match hits: a demoted entry's replay misses on
    # the host tier and finds its own disk row
    sess.spec.runtime.threshold = store.sim_cal[1] - 1e-3
    held = store.snapshot
    frozen = list(held.db_parts) + [held.lengths] + list(held.search_args)
    before = [t.clone() for t in frozen]
    toks = calib[0]["tokens"][:8]
    with sess.serve(buckets=(SEQ,), max_batch=8) as srv:
        for r in range(8):
            srv.submit(toks[r])
        srv.step(flush=True)
        srv.drain_maintenance(timeout=30)
        assert srv._worker is not None and srv._worker.is_alive()
        hits0 = srv.stats.n_hits
        assert store.stats.n_promoted > 0
        for t, b in zip(frozen, before):
            assert torch.equal(t, b)              # copy-on-write
        assert store.snapshot.generation > held.generation
        slots = np.asarray(sorted(store._host_to_disk))
        dslots = np.asarray([store._host_to_disk[int(h)] for h in slots])
        parts, _, _, csums = store.capacity.rows_at(dslots)
        for dev, disk, csum in zip(store.snapshot.db_parts, parts, csums):
            assert dev[torch.from_numpy(slots)].numpy().tobytes() == \
                disk.tobytes()
            np.testing.assert_array_equal(
                AttentionDB._crc_rows(disk), csum)
        for r in range(8):
            srv.submit(toks[r])
        srv.step(flush=True)
        srv.drain_maintenance(timeout=30)
        assert srv.stats.n_hits > hits0
    assert store.verify_integrity() == []
    return sess
