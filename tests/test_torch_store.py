"""The durable telemetry store (``elephas_tpu_torch/obs/store.py``) against
the JAX package's (``elephas_tpu/obs/store.py``).

The same records, boot id and clocks give the same segment bytes in both
packages, each package reads the other's journal, and the failure modes
the store exists for behave the same: a torn tail is walked past by
readers and truncated on warm reopen, the disk budget prunes oldest
first with the ``obs_store_bytes`` gauge tracking the disk, and pruning
spares a dead predecessor's evidence.
"""

import struct
from pathlib import Path

import pytest

from elephas_tpu import obs as jax_obs
from elephas_tpu.obs import store as jax_store
from elephas_tpu_torch import obs as torch_obs
from elephas_tpu_torch.obs import store as torch_store

PACKAGES = {"jax": (jax_obs, jax_store), "torch": (torch_obs, torch_store)}


def _segments(directory):
    return sorted(Path(directory).glob("seg-*.etj"))


def _journal(obs, store_mod, directory, monkeypatch):
    """One fixed journal under injected clocks; returns its bytes."""
    state = {"wall": 1.7e9, "mono": 50.0}

    def wall():
        state["wall"] += 0.25
        return state["wall"]

    def mono():
        state["mono"] += 0.25
        return state["mono"]

    monkeypatch.setattr(store_mod.time, "time", wall)
    store = obs.TelemetryStore(str(directory), role="ps", boot="replay", clock=mono)
    store.record("flight", {"kind": "ps_kill", "detail": {"shard": 0}}, severity="error")
    store.record("alert", {"rule": "push_stall", "transition": "fire"}, severity="warn")
    store.record("metric", {"values": {"q": 1.0, "r": 0.5}, "tick": 0})
    store.record("span", {"name": "ps/push", "dur_ms": 1.5})
    store.close(reason="kill")
    monkeypatch.undo()
    return b"".join(p.read_bytes() for p in _segments(directory))


def test_segments_are_byte_identical_to_the_jax_store(tmp_path, monkeypatch):
    blobs = {name: _journal(obs, mod, tmp_path / name, monkeypatch)
             for name, (obs, mod) in PACKAGES.items()}
    assert blobs["jax"] == blobs["torch"] and len(blobs["torch"]) > 0
    assert [p.name for p in _segments(tmp_path / "jax")] == \
        [p.name for p in _segments(tmp_path / "torch")]
    # ETJ1 magic, big-endian u32 length, JSON body.
    assert blobs["torch"][:4] == b"ETJ1"
    (length,) = struct.unpack("!I", blobs["torch"][4:8])
    assert blobs["torch"][8 + length:12 + length] == b"ETJ1"


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_each_package_reads_the_others_store(tmp_path, monkeypatch, writer, reader):
    obs, mod = PACKAGES[writer]
    _journal(obs, mod, tmp_path / "j", monkeypatch)
    mine = PACKAGES[writer][0].read_store(str(tmp_path / "j"))
    theirs = PACKAGES[reader][0].read_store(str(tmp_path / "j"))
    assert theirs == mine
    assert [r["k"] for r in theirs["records"]] == \
        ["lifecycle", "flight", "alert", "metric", "span", "lifecycle"]
    assert PACKAGES[reader][0].iter_records(str(tmp_path / "j")) == \
        PACKAGES[writer][0].iter_records(str(tmp_path / "j"))
    assert PACKAGES[reader][0].store_dirs(str(tmp_path)) == [str(tmp_path / "j")]


@pytest.mark.parametrize("package", list(PACKAGES))
def test_record_vocabulary_and_boot_lifecycle(tmp_path, package):
    obs, _ = PACKAGES[package]
    assert obs.RECORD_KINDS == jax_obs.RECORD_KINDS
    store = obs.TelemetryStore(str(tmp_path), role="ps", boot="b0")
    with pytest.raises(ValueError):
        store.record("bogus", {})
    rec = store.record("flight", {"kind": "x"}, severity="warn")
    assert rec["role"] == "ps" and rec["boot"] == "b0"
    store.close()
    assert store.record("flight", {"kind": "late"}) is None  # dropped, not raised
    kinds = [(r["k"], r["data"].get("event") or r["data"].get("kind"))
             for r in obs.read_store(str(tmp_path))["records"]]
    assert kinds == [("lifecycle", "boot"), ("flight", "x"), ("lifecycle", "close")]


@pytest.mark.parametrize("package", list(PACKAGES))
def test_torn_tail_is_walked_past_and_truncated_on_warm_reopen(tmp_path, package):
    obs, _ = PACKAGES[package]
    store = obs.TelemetryStore(str(tmp_path), role="ps", boot="boot-a")
    for i in range(3):
        store.record("flight", {"kind": f"ev{i}"})
    store.sync()
    seg = _segments(tmp_path)[-1]
    good_size = seg.stat().st_size
    with open(seg, "ab") as f:  # a SIGKILL mid-append
        f.write(b"ETJ1" + struct.pack("!I", 4096) + b"torn")
    records, corrupt = obs.iter_records(str(tmp_path))
    assert [r["data"]["kind"] for r in records if r["k"] == "flight"] == ["ev0", "ev1", "ev2"]
    assert corrupt == [str(seg)]
    # Both packages see the same torn journal the same way.
    assert jax_obs.iter_records(str(tmp_path)) == torch_obs.iter_records(str(tmp_path))

    flight = obs.FlightRecorder(capacity=8)
    again = obs.TelemetryStore(str(tmp_path), role="ps", boot="boot-b", flight=flight)
    assert seg.stat().st_size == good_size
    assert again.stats()["healed_tails"] == 1
    heal = [e for e in flight.snapshot()["events"] if e["kind"] == "store_corrupt_tail"]
    assert len(heal) == 1 and heal[0]["detail"]["path"] == seg.name
    again.close()
    assert obs.iter_records(str(tmp_path))[1] == []
    # The same boot never truncates its own segments.
    own = obs.TelemetryStore(str(tmp_path / "own"), boot="boot-a")
    own.record("flight", {"kind": "mine"})
    own.sync()
    seg = _segments(tmp_path / "own")[-1]
    with open(seg, "ab") as f:
        f.write(b"garbage-tail")
    size = seg.stat().st_size
    assert obs.TelemetryStore(str(tmp_path / "own"), boot="boot-a").stats()["healed_tails"] == 0
    assert seg.stat().st_size == size


@pytest.mark.parametrize("package", list(PACKAGES))
def test_pruning_keeps_the_newest_segments_and_the_gauge_tracks_the_disk(tmp_path, package):
    obs, _ = PACKAGES[package]
    registry = obs.MetricsRegistry()
    store = obs.TelemetryStore(str(tmp_path / "a"), role="ps", boot="b0", keep=2,
                               segment_bytes=1024, registry=registry)
    for i in range(40):
        store.record("flight", {"kind": "spam", "detail": {"pad": "x" * 150, "i": i}})
    stats = store.stats()
    assert stats["rotations"] > 0 and stats["pruned_segments"] > 0
    segs = _segments(tmp_path / "a")
    assert len(segs) <= 2
    seqs = sorted(int(p.name.split("-")[1]) for p in segs)
    assert seqs[0] == stats["segments"] - len(segs)
    gauge = registry.gauge("obs_store_bytes", labelnames=("role",))
    assert gauge.labels(role="ps").value == float(store.disk_bytes())
    store.close()
    # A dead predecessor's evidence is not the new boot's to prune.
    old = obs.TelemetryStore(str(tmp_path / "b"), boot="boot-dead")
    old.record("flight", {"kind": "evidence"})
    old.sync()
    n_old = len(_segments(tmp_path / "b"))
    new = obs.TelemetryStore(str(tmp_path / "b"), boot="boot-live", keep=1,
                             segment_bytes=1024)
    for _ in range(40):
        new.record("flight", {"kind": "spam", "detail": {"pad": "x" * 150}})
    new.close()
    names = {p.name for p in _segments(tmp_path / "b")}
    assert sum("boot-dead" in n for n in names) == n_old
    assert sum("boot-live" in n for n in names) <= 1


def test_pruned_stores_match_the_jax_store_segment_for_segment(tmp_path, monkeypatch):
    """Rotation and pruning at the same budget leave the same files with
    the same bytes in both packages."""
    blobs = {}
    for name, (obs, mod) in PACKAGES.items():
        state = {"t": 100.0}

        def clock():
            state["t"] += 0.5
            return state["t"]

        monkeypatch.setattr(mod.time, "time", clock)
        store = obs.TelemetryStore(str(tmp_path / name), role="ps", boot="bb", keep=3,
                                   segment_bytes=1024, clock=clock)
        for i in range(30):
            store.record("flight", {"kind": "spam", "detail": {"pad": "y" * 120, "i": i}})
        store.close()
        monkeypatch.undo()
        blobs[name] = [(p.name, p.read_bytes()) for p in _segments(tmp_path / name)]
    assert blobs["jax"] == blobs["torch"] and len(blobs["torch"]) == 3
