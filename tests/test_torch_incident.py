"""The post-mortem incident builder (``elephas_tpu_torch/obs/incident.py``)
against the JAX package's (``elephas_tpu/obs/incident.py``): the same
journals give the same incident document (timeline, trigger, digest,
per-process boots, flight de-duplication) and the same markdown.
"""

import pytest

from elephas_tpu import obs as jax_obs
from elephas_tpu.obs import incident as jax_incident
from elephas_tpu_torch import obs as torch_obs
from elephas_tpu_torch.obs import incident as torch_incident


def _both(build):
    """``build(obs)`` with each package's builder; the two documents."""
    return build(jax_obs), build(torch_obs)


def _kill_and_restart(root):
    """A PS killed and warm-restarted on one slot, a worker beside it,
    and one flight recorder teeing into both stores."""
    flight = jax_obs.FlightRecorder(capacity=16)
    first = jax_obs.TelemetryStore(str(root / "ps0" / "telemetry"), role="ps", boot="boot-1")
    worker = jax_obs.TelemetryStore(str(root / "w0" / "telemetry"), role="worker",
                                    boot="boot-w")
    flight.attach_store(first)
    flight.attach_store(worker)
    first.record("metric", {"values": {"ps_push_total": 3.0}, "tick": 1})
    flight.note("wal_restore", "info", wal_dir=str(root / "ps0"))
    flight.note("worker_requeue", "warn", unit=3)
    flight.note("ps_kill", "error", boot="boot-1")
    first.close(reason="kill")
    second = jax_obs.TelemetryStore(str(root / "ps0" / "telemetry"), role="ps", boot="boot-2")
    flight.attach_store(second)
    second.record("alert", {"rule": "push_stall", "transition": "resolve"}, severity="info")
    flight.note("resumed", "info", boot="boot-2")
    for store in (second, worker):
        store.close()


def test_the_same_journals_give_the_same_incident(tmp_path):
    _kill_and_restart(tmp_path)

    def build(obs):
        builder = obs.IncidentBuilder()
        assert builder.discover(str(tmp_path)) == ["ps0", "w0"]
        return builder.build()

    jax_doc, torch_doc = _both(build)
    assert torch_doc == jax_doc
    assert torch_doc["triggering_event"]["kind"] == "ps_kill"
    assert torch_doc["boots_by_proc"]["ps0"] == ["boot-1", "boot-2"]
    names = [e["name"] for e in torch_doc["timeline"] if e["proc"] == "ps0"]
    assert "boot (warm restart)" in names and "ps_kill" in names


def test_the_same_incident_renders_the_same_markdown(tmp_path):
    _kill_and_restart(tmp_path)
    doc = jax_obs.IncidentBuilder()
    doc.discover(str(tmp_path))
    incident = doc.build()
    assert torch_incident.render_markdown(incident) == jax_incident.render_markdown(incident)
    assert "ps_kill" in torch_incident.render_markdown(incident)


@pytest.mark.parametrize("order", [0, 1])
def test_the_digest_is_order_canonical_in_both(tmp_path, order):
    events = [("ps_kill", "error"), ("wal_restore", "info")]
    store = torch_obs.TelemetryStore(str(tmp_path / "ps"), role="ps", boot=f"b{order}")
    for kind, sev in events[::1 if order == 0 else -1]:
        store.record("flight", {"kind": kind, "detail": {}}, severity=sev)
    store.close()

    def build(obs):
        builder = obs.IncidentBuilder()
        builder.add_store(str(tmp_path / "ps"), name="ps")
        return builder.build()

    jax_doc, torch_doc = _both(build)
    assert torch_doc == jax_doc
    assert torch_doc["triggering_event"]["kind"] == "ps_kill"
    # The digest hashes the sorted identities, never the schedule.
    other = torch_obs.TelemetryStore(str(tmp_path / "other"), role="ps", boot="bx")
    for kind, sev in events:
        other.record("flight", {"kind": kind, "detail": {}}, severity=sev)
    other.close()
    builder = torch_obs.IncidentBuilder()
    builder.add_store(str(tmp_path / "other"), name="ps")
    assert builder.build()["digest"] == torch_doc["digest"]


def test_an_empty_root_builds_the_same_empty_incident(tmp_path):
    def build(obs):
        builder = obs.IncidentBuilder()
        assert builder.discover(str(tmp_path)) == []
        return builder.build()

    jax_doc, torch_doc = _both(build)
    assert torch_doc == jax_doc
    assert torch_incident.render_markdown(torch_doc) == jax_incident.render_markdown(jax_doc)
