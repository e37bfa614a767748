"""The port's serving package keeps ONE device→host sync point
(``serving/host_sync.py``): the counterpart of the reference's
``scripts/lint_blocking.py``, as a source scan of the package."""

import shutil
from pathlib import Path

import pytest
import torch

from elephas_tpu_torch.serving import host_sync

PACKAGE = Path(host_sync.__file__).parent


def test_serving_package_has_no_blocking_read_outside_host_sync():
    assert host_sync.blocking_reads() == []
    scanned = sorted(p.name for p in PACKAGE.glob("*.py") if p.name != "host_sync.py")
    assert {"engine.py", "scheduler.py", "kv_pool.py"} <= set(scanned)


@pytest.mark.parametrize("call", host_sync.BLOCKING_READS)
def test_a_planted_blocking_read_is_found(tmp_path, call):
    for path in PACKAGE.glob("*.py"):
        shutil.copy(path, tmp_path / path.name)
    engine = tmp_path / "engine.py"
    source = engine.read_text()
    planted = f"x{call})" if call.startswith(".") else f"{call}()"
    engine.write_text(source + f"\n\ndef _planted(x):\n    return {planted}\n")
    found = host_sync.blocking_reads(tmp_path)
    assert len(found) == 1 and found[0].startswith("engine.py:") and call in found[0]


def test_comments_and_strings_do_not_count(tmp_path):
    (tmp_path / "doc.py").write_text(
        '"""Never call ``.item()`` or torch.cuda.synchronize here."""\n'
        "x = 1  # not .cpu() either\n"
        "y = '.numpy(' + \".tolist(\"\n")
    assert host_sync.blocking_reads(tmp_path) == []
    # host_sync.py itself is the sanctioned place.
    (tmp_path / "host_sync.py").write_text("def f(t):\n    return t.cpu().numpy()\n")
    assert host_sync.blocking_reads(tmp_path) == []


def test_staged_reads_on_the_cpu():
    t = torch.tensor([4, 5, 6])
    staged = host_sync.stage(t)
    t.fill_(0)  # the staged copy is the value at staging time
    assert host_sync.fetch_lanes(staged, [2, 0]) == [(2, 6), (0, 4)]
    assert host_sync.fetch_scalar(host_sync.stage(torch.tensor([9]))) == 9
    assert host_sync.fetch(staged).tolist() == [4, 5, 6]
    out = torch.zeros(3, dtype=torch.int64)
    assert host_sync.upload([1, 2, 3], torch.device("cpu"), out=out) is out
    assert out.tolist() == [1, 2, 3]
