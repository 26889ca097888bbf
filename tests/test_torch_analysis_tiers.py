"""The port's wire auditor (``--wire``) against the JAX package's; the
model checker is ``tests/test_torch_analysis_model.py``, the deep entries
``tests/test_torch_analysis_deep.py``.

- The port's lifted wire schema equals the JAX package's checked-in
  ``wire_schema.lock.json`` entry for entry (read, never written), but for
  the listed differences — none: the port's one deliberate protocol
  difference, rankDAD's capture plan, rides in the site's round file and
  never on the wire.  Mutations of copies of the port's boundary modules
  under ``tmp_path`` fail as the JAX package's do.
"""
import json
import os
import shutil

import pytest

from coinstac_dinunet_tpu_torch.analysis import wire_schema as ws
from coinstac_dinunet_tpu_torch.analysis.__main__ import main
from coinstac_dinunet_tpu_torch.config.keys import WireContract

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "coinstac_dinunet_tpu_torch")
BASELINE = os.path.join(REPO, "dinulint_torch_baseline.json")
JAX_LOCK = os.path.join(REPO, "wire_schema.lock.json")
PORT_LOCK = os.path.join(REPO, "wire_schema_torch.lock.json")


# ------------------------------------------------------------------ --wire
#: (direction, key) -> why the port's entry differs from the JAX lockfile's.
#: Empty: rankDAD's capture plan, the port's one deliberate protocol
#: difference, is carried in the site's round file, local state that never
#: crosses the wire, so the schemas agree entry for entry.
WIRE_DIFFERENCES = {}


def _lock_entries(path):
    with open(path, encoding="utf-8") as f:
        return {(e["direction"], e["key"]): e for e in json.load(f)["entries"]}


def test_port_schema_equals_the_jax_lockfile_but_listed_differences():
    schema = ws.extract_schema(paths=[PORT])
    port = {e.ident(): e.to_dict() for e in schema.entries}
    jax_lock = _lock_entries(JAX_LOCK)
    differing = {k for k in set(port) | set(jax_lock)
                 if {f: v for f, v in port.get(k, {}).items() if f != "note"}
                 != {f: v for f, v in jax_lock.get(k, {}).items() if f != "note"}}
    assert differing == set(WIRE_DIFFERENCES)
    assert len(port) == len(jax_lock) == 61


def test_port_lockfile_matches_the_tree_and_the_tree_is_clean():
    schema = ws.extract_schema(paths=[PORT])
    assert ws.lock_findings(schema, ws.load_lock(PORT_LOCK), PORT_LOCK) == []
    assert ws.orphan_findings(schema) + ws.unversioned_findings(schema) + \
        ws.dense_findings(schema) == []
    assert _lock_entries(PORT_LOCK) == {
        k: v for k, v in _lock_entries(JAX_LOCK).items()
        if k not in WIRE_DIFFERENCES}


def _copy_port_boundary(tmp_path):
    """The port's wire boundary modules copied under ``tmp_path``."""
    root = tmp_path / "coinstac_dinunet_tpu_torch"
    for suffix, path in ws._find_package_files([PORT]).items():
        dst = root / suffix
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(path, dst)
    return root


@pytest.mark.parametrize("suffix,text,rules,stamp", [
    # a deleted producer key: consumed, never produced; the aggregator no
    # longer stamps its broadcasts
    ("nodes/remote.py", "self.out[RemoteWire.ROUND.value]",
     {WireContract.ORPHAN, WireContract.UNVERSIONED}, "wire_round"),
    # a dropped roster_epoch echo on the site: the site no longer stamps,
    # and the aggregator's read of the echo has no producer
    ("nodes/local.py", "self.out[LocalWire.ROSTER_EPOCH.value]",
     {WireContract.ORPHAN, WireContract.UNVERSIONED}, "roster_epoch"),
])
def test_mutated_copies_of_the_port_nodes_fail(tmp_path, suffix, text, rules, stamp):
    root = _copy_port_boundary(tmp_path)
    path = root / suffix
    src = path.read_text()
    assert text in src
    path.write_text(src.replace(text, "_shadow"))
    schema = ws.extract_schema(paths=[str(root)])
    found = ws.orphan_findings(schema) + ws.unversioned_findings(schema)
    assert {f.rule for f in found} == rules
    assert any(f"'{stamp}'" in f.message and f.path.endswith(suffix)
               for f in found if f.rule == WireContract.UNVERSIONED)
    drift = ws.lock_findings(schema, ws.load_lock(PORT_LOCK), PORT_LOCK)
    assert any(f.rule == WireContract.LOCK for f in drift)


def test_write_lock_writes_only_the_ports_lockfile(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert main([PORT, "--wire", "--write-lock", "--baseline", BASELINE]) == 0
    assert os.listdir(tmp_path) == ["wire_schema_torch.lock.json"]
    assert _lock_entries(tmp_path / "wire_schema_torch.lock.json") == _lock_entries(PORT_LOCK)
    # the JAX package's lockfile name is refused, and nothing is written
    assert main([PORT, "--wire", "--write-lock", "--wire-lock", "wire_schema.lock.json",
                 "--baseline", BASELINE]) == 1
    assert "refusing to write wire_schema.lock.json" in capsys.readouterr().out
    assert os.listdir(tmp_path) == ["wire_schema_torch.lock.json"]


def test_reconcile_accounts_modeled_and_reports_unmodeled_bytes(tmp_path):
    schema = ws.extract_schema(paths=[PORT])
    with open(tmp_path / "telemetry.site_0.jsonl", "w") as f:
        for rec in ({"kind": "wire", "payload_kind": "tensor", "file": "grads.npy",
                     "bytes": 100},
                    {"kind": "wire", "payload_kind": "mystery", "file": "x.bin",
                     "bytes": 7}):
            f.write(json.dumps(rec) + "\n")
    found = ws.reconcile_findings(schema, str(tmp_path))
    assert [(f.rule, "'mystery'" in f.message) for f in found] == [
        (WireContract.UNMODELED, True)]
