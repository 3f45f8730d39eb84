"""The repo's lint over the port (`python -m tools.lint lighthouse_tpu_torch`).

The file rules report nothing over `lighthouse_tpu_torch`. The project pass
(lock order, env-flag drift, ...) reports nothing there but four
`env-flag-drift` lines of `tools/lint/flags.json`: the switches that only
XLA (`JAX_PLATFORMS`, `LIGHTHOUSE_TPU_COMPILE_CACHE`) or the mesh
(`LIGHTHOUSE_TPU_SHARD_MIN_SETS`, `LIGHTHOUSE_TPU_SHARD_TABLE`, ROADMAP
Queue 1 item 12) read, which the port has no reader of. No baseline is
applied: every finding counts."""

import re
from pathlib import Path

from tools.lint.__main__ import main
from tools.lint.engine import lint_paths, parse_contexts
from tools.lint.project import FLAGS_REGISTRY, lint_project

ROOT = Path(__file__).resolve().parents[1]
TARGETS = ["lighthouse_tpu_torch"]

# the registry entries no port module reads
NOT_THE_PORTS = {
    "JAX_PLATFORMS", "LIGHTHOUSE_TPU_COMPILE_CACHE",
    "LIGHTHOUSE_TPU_SHARD_MIN_SETS", "LIGHTHOUSE_TPU_SHARD_TABLE",
}


def test_file_rules_find_nothing_over_the_port(capsys):
    rc = main(["--root", str(ROOT), "--no-baseline", *TARGETS])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "lint clean" in out


def test_project_pass_finds_only_the_xla_and_mesh_switches():
    ctxs, errors = parse_contexts(ROOT, TARGETS)
    assert not errors
    per_file, _ = lint_paths(ROOT, TARGETS, ctxs=ctxs)
    assert [str(v) for v in per_file] == []
    project, errors = lint_project(ROOT, TARGETS, ctxs=ctxs)
    assert not errors
    stale = set()
    for v in project:
        m = re.match(r"stale flag registry entry (\w+):", v.message)
        assert v.rule == "env-flag-drift" and v.path == FLAGS_REGISTRY and m, str(v)
        stale.add(m.group(1))
    assert len(project) == len(NOT_THE_PORTS)
    assert stale == NOT_THE_PORTS
