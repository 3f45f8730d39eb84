"""The name diff between the JAX package's device modules and the port's:
every public function, class or constant defined at the top level of
lighthouse_tpu/crypto/bls/tpu/{limbs,tower,curve,pairing,hash_to_curve}.py
and backends/jax_tpu.py has a same-named counterpart in the port's
gpu/ modules and backends/torch_cuda.py, or stands on the list below with
its reason, and ROADMAP.md names it. The JAX files are parsed, not
imported: nothing compiles."""

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

MODULES = {
    "tpu/limbs.py": "gpu.limbs",
    "tpu/tower.py": "gpu.tower",
    "tpu/curve.py": "gpu.curve",
    "tpu/pairing.py": "gpu.pairing",
    "tpu/hash_to_curve.py": "gpu.hash_to_curve",
    "backends/jax_tpu.py": "backends.torch_cuda",
}

# JAX names with no same-named counterpart in the port, and why
EXPLAINED = {
    "backends/jax_tpu.py": {
        "verify_jit": "alias: the port's `_monolith_graphs` (one CUDA graph "
                      "per shape of `verify_body`)",
        "verify_body_grouped": "mesh (ROADMAP Queue 1 item 12)",
        "verify_grouped_jit": "mesh (ROADMAP Queue 1 item 12)",
    },
}


def _public_names(path: Path) -> set:
    """Top-level defs, classes and assignment targets; imports and the
    rebinds under `if` blocks (the Pallas switch) are not definitions."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("jax_file", sorted(MODULES))
def test_every_public_jax_name_has_a_port_counterpart(jax_file):
    jnames = _public_names(ROOT / "lighthouse_tpu/crypto/bls" / jax_file)
    port = importlib.import_module(
        "lighthouse_tpu_torch.crypto.bls." + MODULES[jax_file])
    explained = EXPLAINED.get(jax_file, {})
    missing = sorted(n for n in jnames if not hasattr(port, n) and n not in explained)
    assert not missing, f"{jax_file}: no port counterpart for {missing}"
    # the list stays tight: an explained name really has no same-named one
    assert not [n for n in explained if hasattr(port, n)]
    assert set(explained) <= jnames
    assert len(jnames) >= 3


def test_explained_names_stand_in_the_roadmap():
    roadmap = (ROOT / "ROADMAP.md").read_text()
    for names in EXPLAINED.values():
        for name in names:
            assert f"`{name}`" in roadmap, name
    assert "_monolith_graphs" in roadmap
