"""The name diff between the JAX package's modules and the port's: every
public function, class or constant defined at the top level of
lighthouse_tpu/crypto/bls/tpu/{limbs,tower,curve,pairing,hash_to_curve}.py
and backends/jax_tpu.py has a same-named counterpart in the port's
gpu/ modules and backends/torch_cuda.py, and so has every one of the
consensus modules the port copies (ssz/, types/, utils/, state_transition/ but
per_epoch_mesh,
store/, fork_choice/, chain/, pool/, processor/, speculate/, resilience/,
harness/ and ef_tests.py; eth1/, execution_layer/, network/, slasher/,
crypto/aes.py, crypto/keystore.py, utils/jsonrpc.py, utils/{executor,
monitoring}.py, serving/, http_api/ and validator_client/); every
name a package `__init__.py` of those exports is exported by the port's,
or stands on the list below with the ROADMAP item that brings it, and
ROADMAP.md names it. The JAX files are parsed, not imported: nothing
compiles."""

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


# lighthouse_tpu/<file> -> lighthouse_tpu_torch.<module>: the copies
CONSUMERS = {
    f: "lighthouse_tpu_torch." + f[:-3].replace("/", ".")
    for f in (
        "utils/shuffle.py", "ssz/hash.py", "ssz/types.py", "ssz/cached.py",
        "types/presets.py", "types/chain_spec.py", "types/containers.py",
        "types/helpers.py", "types/committee_cache.py", "types/sync_committee.py",
        "types/interop.py", "state_transition/context.py",
        "state_transition/per_slot.py", "state_transition/signature_sets.py",
        "state_transition/block_signature_verifier.py", "chain/pubkey_cache.py",
        "chain/attestation_verification.py", "pool/observed.py",
        "processor/beacon_processor.py", "utils/math.py", "utils/slot_clock.py",
        "utils/timeout_lock.py", "utils/logging.py",
        "state_transition/participation.py", "state_transition/per_epoch.py",
        "state_transition/per_epoch_vec.py", "state_transition/upgrades.py",
        "state_transition/per_block.py", "state_transition/replay.py",
        "store/kv.py", "store/metadata.py", "store/hot_cold.py",
        "fork_choice/proto_array.py", "fork_choice/fork_choice.py",
        "chain/state_cache.py", "chain/early_attester_cache.py",
        "chain/beacon_chain.py", "chain/block_verification.py",
        "chain/sync_committee_verification.py", "chain/validator_monitor.py",
        "processor/reprocess.py", "pool/max_cover.py", "pool/naive_aggregation.py",
        "pool/operation_pool.py", "speculate/precompute.py", "speculate/scheduler.py",
        "speculate/__init__.py", "ssz/merkle_proof.py", "chain/light_client.py",
        "eth1/deposit_tree.py", "state_transition/genesis.py", "network/snappy.py",
        "ef_tests.py", "harness/chain.py", "harness/beacon_chain_harness.py",
        "store/fsck.py", "store/native_kv.py", "resilience/faults.py",
        "resilience/crash.py", "resilience/primitives.py", "utils/jsonrpc.py",
        "eth1/service.py", "eth1/jsonrpc.py", "execution_layer/keccak.py",
        "execution_layer/rlp.py", "execution_layer/block_hash.py",
        "execution_layer/engine_api.py", "execution_layer/auth.py",
        "execution_layer/execution_layer.py", "execution_layer/mock_engine.py",
        "execution_layer/http_engine.py", "execution_layer/builder.py",
        "validator_client/beacon_node.py", "network/message_bus.py",
        "network/peer_score.py", "network/subnet_service.py", "network/sync.py",
        "network/node.py", "network/simulator.py", "network/secure.py",
        "network/discovery.py", "network/wire.py", "network/wire_fabric.py",
        "slasher/slasher.py", "slasher/service.py", "crypto/aes.py",
        "validator_client/slashing_protection.py",
        "validator_client/validator_store.py", "validator_client/byzantine.py",
        "utils/executor.py", "utils/monitoring.py", "serving/admission.py",
        "serving/cache.py", "serving/sse.py", "serving/tier.py", "http_api/api.py",
        "http_api/server.py", "http_api/client.py", "crypto/keystore.py",
        "validator_client/signing_method.py", "validator_client/keymanager.py",
        "validator_client/services.py", "harness/scenario.py", "harness/fuzz.py",
    )
}

# names a JAX package __init__ exports that the port's does not yet, and
# the ROADMAP item that brings each
WAITING = {}
INITS = ("ssz/__init__.py", "types/__init__.py", "state_transition/__init__.py",
         "chain/__init__.py", "pool/__init__.py", "processor/__init__.py",
         "fork_choice/__init__.py", "store/__init__.py",
         "execution_layer/__init__.py", "speculate/__init__.py", "eth1/__init__.py",
         "network/__init__.py", "harness/__init__.py", "resilience/__init__.py",
         "validator_client/__init__.py", "slasher/__init__.py",
         "http_api/__init__.py", "serving/__init__.py")


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


@pytest.mark.parametrize("jax_file", sorted(CONSUMERS))
def test_every_public_name_of_a_copied_module_has_a_port_counterpart(jax_file):
    jnames = _public_names(ROOT / "lighthouse_tpu" / jax_file)
    port = importlib.import_module(CONSUMERS[jax_file])
    assert not sorted(n for n in jnames if not hasattr(port, n)), jax_file
    assert jnames


def _exported(path: Path) -> set:
    """The names a package __init__ imports from its modules."""
    return {a.asname or a.name for node in ast.parse(path.read_text()).body
            if isinstance(node, ast.ImportFrom) for a in node.names}


@pytest.mark.parametrize("init", INITS)
def test_port_package_exports_what_is_ported(init):
    """Each port __init__ exports the JAX one's names but those waiting
    for their ROADMAP item, and every waiting name is really missing."""
    want, got = _exported(ROOT / "lighthouse_tpu" / init), _exported(
        ROOT / "lighthouse_tpu_torch" / init)
    waiting = WAITING.get(init, {})
    assert got == want - set(waiting)
    assert set(waiting) <= want
    port = importlib.import_module("lighthouse_tpu_torch." + init[:-len("/__init__.py")])
    assert all(hasattr(port, n) for n in got)
    assert not [n for n in waiting if hasattr(port, n)]


def test_explained_names_stand_in_the_roadmap():
    roadmap = (ROOT / "ROADMAP.md").read_text()
    for names in list(EXPLAINED.values()) + list(WAITING.values()):
        for name in names:
            assert f"`{name}`" in roadmap, name
    assert "_monolith_graphs" in roadmap
