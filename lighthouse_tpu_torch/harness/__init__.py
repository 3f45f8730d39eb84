"""In-process test harnesses (reference beacon_chain/src/test_utils.rs +
testing/: BeaconChainHarness, EphemeralHarnessType, manual clocks) and
the deterministic adversarial scenario harness (scenario.py) with its
plan fuzzer (fuzz.py): the port's copy of lighthouse_tpu/harness. A
scenario runs on the `fake` backend, as in the JAX package; its `device`
keyword places every node chain (None: the card)."""

from .beacon_chain_harness import BeaconChainHarness  # noqa: F401
from .chain import StateHarness  # noqa: F401
from .scenario import (  # noqa: F401
    PLANS,
    InvariantViolation,
    Phase,
    ScenarioPlan,
    SLO,
    assert_bit_identical_replay,
    run_scenario,
)
