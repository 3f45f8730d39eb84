"""In-process test harnesses (reference beacon_chain/src/test_utils.rs +
testing/: BeaconChainHarness, EphemeralHarnessType, manual clocks): the
port's copy of lighthouse_tpu/harness in part. The adversarial scenario
harness (scenario.py) waits (ROADMAP Queue 1 item 14.8)."""

from .beacon_chain_harness import BeaconChainHarness  # noqa: F401
from .chain import StateHarness  # noqa: F401
