"""Deterministic resilience layer (reference layers 0/5/6 in SURVEY §1:
`validator_client/src/beacon_node_fallback.rs`, `beacon_node/eth1`'s
multi-endpoint cache, engine-API retries in `execution_layer/`).

Primitives (`primitives.py`) are clocked by an *injected* clock and
randomized by an *injected* rng -- never wall time, never the global
random module -- so the same seed replays the same schedule of retries,
backoff delays, breaker transitions, and health scores (the determinism
contract asserted by tests/test_resilience.py).

Fault injection (`faults.py`) wraps any provider/backend/engine duck
type in a seeded `FaultPlan` that injects errors, delays, and hangs on
a deterministic schedule, usable from tests and network/simulator.py.

Crash injection (`crash.py`) is the process-death counterpart for the
store layer: a seeded `CrashPlan`/`CrashingStore` kills the
process-under-test at the Nth kv op — including torn writes — so the
crash-safety suite can crash at EVERY op index of an atomic batch and
assert reopen-time journal recovery.

The port's copy of lighthouse_tpu/resilience/__init__.py.
"""

from .primitives import (  # noqa: F401
    AllEndpointsFailed,
    BreakerOpen,
    CircuitBreaker,
    EventLog,
    HealthTracker,
    RetryExhausted,
    RetryPolicy,
    Timeout,
    TimeoutExceeded,
    VirtualClock,
)
from .faults import (  # noqa: F401
    FaultInjected,
    FaultPlan,
    FaultyProxy,
    InjectedHang,
)
from .crash import (  # noqa: F401
    CrashPlan,
    CrashingStore,
    InjectedCrash,
)
