"""Attestation subnet service: which of the 64 attestation subnets a
node listens on, and when (reference beacon_node/network/src/
subnet_service/attestation_subnets.rs).

Two subscription classes, as in the reference:

- **long-lived**: every node camps on `subnets_per_node` subnets chosen
  deterministically from its node id and the current subscription
  period (EPOCHS_PER_SUBNET_SUBSCRIPTION epochs long), and advertises
  them in its ENR attnets bits -- that is what makes subnet topics
  discoverable (`subnet_predicate.rs` peers-for-subnet dials filter on
  these bits);
- **short-lived duty subscriptions**: an attester duty at (slot,
  committee) subscribes its subnet one slot ahead and drops it when the
  slot passes (the reference subscribes `ADVANCE_SUBSCRIBE_TIME` early
  and unsubscribes at slot end).

The service is clock-driven by `on_slot` and talks to the outside
through callbacks (bus subscribe/unsubscribe + ENR update), so it runs
unchanged over the in-process bus, the TCP wire stack, and in tests.


The port's copy of lighthouse_tpu/network/subnet_service.py.
"""

from __future__ import annotations

import hashlib


def compute_subnet_for_attestation(
    committees_per_slot: int, slot: int, committee_index: int, preset, spec
) -> int:
    """The spec's compute_subnet_for_attestation (validator guide):
    committees are striped across subnets within an epoch."""
    slots_since_epoch_start = slot % preset.slots_per_epoch
    committees_since_epoch_start = committees_per_slot * slots_since_epoch_start
    return (
        committees_since_epoch_start + committee_index
    ) % spec.attestation_subnet_count


def compute_subscribed_subnets(
    node_id: bytes, epoch: int, spec, subnets_per_node: int = 2,
    epochs_per_subscription: int = 256,
) -> list:
    """Deterministic long-lived subnets for (node_id, period) -- the
    discv5-advertised camping spots. Stable within a period, rotating
    across periods, spread by hashing (the reference's
    compute_subscribed_subnets shape over its node-id prefix)."""
    period = epoch // epochs_per_subscription
    out = []
    i = 0
    while len(out) < min(subnets_per_node, spec.attestation_subnet_count):
        digest = hashlib.sha256(
            node_id + period.to_bytes(8, "little") + i.to_bytes(8, "little")
        ).digest()
        subnet = int.from_bytes(digest[:8], "little") % (
            spec.attestation_subnet_count
        )
        if subnet not in out:
            out.append(subnet)
        i += 1
    return out


class AttestationSubnetService:
    def __init__(
        self,
        node_id: bytes,
        preset,
        spec,
        subscribe_cb,
        unsubscribe_cb,
        enr_update_cb=None,
        subnets_per_node: int = 2,
        epochs_per_subscription: int = 256,
    ):
        self.node_id = bytes(node_id)
        self.preset = preset
        self.spec = spec
        self._subscribe = subscribe_cb
        self._unsubscribe = unsubscribe_cb
        self._enr_update = enr_update_cb
        self.subnets_per_node = subnets_per_node
        self.epochs_per_subscription = epochs_per_subscription
        self._long_lived: set[int] = set()
        self._duty: dict[int, int] = {}  # subnet -> last duty slot
        self._active: set[int] = set()
        self.stats = {"subscribes": 0, "unsubscribes": 0, "enr_updates": 0}

    # -- queries ---------------------------------------------------------------

    @property
    def long_lived(self) -> set:
        return set(self._long_lived)

    def set_enr_update_cb(self, cb) -> None:
        """Late-wire the ENR advertisement seam (a discovery service
        attached after construction) and advertise the current set."""
        self._enr_update = cb
        if cb is not None and self._long_lived:
            cb(sorted(self._long_lived))
            self.stats["enr_updates"] += 1

    def active_subnets(self) -> set:
        return set(self._active)

    def is_subscribed(self, subnet: int) -> bool:
        return subnet in self._active

    # -- drivers ---------------------------------------------------------------

    def on_slot(self, slot: int) -> None:
        """Rotate long-lived subnets on period boundaries; expire duty
        subscriptions whose slot has passed."""
        epoch = slot // self.preset.slots_per_epoch
        wanted = set(
            compute_subscribed_subnets(
                self.node_id,
                epoch,
                self.spec,
                self.subnets_per_node,
                self.epochs_per_subscription,
            )
        )
        if wanted != self._long_lived:
            self._long_lived = wanted
            if self._enr_update is not None:
                self._enr_update(sorted(wanted))
                self.stats["enr_updates"] += 1
        for subnet, duty_slot in list(self._duty.items()):
            if duty_slot < slot:
                del self._duty[subnet]
        self._reconcile()

    def subscribe_for_duty(
        self, duty_slot: int, committees_per_slot: int, committee_index: int
    ) -> int:
        """An attester/aggregator duty at (slot, committee): hold the
        subnet until the duty slot passes. Returns the subnet id."""
        subnet = compute_subnet_for_attestation(
            committees_per_slot,
            duty_slot,
            committee_index,
            self.preset,
            self.spec,
        )
        self._duty[subnet] = max(self._duty.get(subnet, 0), duty_slot)
        self._reconcile()
        return subnet

    def _reconcile(self) -> None:
        wanted = self._long_lived | set(self._duty)
        for subnet in sorted(wanted - self._active):
            self._subscribe(subnet)
            self.stats["subscribes"] += 1
        for subnet in sorted(self._active - wanted):
            self._unsubscribe(subnet)
            self.stats["unsubscribes"] += 1
        self._active = wanted
