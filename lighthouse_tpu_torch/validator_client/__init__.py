"""Validator client (reference validator_client/, SURVEY.md section 2.4):
the port's copy of lighthouse_tpu/validator_client in part. The
in-process beacon node that block production runs through is here; the
duty services, the signing store with slashing protection, the
beacon-node fallback, doppelganger protection, the keymanager and the
web3signer wait (ROADMAP Queue 1 item 14.8, step 5)."""

from .beacon_node import InProcessBeaconNode  # noqa: F401
