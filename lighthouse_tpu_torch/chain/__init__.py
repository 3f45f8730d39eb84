"""Core chain runtime (reference beacon_node/beacon_chain, SURVEY.md
section 2.3): the port's copy of lighthouse_tpu/chain -- BeaconChain with
its block import pipelines, the validator pubkey cache, gossip attestation
and sync-committee verification, the validator monitor and the light
client."""

from .beacon_chain import BeaconChain, BlockError  # noqa: F401
