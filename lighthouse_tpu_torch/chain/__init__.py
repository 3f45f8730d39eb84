"""Core chain runtime (reference beacon_node/beacon_chain, SURVEY.md
section 2.3): the port's copy of lighthouse_tpu/chain so far -- BeaconChain
with its block import pipelines, the validator pubkey cache and gossip
attestation verification; sync-committee verification, light client and
the validator monitor wait (ROADMAP Queue 1 item 14.3)."""

from .beacon_chain import BeaconChain, BlockError  # noqa: F401
