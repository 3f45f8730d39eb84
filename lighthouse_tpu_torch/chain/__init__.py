"""Core chain runtime (reference beacon_node/beacon_chain, SURVEY.md
section 2.3): the port has the validator pubkey cache and gossip
attestation verification so far; BeaconChain and the rest of chain/ wait
(ROADMAP Queue 1 item 14.3)."""
