"""Eth1 interface (reference beacon_node/eth1, SURVEY.md section 2.3): the
port's copy of lighthouse_tpu/eth1 in part. The deposit tree is here;
the JSON-RPC provider, the block cache and the service wait (ROADMAP
Queue 1 item 14.8)."""

from .deposit_tree import DEPOSIT_TREE_DEPTH, DepositDataTree  # noqa: F401
