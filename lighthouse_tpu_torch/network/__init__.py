"""Networking (reference beacon_node/lighthouse_network +
beacon_node/network, SURVEY.md section 2.3): the port's copy of
lighthouse_tpu/network in part. Only the snappy block format
(`snappy.py`, the ssz_snappy encoding the EF vectors use) is here; the
message bus, nodes, simulator, sync and wire stack wait (ROADMAP Queue 1
item 14.8), so this package exports nothing yet."""
