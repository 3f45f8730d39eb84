"""Hot/cold store (reference beacon_node/store): the port's copy of
lighthouse_tpu/store's kv, metadata and hot_cold modules; native_kv and
fsck wait (ROADMAP Queue 1 item 14.7)."""
