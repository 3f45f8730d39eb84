"""Hot/cold store (reference beacon_node/store): the port's copy of
lighthouse_tpu/store -- kv, metadata, hot_cold, the native log-structured
backend (native_kv, built with g++ from the port's copy of kvstore.cc)
and the consistency checker (fsck)."""
