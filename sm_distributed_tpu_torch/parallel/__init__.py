"""Process identity of the port (multi-GPU sharding: ROADMAP queue 1 item 7)."""
