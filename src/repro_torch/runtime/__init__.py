"""Fault-tolerance runtime: heartbeats and restart plans (``fault``),
straggler detection (``straggler``), elastic re-sharding (``elastic``)."""
